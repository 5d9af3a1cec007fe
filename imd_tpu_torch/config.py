"""Copy of imd_tpu/config.py (the parameter-file model), kept whole so
the port never imports the JAX package; keep the two in step.

Runtime configuration and IMD-compatible parameter-file parser.

The reference configures itself through two mechanisms: a compile-time
feature algebra (Makefile target grammar + config.h implication rules) and a
runtime tag-based parameter file (imd_param.c:251 getparamfile, ~230 tags,
multi-phase via `simulation N` sections).  Here both collapse into one
runtime `SimConfig`; features (EAM, TTM, TMM, FDTD, NRB, FILTER, ...) are
switched on by the presence of their parameters or explicit flags.

Parameter files written for the reference parse unmodified: same tag names,
same `simulation N` phase semantics (a phase-k read applies every tag from
the top of the file through the end of section k; imd_param.c:314-318).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# raw tag parsing
# ---------------------------------------------------------------------------

def _coerce(tok: str):
    """Parse one whitespace token into int, float, or str (in that order)."""
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def parse_param_text(text: str, phase: int = 1) -> Dict[str, Any]:
    """Parse IMD parameter-file text for the given simulation phase.

    Returns a flat dict tag -> value, where value is a scalar for
    single-token tags and a list for multi-token tags.  Tags seen later
    override earlier ones (reference semantics: the file is re-read for each
    phase and assignments simply overwrite).  Reading stops at the start of
    `simulation` section phase+1 (imd_param.c:314-318).
    """
    params: Dict[str, Any] = {}
    cur_phase = 1
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        tag, vals = toks[0], [_coerce(t) for t in toks[1:]]
        if tag.lower() == "simulation":
            cur_phase = int(vals[0]) if vals else cur_phase + 1
            if cur_phase > phase:
                break
            continue
        if tag in _ACCUM_TAGS:
            # indexed tags: repeated lines accumulate (ep_pos 0 x y z ...)
            params.setdefault(tag, []).append(vals)
        elif not vals:
            params[tag] = True
        elif len(vals) == 1:
            params[tag] = vals[0]
        else:
            params[tag] = vals
    return params


_ACCUM_TAGS = {"ep_pos", "ep_vel", "ep_dir",
               # per-vtype indexed deform vectors (imd_deform.c)
               "deform_shift", "deform_shear", "deform_base",
               # k-point rays: k0(3) kdir(3) kmax (imd_param.c:1917)
               "dsf_k",
               # per-vtype indexed lines '<vtype> x y z' repeated per
               # type (imd_param.c:1078/907-998)
               "restrictionvector", "extra_startforce", "extf",
               "extra_dforce", "extra_endforce", "extra_startbforce",
               "extra_bdforce", "extra_endbforce",
               # BEND moments '<moment> ...' + RIGID groups
               # (imd_param.c:1042-1075/818-844)
               "bend_axis", "bend_vtype_of_origin",
               "bend_vtype_of_force", "rigid"}

# ---------------------------------------------------------------------------
# reference tag registry (imd_param.c:251-4128, 488 unique getparam tags).
# Categories drive the end-of-parse coverage sweep in SimConfig.from_params:
#   parsed       - consumed into a typed SimConfig field (or a subsystem
#                  dataclass); silent
#   module       - parsed into typed fields consumed by a models/* module
#                  that is driven through the library API (not yet the CLI
#                  dispatch); silent
#   ignored      - compile-target / MPI-buffer / host-vis tuning knobs with
#                  no TPU meaning (msgbuf sizing, SPU counts, OpenMP
#                  threads, ...); accepted silently like the reference
#                  accepts tags for un-compiled features
#   unsupported  - names a feature this framework does not implement
#                  (ScaFaCoS bridge, nMoldyn export, ...); parsed into
#                  cfg.raw and WARNED about, never silently dropped
# ---------------------------------------------------------------------------

_IGNORED_TAGS = frozenset({
    # MPI / buffer / vectorization tuning (imd_mpi_util.c, imd_main_vec)
    "msgbuf_size", "inbuf_size", "outbuf_size", "incrsize", "initsize",
    "atoms_per_cpu", "size_per_cpu", "cellsize", "force_celldim_divisor",
    "hyper_threads", "num_spus", "parallel_input", "dist_chunk_size",
    "outputgrpsize", "neigh_len", "nsmear", "loop", "max_sscount",
    "sscount", "nfc", "watch_int", "stop_int", "binc",
    # interactive visualization client (jvis/VisIT socket window)
    "display_host", "server_port", "client_port", "socket_mode",
    "use_socket_window", "view_dir", "view_pos", "projection",
    # debug helpers
    "debug_potential", "debug_pot_res", "ew_test",
    # parsed by the reference but never consumed anywhere in its code
    "flagedatomstype",
    # CBE SPU potential-table upload sizing + MPI buffer count
    # (imd_cbe_util.c / imd_mpi_util.c) - no TPU meaning
    "cbe_pot_max", "cbe_pot_steps", "num_bufs",
})

_UNSUPPORTED_TAGS = frozenset({
    # ScaFaCoS long-range bridge (imd_forces_fcs.c) - external library
    "fcs_method", "fcs_near_field_flag", "fcs_rcut", "fcs_grid_dim",
    "fcs_max_iter", "fcs_iter_tolerance", "fcs_tolerance",
    "fcs_pepc_eps", "fcs_pepc_theta", "fcs_pepc_nthreads",
    "fcs_fmm_absrel", "fcs_fmm_dcorr", "fcs_fmm_do_tune",
    "fcs_p2nfft_intpol_order", "fcs_p2nfft_epsI", "fcs_pp3mg_ghosts",
    "fcs_pp3mg_max_part", "fcs_pp3mg_degree", "fcs_vmg_max_level",
    "fcs_vmg_smooth_steps", "fcs_vmg_gamma", "fcs_vmg_near_field_cells",
    "fcs_vmg_interpol_order", "fcs_vmg_discr_order",
})


def read_param_file(path: str, phase: int = 1) -> Dict[str, Any]:
    with open(path) as f:
        return parse_param_text(f.read(), phase)


def num_phases(text: str) -> int:
    n = 1
    for line in text.splitlines():
        toks = line.split("#", 1)[0].split()
        if toks and toks[0].lower() == "simulation":
            n = max(n, int(toks[1]) if len(toks) > 1 else n + 1)
    return n


_SUB_PREFIXES = ("laser_", "ttm", "fd_", "tmm", "nrb_", "filter_",
                 "fire_", "glok_", "cg_", "linmin_", "dist_",
                 "lb_", "colrad", "meam_", "dp_", "ms_", "uniax_",
                 "ep_", "lj_", "pic_", "socket_")

# tags consumed under a different name or by a subsystem dataclass
_KNOWN_ODD = {"lindef_int", "presstens_ext",
              "simulation", "lambda", "I0", "Sc", "bw", "srcx",
              "srcw", "ttmdimx", "ttmdimy", "ttmdimz",
              "init_t_el", "fix_t_el", "elecpress", "vlatdim",
              "vlatbuffer", "wide_range", "eos_dir", "atomic_z",
              "ttm_max_substeps",
              "restrictionvector", "extra_startforce", "extf",
              "strainrate", "expansionmode", "total_types",
              "Tleft", "Tright", "nslices_Left", "nslices_Right",
              "shock_speed_l", "shock_speed_r", "inv_tau_eta",
              "inv_tau_xi", "tempintv", "atomic_weight",
              "atomic_e-density_file", "use_header",
              "box_from_header", "ekin_threshold",
              "fnorm_threshold", "delta_epot_threshold",
              "f_max_threshold", "min_nPxF", "fire_int",
              "glok_int", "gamma_ftg", "pdecay_surfx",
              "ramp_fraction", "eng_int", "checkpt_int",
              "ttm_int", "flush_int", "parallel_output",
              "binary_output", "xi", "inv_tau_eta_rot",
              "ada_nbr_rcut", "expot_file", "pml", "hc_count",
              "kim_el_names"}


def tag_category(tag: str) -> str:
    """Classify a parameter-file tag (see the registry comment above):
    'parsed' (typed SimConfig/subsystem field), 'ignored' (no TPU
    meaning), 'unsupported' (warned), or 'unknown' (warned)."""
    field_names = {f.name for f in dataclasses.fields(SimConfig)}
    tl = tag.lower()
    if (tag in field_names or tl in field_names or tag in _KNOWN_ODD
            or tag in _ACCUM_TAGS):
        return "parsed"
    if tag.startswith(_SUB_PREFIXES) or tl.startswith(_SUB_PREFIXES):
        return "parsed"
    if tag in _IGNORED_TAGS or tl in _IGNORED_TAGS:
        return "ignored"
    if tag in _UNSUPPORTED_TAGS or tl in _UNSUPPORTED_TAGS:
        return "unsupported"
    return "unknown"


# ---------------------------------------------------------------------------
# configuration dataclasses
# ---------------------------------------------------------------------------

def _vec3(v, default=(0.0, 0.0, 0.0)) -> Tuple[float, float, float]:
    if v is None:
        return tuple(default)
    if isinstance(v, (int, float)):
        return (float(v), float(v), float(v))
    v = list(v) + list(default)[len(v):]
    return (float(v[0]), float(v[1]), float(v[2]))


@dataclasses.dataclass
class LaserConfig:
    """Legacy Lambert-Beer laser rescale (imd_laser.c) + pulse shape."""
    rescale_mode: int = 0            # laser_rescale_mode (4 = feed TTM source)
    sigma_e: float = 0.0             # areal fluence (energy/area, IMD units)
    sigma_t: float = 0.0             # pulse sigma (time units)
    t_0: float = 0.0                 # pulse peak time
    sigma_e1: float = 0.0            # second pulse
    sigma_t1: float = 0.0
    t_1: float = 0.0
    mu: float = 0.0                  # absorption coefficient 1/A
    delta_temp: float = 0.0          # laser_delta_temp for maxwell init
    offset: float = 0.0              # laser_offset: surface position
    dir: Tuple[float, float, float] = (1.0, 0.0, 0.0)   # must be axis-aligned
    atom_vol: float = 0.0            # per-atom volume (A^3)
    tem_mode: Tuple[int, int] = (0, 0)


@dataclasses.dataclass
class TTMConfig:
    """Two-temperature-model electron FD grid (imd_ttm.c)."""
    enabled: bool = False
    fd_nx: int = 1                   # ttmdimx: global FD cells along x
    fd_ny: int = 1
    fd_nz: int = 1
    fd_update_steps: int = 1         # MD steps per TTM update
    fd_min_atoms: int = 1            # cell activation threshold
    fd_ext: Tuple[int, int, int] = (1, 1, 1)  # MD cells per FD cell (fd_ext)
    init_t_el: float = 0.0           # initial electron temperature (eV); 0 -> T_i
    fix_t_el: bool = False
    rho_min: float = 0.05            # RHOMIN activation fraction (ttm.c)
    # constant-coefficient fallbacks (fd_k, fd_g, fd_c); wide-range models
    # take over when EOS/wide-range tables are configured.
    fd_k: float = 0.0                # electronic kappa (const model)
    fd_g: float = 0.0                # e-ph coupling (const model)
    fd_c: float = 0.0                # electronic C_e = fd_c * T_e (Sommerfeld)
    fd_gamma: float = 0.0            # alias for sommerfeld gamma
    wide_range: bool = False         # Povarnitsyn kappa/g + EOS C_e
    eos_dir: str = "."               # directory holding EOS_*.txt tables
    atomic_z: float = 13.0           # nuclear charge (Al default)
    atomic_mass: float = 26.9815     # amu
    max_substeps: int = 65536        # backstop on CFL diffusion substeps
    cfl_safety: float = 0.9          # dt <= cfl_safety * min(C dx^2 / 2k)
    # diffusion time integrator (imd_tpu extension; models/ttm.py):
    # "explicit" = the reference's CFL-substepped scheme (do_DIFF);
    # "implicit" = unconditionally stable backward-Euler tridiagonal
    # solves, ttm_substeps per MD step — at multi-eV Te the explicit
    # CFL demands O(1e3-1e5) substeps/step (production-ablation killer)
    solver: str = "explicit"
    n_sub: int = 10                  # ttm_substeps: implicit substeps/step
    vlatdim: int = 0                 # virtual-lattice continuum tail cells
    vlatbuffer: int = 0
    elecpress: bool = False          # electron blast-pressure force (ELECPRESS)


@dataclasses.dataclass
class TMMConfig:
    """1-D Helmholtz transfer-matrix laser solver (imd_tmm.c).

    For TMM (and FDTD) builds the reference reads the laser pulse tags in
    SI: lambda [m], I0 [W/m^2], laser_sigma_t / laser_t_0 [s]
    (imd_param.c:3956-3959, imd_tmm.c:137).
    """
    enabled: bool = False
    lambda_m: float = 800e-9         # vacuum wavelength (m); tag 'lambda'
    theta_deg: float = 0.0           # incidence angle (normal only, like ref)
    pol: int = 1                     # 1=S (reference hard-codes S branch)
    I0: float = 0.0                  # peak intensity W/m^2
    t0_s: float = 0.0                # pulse peak time (s)
    sigma_t_s: float = 0.0           # pulse sigma (s); I ~ exp(-(t-t0)^2/s^2)
    t1_s: float = 0.0                # second pulse
    sigma_t1_s: float = 0.0
    absorption_threshold: float = 20.0   # tmm_threshold: ecut at e^-thresh
    laser_threshold: float = 1e-5        # field-strength on/off fraction
    bb_table: str = ""               # bound-band epsilon table (alu_eps_bb.dat)


@dataclasses.dataclass
class FDTDConfig:
    """1-D/2-D Yee FDTD Maxwell solver (imd_fdtd.c)."""
    enabled: bool = False
    mode: int = 1                    # 1 = 1D, 2 = 2D
    Sc: float = 0.5                  # Courant number
    pml: int = 8                     # PML thickness (cells)
    srcx: int = 2                    # source position (cells)
    srcw: float = 0.0
    lambda_m: float = 800e-9         # tag 'lambda' (m)
    I0: float = 0.0                  # peak intensity W/m^2
    t0_s: float = 0.0
    sigma_t_s: float = 0.0
    # Drude-Lorentz defaults (static medium test); per-cell DL fits override
    drude_wp: float = 0.0
    drude_gamma: float = 0.0


@dataclasses.dataclass
class NRBConfig:
    """Non-reflecting rear boundary (imd_nrb.c)."""
    enabled: bool = False
    alat: float = 4.05               # nrb_alat: fcc lattice constant
    k: float = 0.0                   # nrb_k: impedance spring constant
    eps: float = 0.1                 # nrb_eps: layer detection tolerance
    overwrite: bool = False


@dataclasses.dataclass
class FilterConfig:
    """Ablation-plume atom deletion (imd_filter.c)."""
    enabled: bool = False
    interval: int = 0                # filter_int
    min_x: float = -math.inf
    max_x: float = math.inf
    min_y: float = -math.inf
    max_y: float = math.inf
    min_z: float = -math.inf
    max_z: float = math.inf


@dataclasses.dataclass
class RelaxConfig:
    """Quasistatic relaxation control (GLOK/FIRE/CG; imd_main_3d.c, imd_cg.c)."""
    ekin_threshold: float = 0.0
    fnorm_threshold: float = 0.0
    delta_epot_threshold: float = 0.0
    glok_ekin_threshold: float = 0.0
    fire_incfac: float = 1.1
    fire_decfac: float = 0.5
    fire_mix: float = 0.1
    fire_mixdec: float = 0.99
    fire_minsteps: int = 5
    fire_maxtimestep: float = 0.0    # max dt as multiple of base dt
    cg_mode: int = 0
    linmin_maxsteps: int = 100
    linmin_tol: float = 1e-4


@dataclasses.dataclass
class SimConfig:
    # --- identity / files ---------------------------------------------------
    coordname: str = ""              # input config (.chkpt) or _lattice spec
    outfiles: str = "out"            # output basename
    potfile: str = ""                # pair potential table
    # table-interpolation mode: '3point' (reference default), '4point'
    # (the FOURPOINT build), 'spline' (the SPLINE build).  The reference
    # selects this at compile time (potaccess.h:23-35); here it is a tag.
    pot_interp: str = "3point"
    itrname: str = ""
    # restart file basename (<outfiles>.<N>), set by the CLI -r flag;
    # subsystem restart files <base>.{ttm,ttmaux.npz,nrb} are read from
    # here (ttm_read/colrad_read/nrb_readrestart, imd_ttm.c:1983)
    restart_base: str = ""
    use_header: int = 0
    # EAM tables (imd_forces_eam2.c)
    core_potential_file: str = ""
    embedding_energy_file: str = ""
    el_density_file: str = ""
    # --- types / masses -----------------------------------------------------
    ntypes: int = 1
    total_types: int = 0             # vtypes incl. restriction-only types
    masses: Tuple[float, ...] = (1.0,)
    types: Tuple[int, ...] = ()      # vtype -> real type map
    restrictions: Tuple[Tuple[float, float, float], ...] = ()
    fbc_forces: Tuple[Tuple[float, float, float], ...] = ()
    # --- box / geometry -------------------------------------------------------
    box_x: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    box_y: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    box_z: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    box_from_header: int = 0
    pbc_dirs: Tuple[int, int, int] = (1, 1, 1)
    size_per_cpu: int = 0
    box_param: Tuple[int, int, int] = (0, 0, 0)   # lattice generator size
    box_unit: float = 1.0                          # lattice constant
    # vacuum margins around the sample (the fork's ablation-geometry
    # setup, "MY MOD" shift*_front/rear, imd_param.c:2133-2156): the box
    # is enlarged by front+rear per axis; on checkpoint read positions
    # shift by `front` (imd_io_3d.c:87,346); on lattice generation the
    # enlarged box is filled and atoms inside the x/y margins are
    # dropped (imd_generate.c:314-365,533-540)
    shiftx_front: float = 0.0
    shiftx_rear: float = 0.0
    shifty_front: float = 0.0
    shifty_rear: float = 0.0
    shiftz_front: float = 0.0
    shiftz_rear: float = 0.0
    # --- run control ----------------------------------------------------------
    ensemble: str = "nve"
    simulation_phase: int = 1
    maxwalltime: float = 0.0         # graceful-stop budget (s); 0 = off
    maxsteps: int = 0
    startstep: int = 0
    timestep: float = 0.0            # dt in IMD time units
    seed: int = 42
    # --- thermostats ----------------------------------------------------------
    starttemp: float = 0.0           # k_B T in eV
    endtemp: float = 0.0
    do_maxwell: bool = False
    tau_eta: float = 0.0             # Nose-Hoover
    isq_tau_eta: float = 0.0
    eta: float = 0.0
    tau_berendsen: float = 0.0
    tempintv: int = 0                # Andersen rethermalization interval
    inv_tau_eta: float = 0.0
    # NPT
    tau_xi: float = 0.0
    isq_tau_xi: float = 0.0
    xi: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pressure_start: float = 0.0
    pressure_end: float = 0.0
    # SLLOD shear flow (imd_integrate.c:1324)
    shear_rate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shear_rate2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Langevin / viscous
    viscous_friction: float = 0.0
    damptemp: float = 0.0
    # DAMP / FRAC / FTG / FINNIS / STM stadium-damping family
    # (imd_param.c:1228-1410)
    stadium: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    stadium2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gamma_damp: float = 0.0          # initial FRAC friction
    gamma_bar: float = 0.0           # feedback prefactor
    gamma_min: float = 0.0           # FTG local minimum friction
    dampingmode: int = 0             # 0 viscous feedback, 1 Nose-Hoover
    zeta_0: float = 0.0              # FINNIS / DAMP friction scale
    delta_finnis: float = 10.0
    delta_ftg: float = 10.0
    nslices: int = 1                 # FTG x-slabs
    nslices_left: int = 1
    nslices_right: int = 1
    tleft: float = 0.0
    tright: float = 0.0
    dotepsilon0: float = 0.0         # strainrate (homogeneous y expansion)
    expansionmode: int = 0
    # NVX heat-flux (imd_param.c:1954-1964)
    hc_nlayers: int = 0
    hc_heatcurr: float = 0.0
    # Green-Kubo heat-current window (imd_transport.c, hc_* tags)
    hc_int: int = 0
    hc_start: int = 0
    hc_av_start: int = 0
    # SHOCK loading (imd_param.c:1783-1800; imd_maxwell.c:221-235)
    shock_mode: int = 0
    shock_strip: float = 0.0
    shock_speed: float = 0.0
    shock_speed_left: float = 0.0
    shock_speed_right: float = 0.0
    # MEAM (imd_param.c meam_* tags; models/meam.py)
    meam_t_average: int = 0
    meam_t1: Tuple[float, ...] = ()
    meam_t2: Tuple[float, ...] = ()
    meam_t3: Tuple[float, ...] = ()
    meam_f0: Tuple[float, ...] = ()
    meam_r0: Tuple[float, ...] = ()
    meam_beta0: Tuple[float, ...] = ()
    meam_beta1: Tuple[float, ...] = ()
    meam_beta2: Tuple[float, ...] = ()
    meam_beta3: Tuple[float, ...] = ()
    meam_cmin: Tuple[float, ...] = ()
    meam_cmax: Tuple[float, ...] = ()
    meam_rcut: Tuple[float, ...] = ()
    meam_deltar: Tuple[float, ...] = ()
    meam_e: Tuple[float, ...] = ()
    meam_a: Tuple[float, ...] = ()
    meam_rho0: Tuple[float, ...] = ()
    # covalent / angular potentials (models/covalent.py; imd_param.c
    # stiweb/tersoff/ttbp/keating blocks)
    stiweb_a: Tuple[float, ...] = ()
    stiweb_b: Tuple[float, ...] = ()
    stiweb_p: Tuple[float, ...] = ()
    stiweb_q: Tuple[float, ...] = ()
    stiweb_a1: Tuple[float, ...] = ()
    stiweb_a2: Tuple[float, ...] = ()
    stiweb_de: Tuple[float, ...] = ()
    stiweb_ga: Tuple[float, ...] = ()
    stiweb_la: Tuple[float, ...] = ()
    ters_r_cut: Tuple[float, ...] = ()
    ters_r0: Tuple[float, ...] = ()
    ters_a: Tuple[float, ...] = ()
    ters_b: Tuple[float, ...] = ()
    ters_la: Tuple[float, ...] = ()
    ters_mu: Tuple[float, ...] = ()
    ters_chi: Tuple[float, ...] = ()
    ters_om: Tuple[float, ...] = ()
    ters_ga: Tuple[float, ...] = ()
    ters_n: Tuple[float, ...] = ()
    ters_c: Tuple[float, ...] = ()
    ters_d: Tuple[float, ...] = ()
    ters_h: Tuple[float, ...] = ()
    ters_c1: Tuple[float, ...] = ()
    ters_c2: Tuple[float, ...] = ()
    ters_c3: Tuple[float, ...] = ()
    ters_c4: Tuple[float, ...] = ()
    ters_c5: Tuple[float, ...] = ()
    ters_eta: Tuple[float, ...] = ()
    ters_delta: Tuple[float, ...] = ()
    ters_alpha: Tuple[float, ...] = ()
    ters_beta: Tuple[float, ...] = ()
    ttbp_constant: Tuple[float, ...] = ()
    ttbp_constant2: Tuple[float, ...] = ()
    ttbp_sp: Tuple[float, ...] = ()
    ttbp_cut: Tuple[float, ...] = ()
    ttbp_potfile: str = ""
    keating_alpha: Tuple[float, ...] = ()
    keating_beta: Tuple[float, ...] = ()
    keating_d: Tuple[float, ...] = ()
    keating_r_cut: Tuple[float, ...] = ()
    # analytic pair potentials (create_pot_table, imd_potential.c:476)
    morse_epsilon: Tuple[float, ...] = ()
    morse_sigma: Tuple[float, ...] = ()
    morse_alpha: Tuple[float, ...] = ()
    buck_a: Tuple[float, ...] = ()
    buck_c: Tuple[float, ...] = ()
    buck_sigma: Tuple[float, ...] = ()
    ljg_eps: Tuple[float, ...] = ()
    ljg_r0: Tuple[float, ...] = ()
    ljg_sig: Tuple[float, ...] = ()
    # Ewald / Coulomb (models/ewald.py; imd_param.c ew_* coul_*)
    ew_kappa: float = 0.0
    ew_kcut: float = 0.0
    ew_rcut: float = 0.0
    ew_nmax: int = 0
    coul_eng: float = 14.399644     # Coulomb energy prefactor (eV A)
    coul_res: float = 0.0
    coul_begin: float = 0.0
    # Streitz-Mintmire variable charge (models/external.py / imd_sm.c)
    sm_Z: Tuple[float, ...] = ()
    sm_J_0: Tuple[float, ...] = ()
    sm_chi_0: Tuple[float, ...] = ()
    sm_zeta: Tuple[float, ...] = ()
    sm_fixed_charges: int = 0
    charge_update_steps: int = 0
    # NEB (models/neb.py; imd_neb.c)
    neb_nrep: int = 0
    neb_k: float = 0.0
    neb_kmin: float = 0.0
    neb_kmax: float = 0.0
    neb_eng_int: int = 0
    neb_cineb_start: int = 0
    neb_climbing_image: int = -1
    neb_vark_start: int = 0
    neb_maxmove: float = 0.0
    # deform / lin_deform (models/deform.py; imd_deform.c)
    max_deform_int: int = 0
    deform_size: float = 1.0
    deform_shift: list = dataclasses.field(default_factory=list)
    deform_shear: list = dataclasses.field(default_factory=list)
    deform_base: list = dataclasses.field(default_factory=list)
    lindef_interval: int = 0
    lindef_size: float = 1.0
    lindef_x: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lindef_y: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lindef_z: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lindef_freq: float = 0.0   # CYCLE: cyclic-deformation frequency
    relax_rate: float = 0.0
    relax_mode: int = 0
    relax_dirs: Tuple[int, int, int] = (1, 1, 1)
    use_current_pressure: int = 0
    use_current_temp: int = 0
    bulk_module: float = 0.0
    shear_module: float = 0.0
    # external stress target for relax_pressure (xx yy zz yz zx xy,
    # imd_param.c:2449)
    presstens_ext: Tuple[float, float, float, float, float, float] = (
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    # analysis windows (imd_cna.c / imd_ada.c / io ATDIST/DIFFPAT /
    # imd_correl.c; analysis.py is the consumer)
    cna_int: int = 0
    cna_start: int = 0
    cna_end: int = 0
    cna_rcut: float = 0.0
    cna_crist: int = 0
    cna_stat: int = 0
    cna_write: Tuple[int, ...] = ()
    cna_ll: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cna_ur: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ada_nbr_r2cut: float = 0.0
    ada_write_int: int = 0
    ada_crystal_structure: str = "fcc"
    ada_latticeConst: float = 0.0
    nye_rotationAxis_x: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    nye_rotationAxis_y: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    nye_rotationAxis_z: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    atdist_int: int = 0
    atdist_start: int = 0
    atdist_end: int = 0
    atdist_pos_int: int = 0
    atdist_dim: Tuple[int, int, int] = (1, 1, 1)
    atdist_ll: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    atdist_ur: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    atdist_per_ll: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    atdist_per_ur: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    atdist_phi: float = 0.0
    diffpat_int: int = 0
    diffpat_start: int = 0
    diffpat_end: int = 0
    diffpat_dim: Tuple[int, int, int] = (1, 1, 1)
    diffpat_ll: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffpat_ur: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffpat_weight: Tuple[float, ...] = ()
    correl_int: int = 0
    correl_start: int = 0
    correl_end: int = 0
    correl_ts: int = 0
    correl_tmax: int = 0
    correl_rmax: float = 0.0
    correl_omode: int = 0
    msqd_ntypes: int = 0
    msqd_vtypes: int = 0
    avpos_int: int = 0
    avpos_start: int = 0
    avpos_end: int = 0
    avpos_res: int = 0
    avpos_nwrites: int = 0
    avpos_npwrites: int = 0
    avpos_steps: int = 0
    # ORDPAR order parameter: per-type-pair [ntypes*ntypes] cutoffs and
    # weights (imd_param.c:2737-2750); active when op_weight is set
    op_rcut: Tuple[float, ...] = ()
    op_weight: Tuple[float, ...] = ()
    dsp_int: int = 0
    min_dsp2: float = 0.0
    update_ort_ref: int = 0
    dem_int: int = 0
    reffile: str = ""
    # nMoldyn trajectory + dynamical structure factor (imd_io.c:3606/3749)
    nmoldyn_int: int = 0
    nmoldyn_veloc: int = 0
    dsf_int: int = 0
    dsf_weight: Tuple[float, ...] = ()
    dsf_nk: int = 0                  # capacity check only (dsf_nkmax)
    dsf_k: list = dataclasses.field(default_factory=list)
    # pictures (imd_pictures_3d.c)
    pic_ll: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pic_ur: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pic_res: Tuple[int, int] = (256, 256)
    pic_type: int = 0
    # extra EAM-family files (imd_param.c)
    adp_upotfile: str = ""
    adp_wpotfile: str = ""
    eeam_energy_file: str = ""
    # CG / linmin extras (imd_cg.c)
    cg_reset_int: int = 0
    cg_fr: int = 0
    cg_glimit: float = 100.0
    cg_zeps: float = 1e-10
    cg_infolevel: int = 0
    linmin_dmax: float = 0.0
    linmin_dmin: float = 0.0
    acg_alpha: float = 0.0
    acg_incfac: float = 1.1
    acg_decfac: float = 0.5
    # EPITAX deposition (imd_epitax.c; models/epitax.py)
    epitax_rate: Tuple[int, ...] = ()
    epitax_type: Tuple[int, ...] = ()
    epitax_mass: Tuple[float, ...] = ()
    epitax_temp: Tuple[float, ...] = ()
    epitax_cutoff: float = 0.0
    epitax_maxsteps: int = 0
    epitax_height: float = 0.0
    epitax_speed: float = 0.0
    epitax_startstep: int = 0
    epitax_ctrl: int = 0
    # analytic interaction family override (models/interactions.py):
    # '' = auto-detect from the tag group; 'tersoffmod' forces the MOD
    # form of the shared ters_* tags (the reference uses compile flags)
    interaction: str = ""
    # covalent neighbor-list engine (imd_tpu extension; ops/neighbors.py):
    # -1 auto (neighbor lists once the system outgrows the O(N^2)
    # oracle), 0 force the all-pairs oracle, >0 force lists with K
    # slots per atom (the reference sizes neigh_len the same way)
    covalent_nbl: int = -1
    # Frenkel-Ladd free-energy integration (imd_fefl.c; models/fefl.py)
    spring_rate: Tuple[float, ...] = ()      # per-type Einstein k
    fefl_lambda: float = 0.0                 # tag 'lambda' when FEFL active
    # bond-boost hyperdynamics (imd_bboost.c; models/bboost.py)
    bb_epscrit: float = 0.0
    bb_rcut: float = 0.0
    bb_tot_bV: float = 0.0
    bb_p1_2: float = 0.0
    bb_relaxsteps_max: int = 0
    bb_shdn_max: int = 0
    bb_under_max: int = 0
    # misc inherited controls
    nrb_infile: str = ""
    shock_incr: int = 0
    ecut_kin: Tuple[float, float] = (0.0, 0.0)
    ecut_pot: Tuple[float, float] = (0.0, 0.0)
    e_pot_lower: Tuple[float, ...] = ()
    e_pot_upper: Tuple[float, ...] = ()
    fbc_waitsteps: int = 0
    fbc_ekin_threshold: float = 0.0
    bfbc_waitsteps: int = 0
    max_fbc_int: int = 0
    max_bfbc_int: int = 0
    # FBC dynamic loading increments, per vtype (init_fbc/update_fbc,
    # imd_main_3d.c:1192-1291; tags extra_dforce/extra_endforce and the
    # BEND b-variants, imd_param.c:907-998)
    fbc_dforces: Tuple[Tuple[float, float, float], ...] = ()
    fbc_endforces: Tuple[Tuple[float, float, float], ...] = ()
    fbc_bforces: Tuple[Tuple[float, float, float], ...] = ()
    fbc_bdforces: Tuple[Tuple[float, float, float], ...] = ()
    fbc_endbforces: Tuple[Tuple[float, float, float], ...] = ()
    # ZAPP total-momentum zeroing (imd_main_3d.c:1401-1520)
    zapp_threshold: float = 0.0
    # BEND bending moments (imd_main_3d.c:1521-1780)
    bend_nmoments: int = 0
    bend_axes: Tuple[Tuple[float, float, float], ...] = ()
    bend_origin_vtype: Tuple[int, ...] = ()
    bend_force_vtype: Tuple[int, ...] = ()
    # RIGID superparticles: (member vtypes, restriction mask) per group
    # (imd_param.c:818-844, imd_integrate.c:866-920)
    rigid_groups: Tuple[Tuple[Tuple[int, ...],
                              Tuple[int, int, int]], ...] = ()
    ramp_y0min: float = 0.0
    ramp_y0max: float = 0.0
    ramp_y1min: float = 0.0
    ramp_y1max: float = 0.0
    dirichlet_surfx: float = 0.0
    # KERMODE Yukawa-screened electrostatics (imd_param.c:3488-3493)
    yuk_beta: float = 0.0
    yuk_smoothlength: float = 0.0
    smoothlength_ms: float = 0.0
    ms_harm_c: Tuple[float, ...] = ()
    ms_rmin: Tuple[float, ...] = ()
    dp_begin: float = 0.0
    dp_res: int = 0
    r_begin: Tuple[float, ...] = ()
    pot_res: Tuple[float, ...] = ()
    alat: float = 0.0
    GS_rcut: float = 0.0
    Epot_diff: int = 0
    calc_Epot_ref: int = 0
    reset_Epot_step: int = 0
    spring_const: Tuple[float, ...] = ()
    spring_rate: Tuple[float, ...] = ()
    lodnorm: float = 0.0
    min_dpot: float = 0.0
    eta_rot: float = 0.0
    tau_eta_rot: float = 0.0
    isq_tau_eta_rot: float = 0.0
    uniax_r_cut: float = 0.0
    uniax_sig: Tuple[float, ...] = ()
    cr_pot_file: str = ""
    na_pot_file: str = ""
    erfc_file: str = ""
    extpot_file: str = ""
    kim_model_name: str = ""           # OpenKIM model id (imd_forces_kim.c)
    kim_el_names: Tuple[str, ...] = ()  # per-type KIM element names
    fix_bks: int = 0
    nb_rcut: Tuple[float, ...] = ()    # [ntypes*ntypes] coordination cutoffs
    nb_checkpt_int: int = 0
    nb_cut_lower: Tuple[float, ...] = ()
    nb_cut_upper: Tuple[float, ...] = ()
    # runtime switches for reference compile-time output flags:
    # NORHOH (omit eam_rho chkpt column, imd_io.c:3219), HPO (%.16e
    # output formats, imd_io.c:2297), RELAXINFO (delta_epot/xnorm/xmax
    # .eng columns, imd_io.c:2454), GETMIN/GETSADDLE (write min*/saddle*
    # configs at PxF sign crossings, imd_main_3d.c:508-522)
    norhoh: int = 0
    hpo: int = 0
    # ASYMPOT (imd_forces_eam2.c:31): each half-bond of an asymmetric
    # pair table evaluates from its own type-ordered column
    asympot: int = 0
    # TERNBCC (imd_forces_covalent.c:461): ternary-BCC angular g(cos t)
    # replaces the SW (cos t + 1/3)^2 term
    ternbcc: int = 0
    # XT (imd_forces_covalent.c:265): same g(cos t) in the TTBP term
    xt: int = 0
    # FORCE (imd_io.c:1909): every force_int also write the potfit
    # reference-configuration `.force` file
    force_potfit: int = 0
    relaxinfo: int = 0
    getmin: int = 0
    getsaddle: int = 0
    ef_checkpt_int: int = 0
    ep_max_int: int = 0
    force_int: int = 0
    # STRESS_TENS per-atom pressure-tensor configs every press_int steps
    # (.stress files, write_config_press imd_io.c:1264-1276)
    press_int: int = 0
    force_all: int = 0
    nclones: int = 0
    atomic_charge: Tuple[float, ...] = ()
    pdecay_surfx_default: float = 0.0
    # DIPOLE / Tangney-Scandolo (imd_param.c:3451-3539; models/dipole.py)
    dp_fix: int = 0
    dp_mix: float = 0.6
    dp_tol: float = 1e-7
    dp_alpha: Tuple[float, ...] = ()
    dp_b: Tuple[float, ...] = ()
    dp_c: Tuple[float, ...] = ()
    ms_D: Tuple[float, ...] = ()
    ms_gamma: Tuple[float, ...] = ()
    ms_r0: Tuple[float, ...] = ()
    charge: Tuple[float, ...] = ()
    # UNIAX Gay-Berne (models/uniax.py)
    uniax_inert: float = 1.0
    uniax_sigma: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    uniax_eps: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # external indenters / walls (imd_param.c:3612-3680)
    ep_n: int = 0
    ep_nind: int = 0
    ep_key: int = 0
    ep_a: float = 0.0
    ep_rcut: float = 0.0
    ep_pos: list = dataclasses.field(default_factory=list)
    ep_vel: list = dataclasses.field(default_factory=list)
    ep_dir: list = dataclasses.field(default_factory=list)
    # pdecay momentum-damping ramp (integrate.c:232-249)
    pdecay_mode: int = 0
    ramp_start: float = 0.0
    ramp_end: float = 0.0
    ramp_fraction: float = 0.0
    xipdecay: float = 0.0
    pdecay_surfx: float = 0.0
    # --- parallel decomposition (imd_param.c:1817 cpu_dim; here the
    # device-mesh shape: cells sharded over a jax Mesh instead of MPI ranks)
    cpu_dim: Tuple[int, int, int] = (1, 1, 1)
    # load balancing (imd_param.c:2541-2565; TPU analog: x-slab
    # repartitioning of the sharded cell grid every lb_frequency steps)
    lb_frequency: int = 0
    lb_write_status: int = 0
    # socket steering (socket_io.c; imd_param.c:2766)
    socket_int: int = 0
    socket_port: int = 31050
    # COLRAD plasma kinetics: the reference enables this with -DCOLRAD at
    # compile time (no param tag, imd_colrad.c); here a runtime flag
    colrad: bool = False
    colrad_maxz: int = 3
    colrad_nlev: int = 4
    # MULTIPHOTON 2-/3-photon ionization channels (compile flag in the
    # reference, default-off there too, imd_colrad.c:30); needs a wave
    # solver's laser tags (lambda/I0/t_0/sigma_t) for the photon flux
    colrad_mpi: bool = False
    # rate-table source: "auto" uses the reference's Mott/Fermi-Dirac
    # integrals (colrad_GetCoeffs, imd_colrad.c:2279) whenever its state
    # tables (Al0_states.txt ...) are found in the workdir or its parent
    # (the reference's ../ table convention), else the van-Regemorter/
    # Lotz closed forms — with a loud notice either way, since the fit
    # rates deviate up to ~25x in the hot-plasma regime
    # (tests/test_colrad_rates.py).  "fit"/"ref" force a source.
    colrad_rates: str = "auto"
    colrad_states_dir: str = ""
    # --- neighbor / cells -------------------------------------------------------
    nbl_margin: float = 0.4          # Verlet skin (A); reference default 0.4
    nbl_size: float = 1.1            # capacity growth factor
    cell_size_tol: float = 1.05
    cell_capacity: int = 0           # 0 = auto from density
    # --- I/O intervals ----------------------------------------------------------
    checkpt_int: int = 0
    eng_int: int = 0
    dist_int: int = 0
    pic_int: int = 0
    ttm_int: int = 0
    filter_int: int = 0
    flush_int: int = 0
    parallel_output: int = 0
    binary_output: int = 0
    dist_dim: Tuple[int, int, int] = (1, 1, 1)
    dist_flags: Dict[str, int] = dataclasses.field(default_factory=dict)
    # --- subsystems ------------------------------------------------------------
    laser: LaserConfig = dataclasses.field(default_factory=LaserConfig)
    ttm: TTMConfig = dataclasses.field(default_factory=TTMConfig)
    tmm: TMMConfig = dataclasses.field(default_factory=TMMConfig)
    fdtd: FDTDConfig = dataclasses.field(default_factory=FDTDConfig)
    nrb: NRBConfig = dataclasses.field(default_factory=NRBConfig)
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    relax: RelaxConfig = dataclasses.field(default_factory=RelaxConfig)
    # analytic potentials (when no potfile)
    lj_epsilon: Tuple[float, ...] = ()
    lj_sigma: Tuple[float, ...] = ()
    r_cut: Tuple[float, ...] = ()
    # --- raw passthrough ---------------------------------------------------------
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # number of real types
    @property
    def vtypes(self) -> int:
        return self.total_types if self.total_types else self.ntypes

    @classmethod
    def from_params(cls, p: Dict[str, Any]) -> "SimConfig":
        c = cls()
        c.raw = dict(p)
        g = p.get

        def as_tuple(key, default=()):
            v = g(key)
            if v is None:
                return tuple(default)
            if isinstance(v, (int, float)):
                return (v,)
            return tuple(v)

        # identity / files
        c.coordname = str(g("coordname", c.coordname))
        c.outfiles = str(g("outfiles", c.outfiles))
        c.potfile = str(g("potfile", c.potfile))
        c.pot_interp = str(g("pot_interp", c.pot_interp))
        c.itrname = str(g("itrname", c.itrname))
        c.use_header = int(g("use_header", c.use_header))
        c.core_potential_file = str(g("core_potential_file", ""))
        c.embedding_energy_file = str(g("embedding_energy_file", ""))
        c.el_density_file = str(g("el_density_file", ""))
        # types
        c.ntypes = int(g("ntypes", c.ntypes))
        c.total_types = int(g("total_types", 0))
        c.masses = as_tuple("masses", (1.0,) * c.ntypes)
        c.types = tuple(int(t) for t in as_tuple("types", range(c.vtypes)))
        def per_vtype(key, default=(0.0, 0.0, 0.0)):
            """Reference format: repeated indexed lines '<vtype> x y z'
            (getparam DIM+1 + index assignment, imd_param.c:907-1092);
            one flat list of 3*vtypes values is accepted as a legacy
            convenience form."""
            v = g(key)
            if not v:
                return ()
            lines = (v if isinstance(v[0], (list, tuple))
                     else [list(v) if isinstance(v, list) else [v]])
            if len(lines) == 1 and len(lines[0]) != 4:
                flat = lines[0]
                return tuple(tuple(map(float, flat[i:i + 3]))
                             for i in range(0, len(flat), 3))
            out = {}
            for ln in lines:
                if len(ln) != 4:
                    raise ValueError(f"{key} expects '<vtype> x y z', "
                                     f"got {ln!r}")
                out[int(ln[0])] = tuple(map(float, ln[1:4]))
            return tuple(out.get(i, default)
                         for i in range(max(out) + 1))

        rv = per_vtype("restrictionvector", default=(1.0, 1.0, 1.0))
        if rv:
            c.restrictions = rv
        ef = per_vtype("extra_startforce") or per_vtype("extf")
        if ef:
            c.fbc_forces = ef
        c.fbc_dforces = per_vtype("extra_dforce")
        c.fbc_endforces = per_vtype("extra_endforce")
        c.fbc_bforces = per_vtype("extra_startbforce")
        c.fbc_bdforces = per_vtype("extra_bdforce")
        c.fbc_endbforces = per_vtype("extra_endbforce")
        # DEFORM group tables: indexed '<vtype> x y z' lines
        # (imd_param.c:787-840)
        c.deform_shift = list(per_vtype("deform_shift"))
        c.deform_shear = list(per_vtype("deform_shear"))
        c.deform_base = list(per_vtype("deform_base"))
        # BEND moments: indexed '<moment> ...' lines (imd_param.c:1042-75)
        c.bend_nmoments = int(g("bend_nmoments", 0))
        if c.bend_nmoments > 0:
            ax, ov, fv = {}, {}, {}
            for ln in g("bend_axis", []):
                a = [float(x) for x in ln[1:4]]
                n = math.sqrt(sum(x * x for x in a)) or 1.0
                ax[int(ln[0])] = tuple(x / n for x in a)
            for ln in g("bend_vtype_of_origin", []):
                ov[int(ln[0])] = int(ln[1])
            for ln in g("bend_vtype_of_force", []):
                fv[int(ln[0])] = int(ln[1])
            nm = c.bend_nmoments
            c.bend_axes = tuple(ax.get(j, (0.0, 0.0, 1.0))
                                for j in range(nm))
            c.bend_origin_vtype = tuple(ov.get(j, -1) for j in range(nm))
            c.bend_force_vtype = tuple(fv.get(j, -1) for j in range(nm))
            if -1 in c.bend_origin_vtype or -1 in c.bend_force_vtype:
                raise ValueError("bend_nmoments requires a "
                                 "bend_vtype_of_origin and "
                                 "bend_vtype_of_force line per moment")
        # RIGID groups: 'rigid v1 .. vk rx ry rz' (imd_param.c:818-844)
        groups = []
        for ln in g("rigid", []):
            v = [int(x) for x in ln]
            if len(v) < 4:
                raise ValueError("rigid expects at least one vtype plus "
                                 "a 3-component restriction mask")
            groups.append((tuple(v[:-3]), tuple(v[-3:])))
        c.rigid_groups = tuple(groups)
        seen = [v for vs, _ in c.rigid_groups for v in vs]
        if len(seen) != len(set(seen)):
            raise ValueError("Intersecting superparticles")
        # box
        c.box_x = _vec3(g("box_x"), c.box_x)
        c.box_y = _vec3(g("box_y"), c.box_y)
        c.box_z = _vec3(g("box_z"), c.box_z)
        c.box_from_header = int(g("box_from_header", 0))
        pbc = g("pbc_dirs")
        if pbc is not None:
            c.pbc_dirs = tuple(int(x) for x in (pbc if isinstance(pbc, list) else [pbc] * 3))
        bp = g("box_param")
        if bp is not None:
            c.box_param = tuple(int(x) for x in (bp if isinstance(bp, list) else [bp] * 3))
        c.box_unit = float(g("box_unit", 1.0))
        # run control
        c.ensemble = str(g("ensemble", c.ensemble)).lower()
        c.maxwalltime = float(g("maxwalltime", 0.0))
        c.maxsteps = int(g("maxsteps", c.maxsteps))
        c.startstep = int(g("startstep", c.startstep))
        c.timestep = float(g("timestep", c.timestep))
        c.seed = int(g("seed", c.seed))
        # thermostats
        c.starttemp = float(g("starttemp", c.starttemp))
        c.endtemp = float(g("endtemp", c.endtemp))
        c.do_maxwell = bool(g("do_maxwell", False))
        c.tau_eta = float(g("tau_eta", 0.0))
        if g("inv_tau_eta") is not None:
            c.inv_tau_eta = float(g("inv_tau_eta"))
            c.isq_tau_eta = c.inv_tau_eta ** 2
        elif c.tau_eta:
            c.isq_tau_eta = 1.0 / c.tau_eta ** 2
        if g("isq_tau_eta") is not None:
            c.isq_tau_eta = float(g("isq_tau_eta"))
        c.eta = float(g("eta", 0.0))
        c.tau_berendsen = float(g("tau_berendsen", 0.0))
        c.tempintv = int(g("tempintv", 0))
        c.tau_xi = float(g("tau_xi", 0.0))
        if c.tau_xi:
            c.isq_tau_xi = 1.0 / c.tau_xi ** 2
        if g("isq_tau_xi") is not None:
            c.isq_tau_xi = float(g("isq_tau_xi"))
        c.pressure_start = float(g("pressure_start", 0.0))
        c.pressure_end = float(g("pressure_end", c.pressure_start))
        c.shear_rate = _vec3(g("shear_rate"), c.shear_rate)
        c.shear_rate2 = _vec3(g("shear_rate2"), c.shear_rate2)
        c.viscous_friction = float(g("viscous_friction", 0.0))
        c.damptemp = float(g("damptemp", 0.0))
        c.stadium = _vec3(g("stadium"), c.stadium)
        c.stadium2 = _vec3(g("stadium2"), c.stadium2)
        c.center = _vec3(g("center"), c.center)
        c.gamma_damp = float(g("gamma_damp", 0.0))
        c.gamma_bar = float(g("gamma_bar", 0.0))
        c.gamma_min = float(g("gamma_min", 0.0))
        c.dampingmode = int(g("dampingmode", 0))
        c.zeta_0 = float(g("zeta_0", 0.0))
        c.delta_finnis = float(g("delta_finnis", c.delta_finnis))
        c.delta_ftg = float(g("delta_ftg", c.delta_ftg))
        c.nslices = int(g("nslices", c.nslices))
        c.nslices_left = int(g("nslices_Left", g("nslices_left",
                                                 c.nslices_left)))
        c.nslices_right = int(g("nslices_Right", g("nslices_right",
                                                   c.nslices_right)))
        c.tleft = float(g("Tleft", g("tleft", 0.0)))
        c.tright = float(g("Tright", g("tright", 0.0)))
        c.dotepsilon0 = float(g("strainrate", 0.0))
        c.expansionmode = int(g("expansionmode", 0))
        c.hc_nlayers = int(g("hc_nlayers", 0))
        c.hc_heatcurr = float(g("hc_heatcurr", 0.0))
        c.hc_int = int(g("hc_int", 0))
        c.hc_start = int(g("hc_start", 0))
        c.hc_av_start = int(g("hc_av_start", 0))
        c.shock_mode = int(g("shock_mode", 0))
        c.shock_strip = float(g("shock_strip", 0.0))
        c.shock_speed = float(g("shock_speed", 0.0))
        c.shock_speed_left = float(g("shock_speed_l",
                                     g("shock_speed_left", 0.0)))
        c.shock_speed_right = float(g("shock_speed_r",
                                      g("shock_speed_right", 0.0)))
        c.meam_t_average = int(g("meam_t_average", 0))
        for tag in ("meam_t1", "meam_t2", "meam_t3", "meam_f0", "meam_r0",
                    "meam_beta0", "meam_beta1", "meam_beta2", "meam_beta3",
                    "meam_cmin", "meam_cmax", "meam_rcut", "meam_deltar",
                    "meam_e", "meam_a", "meam_rho0",
                    "dp_alpha", "dp_b", "dp_c",
                    "ms_D", "ms_gamma", "ms_r0", "charge"):
            v = g(tag)
            if v is not None:
                v = v if isinstance(v, list) else [v]
                setattr(c, tag, tuple(float(x) for x in v))
        c.dp_fix = int(g("dp_fix", 0))
        c.dp_mix = float(g("dp_mix", c.dp_mix))
        c.dp_tol = float(g("dp_tol", c.dp_tol))
        c.uniax_inert = float(g("uniax_inert", 1.0))
        c.uniax_sigma = _vec3(g("uniax_sigma"), c.uniax_sigma)
        c.uniax_eps = _vec3(g("uniax_eps"), c.uniax_eps)
        c.ep_n = int(g("ep_n", 0))
        c.ep_nind = int(g("ep_nind", c.ep_n))
        c.ep_key = int(g("ep_key", 0))
        c.ep_a = float(g("ep_a", 0.0))
        c.ep_rcut = float(g("ep_rcut", 0.0))
        c.ep_pos = list(g("ep_pos", []))
        c.ep_vel = list(g("ep_vel", []))
        c.ep_dir = list(g("ep_dir", []))
        c.pdecay_mode = int(g("pdecay_mode", 0))
        c.ramp_start = float(g("ramp_start", 0.0))
        c.ramp_end = float(g("ramp_end", 0.0))
        c.ramp_fraction = float(g("ramp_fraction", 0.0))
        c.xipdecay = float(g("xipdecay", 0.0))
        c.pdecay_surfx = float(g("pdecay_surfx", 0.0))
        # parallel / LB / socket / colrad
        cd = g("cpu_dim")
        if cd is not None:
            c.cpu_dim = tuple(int(x) for x in
                              (cd if isinstance(cd, list) else [cd, 1, 1]))
        c.lb_frequency = int(g("lb_frequency", 0))
        c.lb_write_status = int(g("lb_writeStatus", g("lb_write_status", 0)))
        c.socket_int = int(g("socket_int", 0))
        c.socket_port = int(g("socket_port", c.socket_port))
        c.colrad = bool(g("colrad", False))
        c.colrad_maxz = int(g("colrad_maxz", c.colrad_maxz))
        c.colrad_nlev = int(g("colrad_nlev", c.colrad_nlev))
        c.colrad_mpi = bool(g("colrad_mpi", False))
        c.colrad_rates = str(g("colrad_rates", c.colrad_rates))
        c.colrad_states_dir = str(g("colrad_states_dir",
                                    c.colrad_states_dir))
        # neighbor / cells
        c.nbl_margin = float(g("nbl_margin", c.nbl_margin))
        c.nbl_size = float(g("nbl_size", c.nbl_size))
        c.cell_size_tol = float(g("cell_size_tol", c.cell_size_tol))
        c.cell_capacity = int(g("cell_capacity", 0))
        # intervals
        for k in ("checkpt_int", "eng_int", "dist_int", "pic_int", "ttm_int",
                  "filter_int", "flush_int", "parallel_output", "binary_output"):
            if g(k) is not None:
                setattr(c, k, int(g(k)))
        # HOMDEF pressure relaxation / homogeneous strain
        # (lin_deform + relax_pressure, imd_deform.c:33/127)
        if g("lindef_int") is not None:
            c.lindef_interval = int(g("lindef_int"))
        rm = g("relax_mode")
        if rm is not None:
            modes = {"full": 0, "axial": 1, "iso": 2}
            c.relax_mode = modes.get(str(rm).lower())
            if c.relax_mode is None:
                raise ValueError(f"Unknown relax_mode {rm}"
                                 " (full|axial|iso, imd_param.c:1562)")
        pe = g("presstens_ext")
        if pe is not None:
            vv = pe if isinstance(pe, list) else [pe]
            c.presstens_ext = tuple(float(x) for x in (
                list(vv) + [0.0] * 6)[:6])
        dd = g("dist_dim")
        if dd is not None:
            c.dist_dim = tuple(int(x) for x in (dd if isinstance(dd, list) else [dd] * 3))
        c.dist_flags = {k[len("dist_"):-len("_flag")]: int(v)
                        for k, v in p.items()
                        if k.startswith("dist_") and k.endswith("_flag")}
        # analytic potentials
        c.lj_epsilon = as_tuple("lj_epsilon")
        c.lj_sigma = as_tuple("lj_sigma")
        c.r_cut = as_tuple("r_cut")
        # --- laser ---
        L = c.laser
        L.rescale_mode = int(g("laser_rescale_mode", 0))
        L.sigma_e = float(g("laser_sigma_e", 0.0))
        L.sigma_t = float(g("laser_sigma_t", 0.0))
        L.t_0 = float(g("laser_t_0", 0.0))
        L.sigma_e1 = float(g("laser_sigma_e1", 0.0))
        L.sigma_t1 = float(g("laser_sigma_t1", 0.0))
        L.t_1 = float(g("laser_t_1", 0.0))
        L.mu = float(g("laser_mu", 0.0))
        L.delta_temp = float(g("laser_delta_temp", 0.0))
        L.offset = float(g("laser_offset", 0.0))
        L.dir = _vec3(g("laser_dir"), L.dir)
        L.atom_vol = float(g("laser_atom_vol", 0.0))
        # --- TTM ---
        T = c.ttm
        if g("ttmdimx") is not None or str(c.ensemble) == "ttm":
            T.enabled = True
        T.fd_nx = int(g("ttmdimx", T.fd_nx))
        T.fd_ny = int(g("ttmdimy", T.fd_ny))
        T.fd_nz = int(g("ttmdimz", T.fd_nz))
        T.fd_update_steps = int(g("fd_update_steps", T.fd_update_steps))
        T.fd_min_atoms = int(g("fd_min_atoms", T.fd_min_atoms))
        fe = g("fd_ext")
        if fe is not None:
            T.fd_ext = tuple(int(x) for x in (fe if isinstance(fe, list) else [fe] * 3))
        T.init_t_el = float(g("init_t_el", 0.0))
        T.fix_t_el = bool(g("fix_t_el", False))
        T.fd_k = float(g("fd_k", 0.0))
        T.fd_g = float(g("fd_g", 0.0))
        T.fd_c = float(g("fd_c", 0.0))
        T.fd_gamma = float(g("fd_gamma", T.fd_c))
        T.elecpress = bool(g("elecpress", False))
        T.vlatdim = int(g("vlatdim", 0))
        T.vlatbuffer = int(g("vlatbuffer", 0))
        T.wide_range = bool(g("wide_range", False))
        if g("ttm_max_substeps") is not None:
            T.max_substeps = int(g("ttm_max_substeps"))
        T.solver = str(g("ttm_solver", T.solver)).lower()
        if T.solver not in ("explicit", "implicit"):
            raise ValueError(f"ttm_solver {T.solver}: explicit|implicit")
        T.n_sub = int(g("ttm_substeps", T.n_sub))
        T.eos_dir = str(g("eos_dir", "."))
        if g("atomic_z") is not None:
            T.atomic_z = float(g("atomic_z"))
        elif g("atomic_charge") is not None:
            # the reference's TTM tag for the NUCLEAR charge z0 fed to
            # MeanCharge/getKappa (imd_param.c:2091; MeanCharge is
            # called with z0 = atomic_charge, imd_ttm.c:667)
            v = g("atomic_charge")
            try:
                T.atomic_z = float(v[0] if isinstance(v, (list, tuple))
                                   else v)
            except (TypeError, ValueError):
                pass
        if c.masses:
            T.atomic_mass = float(c.masses[0])
        # --- TMM ---
        M = c.tmm
        if g("tmm_threshold") is not None or bool(g("tmm", False)):
            M.enabled = True
        if g("lambda") is not None:
            M.lambda_m = float(g("lambda"))
        M.I0 = float(g("I0", M.I0))
        M.absorption_threshold = float(g("tmm_threshold",
                                         M.absorption_threshold))
        M.laser_threshold = float(g("tmm_laser_threshold", M.laser_threshold))
        M.pol = int(g("tmm_pol", M.pol))
        M.theta_deg = float(g("tmm_theta", M.theta_deg))
        M.bb_table = str(g("tmm_bb_table", M.bb_table))
        if M.enabled:
            # laser pulse tags are SI seconds in TMM/FDTD builds
            M.t0_s = float(g("laser_t_0", 0.0))
            M.sigma_t_s = float(g("laser_sigma_t", 0.0))
            M.t1_s = float(g("laser_t_1", 0.0))
            M.sigma_t1_s = float(g("laser_sigma_t1", 0.0))
        # --- FDTD ---
        F = c.fdtd
        if g("Sc") is not None or bool(g("fdtd", False)):
            F.enabled = True
        F.Sc = float(g("Sc", F.Sc))
        F.srcx = int(g("srcx", F.srcx))
        F.srcw = float(g("srcw", F.srcw))
        if g("lambda") is not None:
            F.lambda_m = float(g("lambda"))
        F.I0 = float(g("I0", F.I0))
        # both spellings exist in the reference: 'bw' (fdtd.c) and 'pml'
        F.pml = int(g("bw", g("pml", F.pml)))
        if F.enabled:
            F.t0_s = float(g("laser_t_0", 0.0))
            F.sigma_t_s = float(g("laser_sigma_t", 0.0))
        # --- NRB ---
        N = c.nrb
        if g("nrb_k") is not None:
            N.enabled = True
        N.alat = float(g("nrb_alat", N.alat))
        N.k = float(g("nrb_k", N.k))
        N.eps = float(g("nrb_eps", N.eps))
        N.overwrite = bool(g("nrb_overwrite", False))
        # --- FILTER ---
        Fl = c.filter
        if g("filter_int") is not None:
            Fl.enabled = True
            Fl.interval = int(g("filter_int"))
        for attr, tag in (("min_x", "filter_min_x"), ("max_x", "filter_max_x"),
                          ("min_y", "filter_min_y"), ("max_y", "filter_max_y"),
                          ("min_z", "filter_min_z"), ("max_z", "filter_max_z")):
            if g(tag) is not None:
                setattr(Fl, attr, float(g(tag)))
        # --- relax ---
        R = c.relax
        for attr, tag in (("ekin_threshold", "ekin_threshold"),
                          ("fnorm_threshold", "fnorm_threshold"),
                          ("delta_epot_threshold", "delta_epot_threshold"),
                          ("glok_ekin_threshold", "glok_ekin_threshold"),
                          ("fire_incfac", "fire_incfac"), ("fire_decfac", "fire_decfac"),
                          ("fire_mix", "fire_mix"), ("fire_mixdec", "fire_mixdec"),
                          ("fire_maxtimestep", "fire_maxtimestep"),
                          ("linmin_tol", "linmin_tol")):
            if g(tag) is not None:
                setattr(R, attr, float(g(tag)))
        for attr, tag in (("fire_minsteps", "fire_minsteps"), ("cg_mode", "cg_mode"),
                          ("linmin_maxsteps", "linmin_maxsteps")):
            if g(tag) is not None:
                setattr(R, attr, int(g(tag)))
        # the reference's GLOK relaxator reads glok_* names
        # (imd_param.c:1012-1080); map them onto the same FIRE knobs
        for attr, tags in (("fire_incfac", ("glok_incfac",)),
                           ("fire_decfac", ("glok_decfac",)),
                           ("fire_mix", ("glok_mix",)),
                           ("fire_mixdec", ("glok_mixdec",)),
                           ("fire_maxtimestep", ("glok_maxtimestep",)),
                           ("glok_ekin_threshold",
                            ("fire_ekin_threshold",)),
                           ("fnorm_threshold", ("glok_fmaxcrit",
                                                "fire_fmaxcrit",
                                                "f_max_threshold"))):
            for tag in tags:
                if g(tag) is not None:
                    setattr(R, attr, float(g(tag)))
        for attr, tags in (("fire_minsteps", ("glok_minsteps",)),):
            for tag in tags:
                if g(tag) is not None:
                    setattr(R, attr, int(g(tag)))
        if g("inv_tau_xi") is not None:
            c.isq_tau_xi = float(g("inv_tau_xi")) ** 2
        # EAM table-file aliases (imd_param.c reads both spellings)
        if not c.el_density_file and g("atomic_e-density_file") is not None:
            c.el_density_file = str(g("atomic_e-density_file"))
        # ADA neighbor cutoff: the reference tag is the RADIUS, stored
        # squared (imd_param.c:2493-2497)
        if g("ada_nbr_rcut") is not None:
            c.ada_nbr_r2cut = float(g("ada_nbr_rcut")) ** 2
        # EXTPOT file tag spelling (imd_param.c:3638 'expot_file')
        if not c.extpot_file and g("expot_file") is not None:
            c.extpot_file = str(g("expot_file"))
        # OpenKIM bridge identifiers (imd_param.c KIM block); consumed by
        # models/external.kim_forces when kimpy is installed
        c.kim_model_name = str(g("kim_model_name", ""))
        v = g("kim_el_names")
        if v is not None:
            c.kim_el_names = tuple(
                str(x) for x in (v if isinstance(v, list) else [v]))
        if g("atomic_weight") is not None and "masses" not in p:
            v = g("atomic_weight")
            c.masses = tuple(float(x) for x in
                             (v if isinstance(v, list) else [v]))

        # ---- generic sweep: same-named SimConfig fields, coerced by the
        # declared default's type (covers the module-backed tag groups:
        # covalent, analytic pots, ewald/sm, neb, deform, analysis
        # windows, pictures, cg extras, epitax, bboost, misc) ----------
        c.xi = _vec3(g("xi"), c.xi)
        # fields with custom parse semantics above (case mapping, scalar
        # broadcast, vtype defaults): the generic sweep must not clobber
        _already = {"raw", "ensemble", "types", "restrictions",
                    "fbc_forces", "pbc_dirs", "dist_dim", "cpu_dim",
                    "shear_rate", "shear_rate2", "stadium", "stadium2",
                    "center", "xi", "box_x", "box_y", "box_z",
                    "box_param", "masses", "laser", "ttm", "tmm", "fdtd",
                    "nrb", "filter", "relax", "dist_flags",
                    "lj_epsilon", "lj_sigma", "r_cut",
                    "relax_mode", "presstens_ext",
                    "deform_shift", "deform_shear", "deform_base",
                    "kim_el_names"}
        for f in dataclasses.fields(cls):
            name = f.name
            if name in _already or name not in p:
                continue
            cur = getattr(c, name)
            v = p[name]
            try:
                if isinstance(cur, bool):
                    setattr(c, name, bool(v))
                elif isinstance(cur, int):
                    setattr(c, name, int(v))
                elif isinstance(cur, float):
                    setattr(c, name, float(v))
                elif isinstance(cur, str):
                    setattr(c, name, str(v))
                elif isinstance(cur, tuple):
                    vv = v if isinstance(v, list) else [v]
                    if cur and isinstance(cur[0], int):
                        setattr(c, name, tuple(int(x) for x in vv))
                    else:
                        setattr(c, name, tuple(float(x) for x in vv))
                elif isinstance(cur, list):
                    setattr(c, name,
                            list(v) if isinstance(v, list) else [v])
            except (TypeError, ValueError):
                warnings.warn(f"parameter tag '{name}' = {v!r} could not "
                              f"be coerced; kept default")

        # FEFL reuses the `lambda` tag (imd_param.c:3071) that the laser
        # wavelength also claims (2081, lasMD fork) — the reference
        # disambiguates by compile flag, we by spring_rate presence (the
        # laser config keeps its own copy either way)
        if c.spring_rate and "fefl_lambda" not in p and "lambda" in p:
            c.fefl_lambda = float(g("lambda", c.fefl_lambda))

        # ---- coverage sweep: nothing a reference param file says may be
        # silently dropped (round-1 gap: ~87 tags vanished quietly) -----
        for tag in p:
            cat = tag_category(tag)
            if cat == "unsupported":
                warnings.warn(
                    f"parameter tag '{tag}' names a feature imd_tpu does "
                    f"not implement (kept in cfg.raw; run continues "
                    f"without it)")
            elif cat == "unknown":
                warnings.warn(f"unknown parameter tag '{tag}' "
                              f"(kept in cfg.raw)")
        return c

    @classmethod
    def from_file(cls, path: str, phase: int = 1) -> "SimConfig":
        cfg = cls.from_params(read_param_file(path, phase))
        cfg.simulation_phase = phase
        cfg.validate()
        return cfg

    def validate(self) -> "SimConfig":
        """Completeness/sanity checks after reading a parameter file
        (check_parameters_complete, imd_param.c:3746-4070).  Raises
        ValueError with the reference's messages for fatal gaps, warns
        and repairs where the reference does, fills the same defaults
        (endtemp, correl_ts, stadium2, avpos/atdist windows).  Called
        from ``from_file`` — the same point in the startup sequence as
        the reference's call (read_parameters, imd_param.c:4166).

        Deviation: a missing ``ensemble`` tag defaults to nve instead
        of the reference's hard error (programmatic configs rely on
        the default); unknown ensemble names still fail in
        Simulation._select_integrator."""
        err = []
        if not self.ensemble:
            err.append("missing or unknown ensemble parameter.")
        if self.timestep == 0.0:
            err.append("timestep is missing or zero.")
        if self.ntypes == 0:
            err.append("ntypes is missing or zero.")
        # BEND moment geometry (imd_param.c:3771-3802)
        if self.bend_nmoments > 0:
            if self.bend_nmoments > 6:
                err.append("currently only 6 bending moments are "
                           "supported")
            for k in range(min(self.bend_nmoments, len(self.bend_axes))):
                if sum(a * a for a in self.bend_axes[k]) == 0.0:
                    err.append("definition of bending moment without "
                               "axis")
            mags = [self.fbc_bforces, self.fbc_bdforces,
                    self.fbc_endbforces]
            for vt in self.bend_force_vtype:
                if not any(vt < len(t) and sum(x * x for x in t[vt]) > 0
                           for t in mags):
                    err.append("definition of bending moment without "
                               "force")
        # per-vtype machinery needs total_types (imd_param.c:3815-3829)
        uses_vtypes = (self.rigid_groups or self.bend_nmoments > 0
                       or self.fbc_forces or self.fbc_endforces
                       or self.deform_shift or self.deform_shear)
        if uses_vtypes and self.total_types == 0:
            err.append("FBC, RIGID, and DEFORM require parameter "
                       "total_types to be set")
        if self.total_types and self.total_types < self.ntypes:
            err.append("total_types must not be smaller than ntypes")
        # thermostatted ensembles need a temperature (TEMPCONTROL,
        # imd_param.c:3834)
        if (self.ensemble in ("nvt", "ber", "and", "lang")
                and self.starttemp == 0.0):
            err.append("starttemp is missing or zero.")
        if self.endtemp == 0.0:
            self.endtemp = self.starttemp       # end_temp default (3838)
        # correlation/MSQD cadence (imd_param.c:3842-3856)
        if self.correl_int > 0 or self.msqd_ntypes > 0 or self.msqd_vtypes:
            if self.correl_ts == 0:
                if self.eng_int > 0:
                    self.correl_ts = self.eng_int
                else:
                    err.append("correl_ts is missing or zero.")
        if self.correl_int > 0:
            if self.correl_rmax == 0:
                err.append("correl_rmax is missing or zero.")
            if self.correl_tmax == 0:
                err.append("correl_tmax is zero.")
        if self.ensemble == "nvx":
            if self.hc_int == 0:
                err.append("hc_int is zero.")
            if self.hc_nlayers == 0:
                err.append("hc_nlayers is zero.")
        if self.ensemble == "ftg":
            if self.nslices < 2:
                err.append("nslices is missing or less than 2.")
            if self.tleft == 0.0:
                err.append("Tleft is missing or zero.")
            if self.tright == 0.0:
                err.append("Tright is missing or zero.")
        # legacy laser rescale (imd_param.c:3875-3900)
        L = self.laser
        if L.rescale_mode:
            nz = [d != 0.0 for d in L.dir]
            if sum(nz) != 1:
                err.append("Laser incidence only along one coordinate "
                           "axis." if any(nz) else
                           "Parameter laser_dir (laser incidence "
                           "direction) missing.")
            if not 0 <= L.rescale_mode <= 4:
                err.append("Parameter laser_rescale_mode must be a "
                           "positive integer < 5 !")
            if L.tem_mode != (0, 0) and not (0 <= L.tem_mode[0] <= 1):
                err.append("Laser TEM Mode has to be either "
                           "Gauss-Laguerre (0) or Gauss-Hermite (1).")
        T = self.ttm
        if T.enabled:
            if T.fd_update_steps <= 0:
                warnings.warn("Ignoring illegal value of "
                              "fd_update_steps, using 1")
                T.fd_update_steps = 1
            if T.init_t_el < 0:
                warnings.warn("Ignoring illegal value of init_t_el, "
                              "using lattice temp")
                T.init_t_el = 0.0
            if T.fix_t_el and T.init_t_el == 0.0:
                err.append("You need to specify init_t_el for enabled "
                           "fix_t_el!")
            if T.fd_nx <= 0:
                err.append("You must specify ttmdimx")
        if self.tmm.enabled or self.fdtd.enabled:
            I0 = self.tmm.I0 if self.tmm.enabled else self.fdtd.I0
            lam = (self.tmm.lambda_m if self.tmm.enabled
                   else self.fdtd.lambda_m)
            if I0 == 0.0:
                err.append("You must specify peak intensity I0 in "
                           "W/m^2")
            if lam == 0.0:
                err.append("You must specify lambda in meters")
        # (UNIAX is a library-level model here, not param-file-driven,
        # so the reference's uniax_r_cut check has no trigger)
        # FRAC/FTG stadium default: half box (imd_param.c:4004-4009)
        if (self.ensemble in ("frac", "ftg")
                and self.stadium2[0] == 0.0 and self.stadium2[1] == 0.0):
            self.stadium2 = (self.box_x[0] / 2.0, self.box_y[1] / 2.0,
                             self.stadium2[2])
        if self.avpos_int > 0 and self.avpos_end == 0:
            self.avpos_end = self.maxsteps      # imd_param.c:4014
        if self.atdist_int > 0 and self.atdist_end == 0:
            self.atdist_end = self.maxsteps
        # ADA/Nye prerequisites (imd_param.c:4052-4070)
        if self.ada_write_int > 0:
            if self.ada_nbr_r2cut == 0.0 and self.ada_latticeConst == 0.0:
                err.append('Nearest neighbor cutoff distance '
                           '"ada_nbr_rcut" or lattice constant '
                           '"ada_latticeConst" is missing or zero in '
                           'the parameter file')
        if err:
            raise ValueError("parameter file incomplete: "
                             + " / ".join(err))
        return self

    def box(self):
        """Return the 3x3 box matrix (rows = box vectors)."""
        return (self.box_x, self.box_y, self.box_z)
