"""1-D Helmholtz transfer-matrix laser solver (TMM) (port of
imd_tpu/models/tmm.py; the reference's imd_tmm.c, do_tmm:193-454).

Per FD cell a wide-range permittivity eps(lambda, T_e, T_i, Z, n_e) (a
Drude metallic branch with the interband term and collision-frequency
saturation, a collisional-plasma branch with Maxwellian-averaged K1/K2
kernels, an exponential Te/TF blend); the transfer matrices of the layered
profile; per cell the absorbed power Q_abs = I(t) k0 Im(eps) <|E|^2> from
the exact layer integral of |B+ e^{ikdz} + B- e^{-ikdz}|^2.

Torch re-design:

- the prefix products W_i = M_i ... M_0 of the [nx-1] interface matrices
  come from a log-depth doubling (Hillis-Steele) scan: level s multiplies
  each W_i by W_{i-s}, 8 levels at nx = 256.  The 2x2 complex products are
  written out elementwise (no matmul, so no TF32 can reach them: the
  entries grow like e^{+kappa x/2} and their cancellation is the physical
  amplitude, which a reduced-precision product corrupted on the TPU).  The
  products associate in another order than imd_tpu's
  ``lax.associative_scan``, which changes the last bits;
- the absorption cutoff ``ecut`` (the first cell where the transmitted
  intensity or the optical depth passes the threshold) and the amplitudes
  at it stay on the device: ``argmax`` of the cast mask and
  ``index_select``, no host read;
- the interband term at the static wavelength is looked up once, when the
  parameters are made, in the tables' dtype.

Complex dtypes follow the grid: complex64 under float32, complex128 under
float64.  Conventions kept from the reference and imd_tpu: normal
incidence, s-polarization, cell 0 is the vacuum entry, inactive cells are
vacuum, I(t) = I0 [exp(-(t-t0)^2/sigma_t^2) + exp(-(t-t1)^2/sigma_t1^2)] in
SI seconds.  The entry: the reference puts a 1e10 A vacuum layer in front
(imd_tmm.c:323), imd_tpu gives the entry cell zero thickness, and the port
gives every vacuum cell in front of the first active cell zero thickness.
Such layers only turn the phase of the amplitudes (|e^{ik0 d}| = 1), which
leaves R, T, A and Q_abs unchanged; but in float32 their rounded unit
moduli compound over the vacuum: on run1m's grid (128 vacuum cells in
front of the film) the float32 R came 1.4e-5 off its float64 value with
them and ~1e-7 without (chip_smoke.py's TMM check).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from imd_tpu_torch import units
from imd_tpu_torch.models import widerange as wr
from imd_tpu_torch.ops.geometry import np_dtype

# vacuum impedance (imd_tmm.c:196)
VACUUM_IMPEDANCE = 376.9911184307751
# W/m^3 -> IMD power density eV/(A^3 * time-unit)  (imd_tmm.c:438)
WM3_TO_IMD = 6.3538562638e-26

# wide-range permittivity fit constants (imd_tmm.c:515-518)
A1P, A2P, A3P, A4P = 4.41, 0.8, 0.7, 0.2


def k12_tables(n: int = 1500) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The K1/K2 table on the reference's grid xi_i = (i+1)/30 (host,
    NumPy, once at set-up; the reference reads it from ../K12.dat).

    K1(xi) = 4/(3 sqrt(pi)) Int t^{9/2} e^-t / (t^3 + xi^2) dt and
    K2(xi) = Int t^3 e^-t / (t^3 + xi^2) dt by composite Simpson on
    t in [0, 60].  Returns (xi, K1, K2) float64 arrays."""
    xi = (np.arange(n, dtype=np.float64) + 1.0) / 30.0
    t = np.linspace(0.0, 60.0, 24001)
    h = t[1] - t[0]
    w = np.ones_like(t)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    w *= h / 3.0
    et = np.exp(-t)
    k1 = np.empty(n)
    k2 = np.empty(n)
    c1 = 4.0 / (3.0 * math.sqrt(math.pi))
    t3 = t ** 3
    f1 = t ** 4.5 * et
    f2 = t3 * et
    for lo in range(0, n, 100):
        hi = min(lo + 100, n)
        den = t3[None, :] + (xi[lo:hi, None]) ** 2
        k1[lo:hi] = c1 * np.sum(w * f1 / den, axis=1)
        k2[lo:hi] = np.sum(w * f2 / den, axis=1)
    return xi, k1, k2


def _k_interp(tab: torch.Tensor, nu, large_fn):
    """Reference K-table lookup (imd_tmm.c:662-695): linear interpolation
    on the (i+1)/30 grid, 1 below 1/30, the asymptotic expansion from 50
    on.  ``nu`` is capped at 60 before the integer cast (the values from 50
    on are the expansion's, so the cap changes no result)."""
    i = torch.clamp((torch.clamp(nu, max=60.0) * 30.0).to(torch.int64) - 1,
                    0, 1498)
    frac = 30.0 * nu - (i + 1).to(nu.dtype)
    mid = tab[i] + frac * (tab[i + 1] - tab[i])
    out = torch.where(nu < 1.0 / 30.0, torch.ones_like(mid), mid)
    return torch.where(nu >= 50.0, large_fn(nu), out)


def k1_of(tab, nu):
    return _k_interp(tab, nu, lambda x: 315.0 / 8.0 / x ** 2
                     - 675675.0 / 64.0 / x ** 4)


def k2_of(tab, nu):
    return _k_interp(tab, nu, lambda x: 6.0 / x ** 2 - 720.0 / x ** 4)


def default_bb_table(lam_lo_um: float = 0.2, lam_hi_um: float = 2.0,
                     n: int = 512) -> np.ndarray:
    """Synthetic Al interband table (lambda_um, Re eps_bb, Im eps_bb): a
    Lorentz oscillator with the reference's static Al Drude-Lorentz
    constants (imd_tmm.c:478-481), standing in for the absent
    ../alu_eps_bb.dat."""
    eps_inf = 2.73
    wp_l = 9.6929256835e15
    g_l = 9.84485242e14
    w0_l = 2.47640578e15
    lam = np.linspace(lam_lo_um, lam_hi_um, n)
    w = 2.0 * math.pi * units.C_SI / (lam * 1e-6)
    eps = (eps_inf - 1.0) + wp_l ** 2 / (w0_l ** 2 - w ** 2 - 1j * g_l * w)
    return np.stack([lam, eps.real, eps.imag], axis=1)


def interband_eps(lambda_m: float, bb_lam_um, bb_re, bb_im) -> complex:
    """The interband permittivity at the static wavelength: linear
    interpolation in the table (NumPy arrays of the run's dtype), in that
    dtype (imd_tpu/models/tmm.py:235-243)."""
    lam_um = bb_lam_um.dtype.type(lambda_m * 1e6)
    j = int(np.clip(np.searchsorted(bb_lam_um, lam_um) - 1, 0,
                    len(bb_lam_um) - 2))
    frac = (lam_um - bb_lam_um[j]) / (bb_lam_um[j + 1] - bb_lam_um[j])
    re = bb_re[j] + frac * (bb_re[j + 1] - bb_re[j])
    im = bb_im[j] + frac * (bb_im[j + 1] - bb_im[j])
    return complex(float(re), float(im))


@dataclasses.dataclass(eq=False)
class TMMParams:
    """Inputs of the solver that do not depend on the state: the pulse
    (SI), the thresholds, and the K1/K2 and interband tables as tensors on
    the run's device and dtype."""
    lambda_m: float
    i0: float                       # W/m^2
    t0_s: float
    sigma_t_s: float
    k1_tab: torch.Tensor
    k2_tab: torch.Tensor
    bb_lam_um: torch.Tensor
    bb_re: torch.Tensor
    bb_im: torch.Tensor
    t1_s: float = 0.0
    sigma_t1_s: float = 0.0
    absorption_threshold: float = 20.0
    laser_threshold: float = 1e-5
    eps_bb: complex = dataclasses.field(init=False)

    def __post_init__(self):
        def host(t):
            return t.detach().cpu().numpy()
        self.eps_bb = interband_eps(self.lambda_m, host(self.bb_lam_um),
                                    host(self.bb_re), host(self.bb_im))

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * units.C_SI / self.lambda_m

    @property
    def k0_per_a(self) -> float:
        """Vacuum wavenumber in 1/Angstrom (imd_tmm.c:151-152)."""
        return 2.0 * math.pi / self.lambda_m * 1e-10


def make_tmm_params(cfg, dtype=torch.float64, device="cuda") -> TMMParams:
    """TMMParams from a TMMConfig (tmm_init, imd_tmm.c:98-191)."""
    _, k1, k2 = k12_tables()
    bb = np.loadtxt(cfg.bb_table) if cfg.bb_table else default_bb_table()

    def t(a):
        return torch.as_tensor(np.asarray(a, np_dtype(dtype)), device=device)

    return TMMParams(
        lambda_m=cfg.lambda_m, i0=cfg.I0, t0_s=cfg.t0_s,
        sigma_t_s=cfg.sigma_t_s, t1_s=cfg.t1_s, sigma_t1_s=cfg.sigma_t1_s,
        absorption_threshold=cfg.absorption_threshold,
        laser_threshold=cfg.laser_threshold,
        k1_tab=t(k1), k2_tab=t(k2), bb_lam_um=t(bb[:, 0]), bb_re=t(bb[:, 1]),
        bb_im=t(bb[:, 2]))


def ne_critical(omega_las):
    """Critical electron density [1/m^3]."""
    return (units.EMASS_KG * units.EPS0 / units.ECHARGE_C ** 2) \
        * omega_las ** 2


def wide_range_epsilon(tmm: TMMParams, Te_eV, Ti_eV, Z, ne, bb_off=None):
    """Complex permittivity per cell (tmm_get_epsilon, imd_tmm.c:501-586);
    all arguments elementwise tensors.  ``bb_off`` (bool) switches the
    interband term off (molten/vapour/plasma EOS phases,
    imd_tmm.c:545-548)."""
    Te_K = Te_eV * wr.EV_TO_K
    Ti_K = Ti_eV * wr.EV_TO_K
    omega = tmm.omega
    ncr = ne_critical(omega)
    Z = torch.clamp(Z, min=1e-10)
    ni = ne / Z
    EF = wr.fermi_E(ne)
    TF = 2.0 * EF / (3.0 * wr.BOLTZMAN)
    VF = torch.sqrt(2.0 * EF / wr.EMASS)

    nu_met = wr.numet(A1P, A2P, Te_K, Ti_K, TF)
    nu_max = wr.numax(A3P, VF, Te_K, ni)
    nu_pl = wr.nupl(omega, Z, ni, ne, Te_K, True)
    ksi = 0.75 * math.sqrt(math.pi) * nu_pl / omega

    eps_bb = tmm.eps_bb
    if bb_off is not None:
        eps_bb = torch.where(bb_off, 0.0, torch.zeros_like(Te_eV) + eps_bb)

    eps_met = eps_bb + 1.0 - (ne / ncr) / (
        1.0 + 1j * torch.minimum(nu_met, nu_max) / omega)
    eps_pl = 1.0 - (ne / ncr) * (k1_of(tmm.k1_tab, ksi)
                                 - 1j * nu_pl / omega
                                 * k2_of(tmm.k2_tab, ksi))
    return eps_pl + (eps_met - eps_pl) * torch.exp(-A4P * Te_K / TF)


def intensity(tmm: TMMParams, t_si):
    """I(t), Gaussian double pulse in SI (imd_tmm.c:197-198)."""
    s1 = max(tmm.sigma_t_s, 1e-300) ** 2
    it = tmm.i0 * torch.exp(-(t_si - tmm.t0_s) ** 2 / s1)
    if tmm.sigma_t1_s > 0.0:
        it = it + tmm.i0 * torch.exp(-(t_si - tmm.t1_s) ** 2
                                     / tmm.sigma_t1_s ** 2)
    return it


def _layer_mean_e2(kd, bp, bm):
    """Exact <|B+ e^{ikdz} + B- e^{-ikdz}|^2>_{z in [0,1]}: the closed
    form of the reference's Runge5 adaptive integral (imd_tmm.c:36-69);
    kd = k*d is the complex phase across the layer."""
    kap = 2.0 * kd.imag
    phi = 2.0 * kd.real
    small_k = kap.abs() < 1e-8
    small_p = phi.abs() < 1e-8
    kap_s = torch.where(small_k, 1.0, kap)
    phi_s = torch.where(small_p, 1.0, phi)
    e1 = torch.where(small_k, 1.0 - 0.5 * kap,
                     (1.0 - torch.exp(-kap_s)) / kap_s)
    e2 = torch.where(small_k, 1.0 + 0.5 * kap,
                     (torch.exp(kap_s) - 1.0) / kap_s)
    cross = torch.where(small_p, 1.0 + 0.5j * phi,
                        (torch.exp(1j * phi_s) - 1.0) / (1j * phi_s))
    return (bp.abs() ** 2 * e1 + bm.abs() ** 2 * e2
            + 2.0 * (bp * bm.conj() * cross).real)


def _mul2(y, x):
    """Elementwise 2x2 products y @ x of matrices held as their four
    entries (m00, m01, m10, m11), each a tensor of the batch."""
    y00, y01, y10, y11 = y
    x00, x01, x10, x11 = x
    return (y00 * x00 + y01 * x10, y00 * x01 + y01 * x11,
            y10 * x00 + y11 * x10, y10 * x01 + y11 * x11)


def prefix_products(m):
    """All prefix products W_i = M_i ... M_0 of the matrices ``m`` (their
    four entries, [n] tensors each) by a doubling scan: ceil(log2 n)
    levels, each one batched product."""
    w = m
    n = m[0].shape[0]
    s = 1
    while s < n:
        prod = _mul2(tuple(e[s:] for e in w), tuple(e[:-s] for e in w))
        w = tuple(torch.cat([e[:s], p]) for e, p in zip(w, prod))
        s *= 2
    return w


def solve_layers(k0, eps, cell_on, fd_h_x, it, absorption_threshold):
    """Transfer-matrix solve through a permittivity profile.

    ``eps`` [nx] complex (1 in vacuum cells), ``k0`` (1/A) a float,
    ``fd_h_x`` the layer thickness in Angstrom, ``it`` the
    instantaneous intensity (W/m^2), ``absorption_threshold`` a float.
    Returns a dict with qabs_wm3 [nx] (W/m^3), refl/trans/absorb, ecut and
    ok (0-d tensors)."""
    nx = eps.shape[0]
    rdt = eps.real.dtype
    dev = eps.device
    km = k0 * torch.sqrt(eps)                    # [nx] complex, 1/A

    # interface matrices M_i : layer i -> i+1 across thickness d_i; the
    # vacuum in front of the first active cell has zero thickness (a
    # unit-modulus phase, see the module docstring)
    first_on = torch.argmax(cell_on.to(torch.int32)).clamp(min=1)
    d = torch.where(torch.arange(nx - 1, device=dev) < first_on,
                    torch.zeros((), dtype=rdt, device=dev),
                    torch.full((), fd_h_x, dtype=rdt, device=dev))
    kl = km[:-1]
    kr = km[1:]
    a = torch.exp(1j * kl * d)
    rho = kl / kr
    m = (0.5 * (1.0 + rho) * a, 0.5 * (1.0 - rho) / a,
         0.5 * (1.0 - rho) * a, 0.5 * (1.0 + rho) / a)
    w00, w01, w10, w11 = prefix_products(m)

    safe = torch.where(w11.abs() > 0, w11, torch.ones_like(w11))
    br_i = -w10 / safe                           # per-prefix reflection
    bt_i = w00 + w01 * br_i                      # per-prefix transmission
    bt2 = bt_i.abs() ** 2

    # the cutoff: the transmitted intensity or the accumulated optical
    # depth past the threshold, whichever comes first (imd_tmm.c:365)
    # (host numbers in the real dtype: a tensor made of one on the card
    # would be a copy that waits for the stream)
    np_rdt = np_dtype(rdt).type
    thr = np_rdt(absorption_threshold)
    thresh = float(np.exp(-thr))
    depth = torch.cumsum(2.0 * kl.imag * d, 0)
    below = (bt2 < thresh) | (depth > float(thr))
    ok = below.any()
    first = torch.argmax(below.to(torch.int32))  # the first True
    ecut = torch.where(ok, first + 1, nx - 1)

    at = (ecut - 1).reshape(1)
    br = br_i.index_select(0, at)
    bt = bt_i.index_select(0, at)[0]
    refl = br[0].abs() ** 2
    trans = bt.abs() ** 2
    absorb = 1.0 - refl - trans

    # per-layer amplitudes: F_0 = (1, BR), F_j = W_{j-1} (1, BR)
    one = torch.ones(1, dtype=eps.dtype, device=dev)
    bp = torch.cat([one, w00 + w01 * br])
    bm = torch.cat([br, w10 + w11 * br])

    # Q_abs per layer (imd_tmm.c:422-440): W/m^2 per Angstrom of depth
    in_range = torch.arange(nx, device=dev) < ecut
    e2_mean = _layer_mean_e2(km * fd_h_x, bp, bm)
    qabs = it * k0 * eps.imag * e2_mean
    qabs = torch.where(in_range & cell_on, qabs, 0.0).to(rdt)
    qabs = qabs * 1e10                           # -> W/m^3
    return dict(qabs_wm3=qabs, refl=refl.to(rdt), trans=trans.to(rdt),
                absorb=absorb.to(rdt), ok=ok, ecut=ecut)


def tmm_solve(tmm: TMMParams, natoms, dens, Te_eV, Ti_eV, Z, ne,
              fd_h_x: float, t_si, fd_min_atoms: int = 1,
              rho_min: float = 2.0, bb_off=None):
    """The TMM step on the FD column profile ([nx] tensors; ``t_si`` a 0-d
    tensor of seconds).  Returns a dict with source [nx] (IMD power
    density), laser_active (bool), refl/trans/absorb, I_t, eps (complex),
    ok (False when the sample is too short for the absorption threshold;
    the reference aborts, imd_tmm.c:365) and ecut."""
    rdt = Te_eV.dtype
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    dev = Te_eV.device

    it = intensity(tmm, t_si)
    # E-field-strength threshold (imd_tmm.c:201)
    np_rdt = np_dtype(rdt).type
    active_pulse = torch.sqrt(2.0 * it * VACUUM_IMPEDANCE) >= (
        tmm.laser_threshold * math.sqrt(2.0 * VACUUM_IMPEDANCE)
        * float(np.sqrt(np_rdt(tmm.i0))))

    cell_on = (natoms >= fd_min_atoms) & (dens >= rho_min)
    cell_on[0] = False                           # entry cell is vacuum
    eps = torch.where(
        cell_on,
        wide_range_epsilon(tmm, torch.clamp(Te_eV, min=1e-6),
                           torch.clamp(Ti_eV, min=1e-6),
                           torch.clamp(Z, min=1e-3),
                           torch.clamp(ne, min=1.0), bb_off).to(cdt),
        torch.ones((), dtype=cdt, device=dev))

    k0 = float(np_rdt(tmm.k0_per_a))
    res = solve_layers(k0, eps, cell_on, fd_h_x, it,
                       tmm.absorption_threshold)
    source = res["qabs_wm3"] * WM3_TO_IMD        # -> IMD units
    source = torch.where(active_pulse, source, 0.0)
    return dict(source=source, laser_active=active_pulse, I_t=it, eps=eps,
                **{k: res[k] for k in ("refl", "trans", "absorb", "ok",
                                       "ecut")})


def do_tmm(grid, params, tmm: TMMParams, t_si, bb_off=None):
    """The source on a TTMGrid (the do_tmm call, imd_ttm.c:111-121).
    Returns (grid with .source set, the tmm_solve dict)."""
    res = tmm_solve(tmm, grid.natoms, grid.dens, grid.temp, grid.md_temp,
                    grid.Z, grid.ne, params.fd_h_x, t_si,
                    fd_min_atoms=params.fd_min_atoms,
                    rho_min=params.rho_min, bb_off=bb_off)
    return grid.replace(source=res["source"]), res
