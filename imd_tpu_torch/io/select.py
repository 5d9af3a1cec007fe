"""The selected-config observers and writers (port of imd_tpu/io/select.py):
.avp / .dsp / .dem / .ef through ``SelectWriters``, and the standalone
.wf, .force (potfit), .stress and .nb writers.

- **AVPOS** (`.avp`): time-averaged positions and potential energy;
  unwrapped coordinates accumulate every ``avpos_res`` steps and every
  ``avpos_int`` steps the average, wrapped back into the box, is written
  and the accumulator reset (add_positions, imd_misc.c:124;
  write_atoms_avp, imd_io.c:1604).
- **DSP** (`.dsp`): displacements from the configuration captured at
  ``update_ort_ref`` above ``min_dsp2`` (imd_io.c:1539).
- **DEM** (`.dem`): |Epot - Epot_ref| above ``min_dpot``, the reference
  captured at ``reset_Epot_step`` with ``calc_Epot_ref``
  (imd_io.c:1484/1617).
- **EFILTER** (`.ef`): atoms whose per-type Epot lies in
  [e_pot_lower, e_pot_upper], in the pic window when pic_ur.x != 0
  (write_atoms_ef, imd_io.c:727-790).

Host-side observers fed from the flattened Scene at I/O boundaries; their
per-atom state is indexed by atom id.  The PBC unwrap is rebuilt from
minimum-image deltas between samples.  The trajectory observers of
imd_tpu (``nmoldyn_int``, ``dsf_int``, io/traj.py) are not ported: the
driver refuses them.
"""

from __future__ import annotations

import numpy as np

from imd_tpu_torch.scene import flatten_atoms


def flat_host(scene) -> dict:
    """The live atoms' fields as NumPy arrays (one host transfer each)."""
    flat = flatten_atoms(scene)
    mask = flat["mask"].detach().cpu().numpy()
    return {k: v.detach().cpu().numpy()[mask] for k, v in flat.items()
            if k != "mask"}


def min_image(d, box_h, inv_h, pbc):
    """Minimum-image convention for displacement rows ``d`` (the
    .avp/.dsp unwrap; rows of box_h are the box vectors, pos = frac @ h)."""
    frac = d @ inv_h
    for a in range(3):
        if pbc[a]:
            frac[:, a] -= np.rint(frac[:, a])
    return frac @ box_h


def _header(f, kind: str, n_data: int, box_h, pbc):
    if kind == "ef":        # checkpoint layout: id/type/mass + pos + vel
        f.write(f"#F A 1 1 1 3 3 {n_data}\n")
    else:
        f.write(f"#F A {'1 1 1' if kind == 'avp' else '0 1 0'} 3 0 "
                f"{n_data}\n")
    cols = {"avp": "number type mass x y z Epot_av",
            "dsp": "type x y z dx dy dz",
            "dem": "type x y z dpot",
            "ef": "number type mass x y z vx vy vz Epot"}[kind]
    f.write(f"#C {cols}\n")
    h = np.asarray(box_h, np.float64)
    f.write(f"#X \t{h[0, 0]:.16e} {h[0, 1]:.16e} {h[0, 2]:.16e}\n")
    f.write(f"#Y \t{h[1, 0]:.16e} {h[1, 1]:.16e} {h[1, 2]:.16e}\n")
    f.write(f"#Z \t{h[2, 0]:.16e} {h[2, 1]:.16e} {h[2, 2]:.16e}\n")
    f.write(f"##PBC {int(pbc[0])} {int(pbc[1])} {int(pbc[2])}\n")
    f.write("#E\n")


class SelectWriters:
    """Drives the .avp/.dsp/.dem cadences from the simulation loop.

    ``step(scene, gstep)`` is called at every I/O boundary; the class
    decides internally which observers fire.  ``intervals()`` returns
    the step intervals the run loop must align its dispatch blocks to,
    and ``special_steps()`` the one-off steps (reference capture) that
    need an exact block boundary.
    """

    def __init__(self, cfg, box_h, pbc, path_fn):
        self.cfg = cfg
        self.box_h = np.asarray(box_h, np.float64)
        self.inv_h = np.linalg.inv(self.box_h)
        self.pbc = tuple(int(b) for b in pbc)
        self._path = path_fn
        # id-indexed reference/accumulator state (grown on demand)
        self.ort_ref = None          # [maxid+1, 3]
        self.epot_ref = None         # [maxid+1]
        self.av_pos = None           # [maxid+1, 3] unwrapped position sums
        self.av_epot = None          # [maxid+1]
        self.av_prev = None          # [maxid+1, 3] last sampled wrapped pos
        self.av_unwrap = None        # [maxid+1, 3] last unwrapped pos
        self.av_cnt = 0

    # -- activation -----------------------------------------------------
    @classmethod
    def wanted(cls, cfg) -> bool:
        """Does this config activate any host-side per-atom observer?"""
        return (cfg.avpos_int > 0 or cfg.dsp_int > 0 or cfg.dem_int > 0
                or cfg.ef_checkpt_int > 0)

    @property
    def avpos_on(self) -> bool:
        return self.cfg.avpos_int > 0

    @property
    def dsp_on(self) -> bool:
        return self.cfg.dsp_int > 0

    @property
    def dem_on(self) -> bool:
        return self.cfg.dem_int > 0

    @property
    def ef_on(self) -> bool:
        return self.cfg.ef_checkpt_int > 0

    @property
    def active(self) -> bool:
        return self.avpos_on or self.dsp_on or self.dem_on or self.ef_on

    def intervals(self):
        """Cadence list for the dispatch-block clamp.  Entries are either
        a plain interval (fires on absolute multiples) or an
        ``(interval, phase)`` pair: AVPOS fires on the
        ``(steps - avpos_start)`` lattice (imd_main_3d.c:629-639), so
        with a start that is not a multiple of the interval the due
        steps are NOT absolute multiples and a plain-interval clamp
        would never land on them."""
        c = self.cfg
        out = []
        if self.avpos_on:
            out.append((c.avpos_int, c.avpos_start % c.avpos_int))
            if c.avpos_res > 0:
                out.append((c.avpos_res, c.avpos_start % c.avpos_res))
        if self.dsp_on:
            out.append(c.dsp_int)
        if self.dem_on:
            out.append(c.dem_int)
        if self.ef_on:
            out.append(c.ef_checkpt_int)
        return out

    def special_steps(self):
        s = set()
        if self.dsp_on:
            s.add(int(self.cfg.update_ort_ref))
        if self.dem_on and self.cfg.calc_Epot_ref:
            s.add(int(self.cfg.reset_Epot_step))
        if self.avpos_on:
            s.add(int(self.cfg.avpos_start))
            if self.cfg.avpos_end > 0:
                s.add(int(self.cfg.avpos_end))
        return {x for x in s if x > 0}

    # -- helpers ----------------------------------------------------------
    def _flat(self, scene):
        return flat_host(scene)

    def _ensure(self, arr, n, width=None, fill=0.0):
        shape = (n,) if width is None else (n, width)
        if arr is None:
            return np.full(shape, fill)
        if len(arr) < n:
            out = np.full(shape, fill)
            out[:len(arr)] = arr
            return out
        return arr

    def _min_image(self, d):
        return min_image(d, self.box_h, self.inv_h, self.pbc)

    # -- cadence driver ---------------------------------------------------
    def init_refs(self, scene, gstep: int = 0):
        """Capture step-0 references (the reference's defaults fire at
        steps == 0 before the loop)."""
        c = self.cfg
        f = None
        # skip when a reference is already present (loaded from the
        # restart checkpoint's x_ref/Epot_ref columns, or captured by an
        # earlier phase): recapturing here would silently rebase .dsp/.dem
        # to the restart snapshot (the reference persists ORT_REF through
        # the config file, imd_io.c:3300/3530, and only recaptures at
        # steps == up_ort_ref)
        if (self.dsp_on and self.ort_ref is None
                and int(c.update_ort_ref) <= gstep):
            if gstep > int(c.update_ort_ref):
                import warnings
                warnings.warn(
                    "DSP reference positions not found in the restart "
                    "checkpoint (no x_ref columns); capturing the "
                    f"step-{gstep} state as the reference — .dsp "
                    "displacements are measured from the restart "
                    "snapshot, not the original configuration")
            f = f or self._flat(scene)
            self._capture_ort_ref(f)
        if (self.dem_on and c.calc_Epot_ref and self.epot_ref is None
                and int(c.reset_Epot_step) <= gstep):
            f = f or self._flat(scene)
            self._capture_epot_ref(f)
        if self.avpos_on and int(c.avpos_start) <= gstep:
            f = f or self._flat(scene)
            self._avpos_reset(f)

    def preload_refs(self, ids, ort=None, epot=None):
        """Seed the DISLOC references from a restart checkpoint's
        x_ref/y_ref/z_ref/Epot_ref columns (imd_io.c:3300, read at
        imd_io_3d.c:409) so .dsp/.dem keep measuring against the
        original configuration across restarts."""
        ids = np.asarray(ids, int)
        n = ids.max() + 1 if len(ids) else 0
        if ort is not None:
            self.ort_ref = self._ensure(None, n, 3, fill=np.nan)
            self.ort_ref[ids] = np.asarray(ort)
        if epot is not None:
            self.epot_ref = self._ensure(None, n, fill=np.nan)
            self.epot_ref[ids] = np.asarray(epot)

    def _capture_ort_ref(self, f):
        ids = f["id"].astype(int)
        n = ids.max() + 1 if len(ids) else 0
        # NaN marks ids with no captured reference (non-contiguous ids,
        # atoms created later): writers substitute per-atom defaults
        self.ort_ref = self._ensure(None, n, 3, fill=np.nan)
        self.ort_ref[ids] = f["pos"]

    def _capture_epot_ref(self, f):
        ids = f["id"].astype(int)
        n = ids.max() + 1 if len(ids) else 0
        self.epot_ref = self._ensure(None, n, fill=np.nan)
        self.epot_ref[ids] = f["epot"]

    def _avpos_reset(self, f):
        ids = f["id"].astype(int)
        n = ids.max() + 1 if len(ids) else 0
        self.av_pos = self._ensure(None, n, 3)
        self.av_epot = self._ensure(None, n)
        self.av_prev = self._ensure(None, n, 3)
        self.av_unwrap = self._ensure(None, n, 3)
        self.av_pos[ids] = f["pos"]
        self.av_unwrap[ids] = f["pos"]
        self.av_prev[ids] = f["pos"]
        self.av_epot[ids] = f["epot"]
        self.av_cnt = 1

    def _avpos_sample(self, f):
        ids = f["id"].astype(int)
        n = ids.max() + 1 if len(ids) else 0
        if self.av_pos is None or n > len(self.av_epot):
            self._avpos_reset(f)
            return
        # unwrap: minimum-image delta from the previous sample
        d = self._min_image(f["pos"] - self.av_prev[ids])
        self.av_unwrap[ids] += d
        self.av_prev[ids] = f["pos"]
        self.av_pos[ids] += self.av_unwrap[ids]
        self.av_epot[ids] += f["epot"]
        self.av_cnt += 1

    def needs_epot(self, gstep: int) -> bool:
        """Does any observer firing at ``gstep`` read the epot column?

        Mirrors step()'s cadence logic for the epot consumers (AVPOS
        accumulation, .dem, .ef, the Epot-reference capture) so the
        driver can skip the ORDPAR pair sweep at boundaries where only
        the position-based .dsp fires."""
        c = self.cfg
        if (self.dem_on and c.calc_Epot_ref
                and gstep == int(c.reset_Epot_step)):
            return True
        if self.dem_on and gstep % c.dem_int == 0:
            return True
        if self.ef_on and gstep % c.ef_checkpt_int == 0:
            return True
        if self.avpos_on:
            if gstep == int(c.avpos_start):
                return True
            in_win = (gstep > c.avpos_start
                      and (c.avpos_end <= 0 or gstep <= c.avpos_end))
            if in_win:
                res = c.avpos_res if c.avpos_res > 0 else c.avpos_int
                if ((gstep - c.avpos_start) % res == 0
                        or (gstep - c.avpos_start) % c.avpos_int == 0):
                    return True
        return False

    def step(self, scene, gstep: int):
        """Fire every observer whose cadence matches ``gstep``."""
        if not self.active:
            return
        # track the live box (NPT barostats / HOMDEF deformation change
        # it after construction; min-image and wrap must use the current
        # vectors)
        h = np.asarray(scene.grid.box.h, np.float64)
        if not np.array_equal(h, self.box_h):
            self.box_h = h
            self.inv_h = np.linalg.inv(h)
        c = self.cfg
        f = None

        def flat():
            nonlocal f
            if f is None:
                f = self._flat(scene)
            return f

        # one-off reference captures (imd_main_3d.c:451/760)
        if self.dsp_on and gstep == int(c.update_ort_ref):
            self._capture_ort_ref(flat())
        if (self.dem_on and c.calc_Epot_ref
                and gstep == int(c.reset_Epot_step)):
            self._capture_epot_ref(flat())

        # AVPOS accumulate / write (imd_main_3d.c:768-789)
        in_win = (gstep > c.avpos_start
                  and (c.avpos_end <= 0 or gstep <= c.avpos_end))
        if self.avpos_on and gstep == int(c.avpos_start):
            self._avpos_reset(flat())
        if self.avpos_on and in_win:
            res = c.avpos_res if c.avpos_res > 0 else c.avpos_int
            if (gstep - c.avpos_start) % res == 0:
                self._avpos_sample(flat())
            if (gstep - c.avpos_start) % c.avpos_int == 0:
                self._write_avp(flat(),
                                (gstep - c.avpos_start) // c.avpos_int)
                self._avpos_reset(flat())

        # .dem/.dsp files are numbered by the RAW step, not step/int
        # (write_config_select(steps, ...) at imd_main_3d.c:761/763)
        if (self.dsp_on and gstep > int(c.update_ort_ref)
                and gstep % c.dsp_int == 0 and self.ort_ref is not None):
            self._write_dsp(flat(), gstep)
        if (self.dem_on and gstep % c.dem_int == 0
                and self.epot_ref is not None):
            self._write_dem(flat(), gstep)
        # energy-filtered configs are numbered by step/interval
        # (write_config_select(steps/ef_checkpt_int, ...), main_3d.c:745)
        if self.ef_on and gstep % c.ef_checkpt_int == 0:
            self._write_ef(flat(), gstep // c.ef_checkpt_int)

    # -- writers ----------------------------------------------------------
    def _write_avp(self, f, nr: int):
        ids = f["id"].astype(int)
        tmp = 1.0 / max(self.av_cnt, 1)
        avg = self.av_pos[ids] * tmp
        # wrap back into the box (write_atoms_avp coeff −= floor)
        frac = avg @ self.inv_h
        for a in range(3):
            if self.pbc[a]:
                frac[:, a] -= np.floor(frac[:, a])
        pos = frac @ self.box_h
        epot = self.av_epot[ids] * tmp
        with open(self._path(f"{self.cfg.outfiles}.{nr}.avp"), "w") as out:
            _header(out, "avp", 1, self.box_h, self.pbc)
            for k in range(len(ids)):
                out.write(f"{ids[k]} {int(f['vtype'][k])} "
                          f"{f['mass'][k]:e} {pos[k, 0]:e} {pos[k, 1]:e} "
                          f"{pos[k, 2]:e} {epot[k]:e}\n")

    def _write_dsp(self, f, nr: int):
        ids = f["id"].astype(int)
        # atoms without a captured reference (created after the capture,
        # restart-grown ids) measure zero displacement instead of
        # poisoning the whole frame
        ref = self._ensure(self.ort_ref, ids.max() + 1, 3,
                           fill=np.nan)[ids]
        miss = np.isnan(ref[:, 0])
        ref[miss] = f["pos"][miss]
        d = self._min_image(f["pos"] - ref)
        sel = np.einsum("ij,ij->i", d, d) > self.cfg.min_dsp2
        with open(self._path(f"{self.cfg.outfiles}.{nr}.dsp"), "w") as out:
            _header(out, "dsp", 3, self.box_h, self.pbc)
            for k in np.nonzero(sel)[0]:
                p = f["pos"][k]
                out.write(f"{int(f['vtype'][k])} {p[0]:e} {p[1]:e} "
                          f"{p[2]:e} {d[k, 0]:e} {d[k, 1]:e} {d[k, 2]:e}\n")

    def _write_ef(self, f, nr: int):
        """Energy-filtered config (write_atoms_ef, imd_io.c:727): atoms
        with e_pot_lower[type] <= Epot <= e_pot_upper[type], optionally
        clipped to the pic_ll/pic_ur window, in checkpoint columns."""
        c = self.cfg
        typ = f["type"].astype(int)
        nt = max(int(typ.max(initial=0)) + 1, 1)
        lo = np.full(nt, -np.inf)
        hi = np.full(nt, np.inf)
        lo[:len(c.e_pot_lower)] = c.e_pot_lower[:nt]
        hi[:len(c.e_pot_upper)] = c.e_pot_upper[:nt]
        sel = (f["epot"] >= lo[typ]) & (f["epot"] <= hi[typ])
        if c.pic_ur[0] != 0.0:        # window clip, exactly io.c:735-741
            p = f["pos"]
            ll, ur = np.asarray(c.pic_ll), np.asarray(c.pic_ur)
            sel &= np.all((p >= ll) & (p <= ur), axis=1)
        vel = f["mom"] / f["mass"][:, None]
        with open(self._path(f"{c.outfiles}.{nr}.ef"), "w") as out:
            _header(out, "ef", 1, self.box_h, self.pbc)
            for k in np.nonzero(sel)[0]:
                p, v = f["pos"][k], vel[k]
                out.write(f"{int(f['id'][k])} {int(f['vtype'][k])} "
                          f"{f['mass'][k]:12f} {p[0]:12f} {p[1]:12f} "
                          f"{p[2]:12f} {v[0]:12f} {v[1]:12f} {v[2]:12f} "
                          f"{f['epot'][k]:12f}\n")

    def _write_dem(self, f, nr: int):
        ids = f["id"].astype(int)
        ref = self._ensure(self.epot_ref, ids.max() + 1,
                           fill=np.nan)[ids]
        miss = np.isnan(ref)
        ref[miss] = f["epot"][miss]
        dpot = np.abs(f["epot"] - ref)
        sel = dpot > self.cfg.min_dpot
        with open(self._path(f"{self.cfg.outfiles}.{nr}.dem"), "w") as out:
            _header(out, "dem", 1, self.box_h, self.pbc)
            for k in np.nonzero(sel)[0]:
                p = f["pos"][k]
                out.write(f"{int(f['vtype'][k])} {p[0]:e} {p[1]:e} "
                          f"{p[2]:e} {dpot[k]:e}\n")


# ---------------------------------------------------------------------------
# standalone selected-config writers driven directly from the run loops
# (they need per-fire data — forces, coordination counts — that the
# SelectWriters cadence machinery doesn't carry)
# ---------------------------------------------------------------------------

def write_wf(path, flat, box_h, pbc, force_all: bool = False):
    """WRITEF `.wf` file (write_atoms_wf, imd_io.c:944-1046): forces of
    boundary (vtype != type) atoms — or all atoms when ``force_all`` —
    in `number type mass x y z fx fy fz Epot` columns."""
    typ = flat["type"].astype(int)
    vty = flat["vtype"].astype(int)
    sel = np.ones(len(typ), bool) if force_all else (typ != vty)
    with open(path, "w") as out:
        out.write("#F A 1 1 1 3 3 1\n")
        out.write("#C number type mass x y z fx fy fz Epot\n")
        h = np.asarray(box_h, np.float64)
        out.write(f"#X \t{h[0,0]:.16e} {h[0,1]:.16e} {h[0,2]:.16e}\n")
        out.write(f"#Y \t{h[1,0]:.16e} {h[1,1]:.16e} {h[1,2]:.16e}\n")
        out.write(f"#Z \t{h[2,0]:.16e} {h[2,1]:.16e} {h[2,2]:.16e}\n")
        out.write(f"##PBC {int(pbc[0])} {int(pbc[1])} {int(pbc[2])}\n")
        out.write("#E\n")
        for k in np.nonzero(sel)[0]:
            p, F = flat["pos"][k], flat["force"][k]
            out.write(f"{int(flat['id'][k])} {vty[k]} "
                      f"{flat['mass'][k]:12f} {p[0]:12f} {p[1]:12f} "
                      f"{p[2]:12f} {F[0]:12e} {F[1]:12e} {F[2]:12e} "
                      f"{flat['epot'][k]:12f}\n")


def write_nb(path, flat, nbanz, box_h, pbc, lower, upper, pic_ll=None,
             pic_ur=None):
    """NNBR `.nb` file (write_atoms_nb, imd_io.c:858-920): atoms whose
    coordination number lies OUTSIDE the open per-type interval
    (nb_cut_lower[t], nb_cut_upper[t]) — defect atoms by coordination —
    clipped to the pic window when pic_ur.x != 0.

    Deviations from the reference writer, both deliberate: the #C line
    includes the mass column the reference's body prints but its header
    omits, and vz is IMPULS_z/mass (the reference prints IMPULS_x twice,
    imd_io.c:911 — a clear typo)."""
    typ = flat["type"].astype(int)
    vty = flat["vtype"].astype(int)
    nt = max(int(typ.max(initial=0)) + 1, 1)
    lo = np.full(nt, -1, np.int64)
    hi = np.full(nt, np.iinfo(np.int64).max, np.int64)
    lo[:len(lower)] = np.asarray(lower[:nt], np.int64)
    hi[:len(upper)] = np.asarray(upper[:nt], np.int64)
    nbv = np.asarray(nbanz, np.int64)
    # reference filter (io.c:876-877): skip virtual-typed atoms and
    # atoms strictly inside the (lower, upper) band
    sel = (typ == vty) & ~((nbv > lo[typ]) & (nbv < hi[typ]))
    if pic_ur is not None and pic_ur[0] != 0.0:
        p = flat["pos"]
        sel &= np.all((p >= np.asarray(pic_ll)) & (p <= np.asarray(pic_ur)),
                      axis=1)
    vel = flat["mom"] / flat["mass"][:, None]
    with open(path, "w") as out:
        out.write("#F A 1 1 1 3 3 1\n")
        out.write("#C number type mass x y z vx vy vz Epot\n")
        h = np.asarray(box_h, np.float64)
        out.write(f"#X \t{h[0,0]:.16e} {h[0,1]:.16e} {h[0,2]:.16e}\n")
        out.write(f"#Y \t{h[1,0]:.16e} {h[1,1]:.16e} {h[1,2]:.16e}\n")
        out.write(f"#Z \t{h[2,0]:.16e} {h[2,1]:.16e} {h[2,2]:.16e}\n")
        out.write(f"##PBC {int(pbc[0])} {int(pbc[1])} {int(pbc[2])}\n")
        out.write("#E\n")
        for k in np.nonzero(sel)[0]:
            p, v = flat["pos"][k], vel[k]
            out.write(f"{int(flat['id'][k])} {vty[k]} "
                      f"{flat['mass'][k]:12f} {p[0]:12f} {p[1]:12f} "
                      f"{p[2]:12f} {v[0]:12f} {v[1]:12f} {v[2]:12f} "
                      f"{flat['epot'][k]:12f}\n")


def write_force_potfit(path, flat, box_h, pbc, epot_per_atom,
                       presstens=None, volume=None):
    """FORCE `.force` file (write_config_force, imd_io.c:1909-1985): the
    potfit reference-configuration format — `#N natoms 1`, box, `#E`
    cohesive energy, optional `#S` stress, then
    `type x y z fx fy fz` per atom (all atoms, no filter)."""
    n = len(flat["type"])
    with open(path, "w") as out:
        out.write(f"#N {n} 1\n")
        h = np.asarray(box_h, np.float64)
        out.write(f"#X {h[0,0]:.16e} {h[0,1]:.16e} {h[0,2]:.16e}\n")
        out.write(f"#Y {h[1,0]:.16e} {h[1,1]:.16e} {h[1,2]:.16e}\n")
        out.write(f"#Z {h[2,0]:.16e} {h[2,1]:.16e} {h[2,2]:.16e}\n")
        out.write(f"##PBC {int(pbc[0])} {int(pbc[1])} {int(pbc[2])}\n")
        out.write(f"#E {epot_per_atom:.16e}\n")
        if presstens is not None and volume:
            p = np.asarray(presstens, np.float64) / float(volume)
            # reference order: xx yy zz xy yz zx (imd_io.c:1934-1937)
            out.write(f"#S {p[0]:.8e} {p[1]:.8e} {p[2]:.8e} "
                      f"{p[5]:.8e} {p[3]:.8e} {p[4]:.8e}\n")
        out.write("#F\n")
        typ = flat["vtype"].astype(int)
        for k in range(n):
            p_, F = flat["pos"][k], flat["force"][k]
            out.write(f"{typ[k]} {p_[0]:.16e} {p_[1]:.16e} {p_[2]:.16e} "
                      f"{F[0]:.16e} {F[1]:.16e} {F[2]:.16e}\n")


def write_press(path, flat, pt_atom, box_h, pbc):
    """STRESS_TENS per-atom pressure-tensor config (write_atoms_press +
    write_header_press, imd_io.c:1066-1130): `number type mass x y z
    P_xx P_yy P_zz P_yz P_zx P_xy` columns.  The fork renames the file
    suffix .press -> .stress (write_config_press, imd_io.c:1264-1276)."""
    vty = flat["vtype"].astype(int)
    with open(path, "w") as out:
        out.write("#F A 1 1 1 3 0 6\n")
        out.write("#C number type mass x y z P_xx P_yy P_zz P_yz P_zx "
                  "P_xy\n")
        h = np.asarray(box_h, np.float64)
        out.write(f"#X \t{h[0,0]:.16e} {h[0,1]:.16e} {h[0,2]:.16e}\n")
        out.write(f"#Y \t{h[1,0]:.16e} {h[1,1]:.16e} {h[1,2]:.16e}\n")
        out.write(f"#Z \t{h[2,0]:.16e} {h[2,1]:.16e} {h[2,2]:.16e}\n")
        out.write(f"##PBC {int(pbc[0])} {int(pbc[1])} {int(pbc[2])}\n")
        out.write("#E\n")
        for k in range(len(vty)):
            p, s = flat["pos"][k], pt_atom[k]
            out.write(f"{int(flat['id'][k])} {vty[k]} "
                      f"{flat['mass'][k]:f} {p[0]:.12f} {p[1]:.12f} "
                      f"{p[2]:.12f} {s[0]:.12e} {s[1]:.12e} {s[2]:.12e} "
                      f"{s[3]:.12e} {s[4]:.12e} {s[5]:.12e}\n")
