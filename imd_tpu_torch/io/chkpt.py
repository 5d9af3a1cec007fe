"""Checkpoint (.chkpt) and .itr sidecar I/O (port of imd_tpu/io/chkpt.py).

Format (imd_io.c write_header_config:~310, imd_io_3d.c read_atoms:44):

    #F <A|b|l|B|L> 1 1 1 <DIM> <DIM|0> <n_data>
    #C number type mass x y z vx vy vz Epot [...]
    #X x1 x2 x3          (box vectors)
    #Y ...
    #Z ...
    ## comments
    #E
    <atom lines: number type mass x y z vx vy vz Epot ...>

'A' = ASCII; 'b'/'l' = big/little-endian binary single precision;
'B'/'L' = double precision.  Binary atom records are (int32 number,
int32 type, then float32/float64 fields).  Velocities are stored (momentum
/ mass), Epot is the per-atom potential energy.

ASCII bodies are parsed and formatted with NumPy alone: the JAX package's
compiled helper library (imd_tpu.native) belongs to that package.  The
written text is the JAX package's NumPy fallback format (``%.12g``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from imd_tpu_torch.config import parse_param_text

_FORMAT_ROWS = 65536      # rows formatted per string operation


@dataclasses.dataclass
class ChkptData:
    """Host-side atom data read from / written to a checkpoint."""
    number: np.ndarray           # [N] int
    type: np.ndarray             # [N] int (vtype as written by reference)
    mass: np.ndarray             # [N]
    pos: np.ndarray              # [N,3]
    vel: np.ndarray              # [N,3] (may be zeros when n_vel == 0)
    data: np.ndarray             # [N,n_data] extra columns (Epot first)
    box_x: Optional[np.ndarray] = None
    box_y: Optional[np.ndarray] = None
    box_z: Optional[np.ndarray] = None
    columns: Optional[list] = None
    have_vel: bool = True

    @property
    def n(self) -> int:
        return len(self.number)

    @property
    def epot(self) -> np.ndarray:
        return self.data[:, 0] if self.data.shape[1] else np.zeros(self.n)


def _parse_ascii(body: bytes, n_items: int) -> np.ndarray:
    """Whitespace-separated numbers -> [rows, n_items] float64."""
    vals = np.array(body.split(), dtype=np.float64)
    if len(vals) % n_items:
        raise ValueError(f"checkpoint body size {len(vals)} not divisible "
                         f"by {n_items} items/atom")
    return vals.reshape(-1, n_items)


def read_chkpt(path: str) -> ChkptData:
    with open(path, "rb") as f:
        raw = f.read()
    fmt = "A"
    n_number = n_type = n_mass = 1
    n_pos = n_vel = 3
    n_data = 1
    box = {}
    columns = None
    offset = 0
    have_header = False
    while True:
        nl = raw.find(b"\n", offset)
        if nl < 0:
            break
        line = raw[offset:nl]
        if not line.startswith(b"#"):
            break
        have_header = True
        key = line[1:2]
        if key == b"F":
            parts = line[2:].split()
            fmt = parts[0].decode()
            (n_number, n_type, n_mass, n_pos, n_vel, n_data) = (
                int(x) for x in parts[1:7])
        elif key == b"C":
            columns = line[2:].decode().split()
        elif key in (b"X", b"Y", b"Z"):
            box["#" + key.decode()] = np.array(
                [float(x) for x in line[2:].split()])
        elif key == b"E":
            offset = nl + 1
            break
        offset = nl + 1
    if not have_header:
        offset = 0

    n_items = n_number + n_type + n_mass + n_pos + n_vel + n_data
    if fmt == "A":
        rows = _parse_ascii(raw[offset:], n_items)
        c = 0
        number = rows[:, c].astype(np.int64)
        c += n_number
        typ = (rows[:, c].astype(np.int32) if n_type
               else np.zeros(len(rows), np.int32))
        c += n_type
        mass = rows[:, c] if n_mass else np.ones(len(rows))
        c += n_mass
        pos = rows[:, c:c + n_pos]
        c += n_pos
        vel = rows[:, c:c + n_vel] if n_vel else np.zeros((len(rows), 3))
        c += n_vel
        data = rows[:, c:c + n_data]
    else:
        bo = ">" if fmt in ("B", "b") else "<"
        fdt = bo + ("f8" if fmt in ("B", "L") else "f4")
        nf = n_mass + n_pos + n_vel + n_data
        rec = np.dtype([("number", bo + "i4"), ("type", bo + "i4"),
                        ("f", fdt, (nf,))])
        body = raw[offset:]
        n = len(body) // rec.itemsize
        arr = np.frombuffer(body[:n * rec.itemsize], dtype=rec)
        number = arr["number"].astype(np.int64)
        typ = arr["type"].astype(np.int32)
        fdat = arr["f"].astype(np.float64)
        c = 0
        mass = fdat[:, c] if n_mass else np.ones(n)
        c += n_mass
        pos = fdat[:, c:c + n_pos]
        c += n_pos
        vel = fdat[:, c:c + n_vel] if n_vel else np.zeros((n, 3))
        c += n_vel
        data = fdat[:, c:c + n_data]
    if pos.shape[1] == 2:  # 2D configs: promote to 3D
        pos = np.pad(pos, ((0, 0), (0, 1)))
        vel = np.pad(vel, ((0, 0), (0, 1))) if vel.shape[1] == 2 else vel
    return ChkptData(number=number, type=typ, mass=mass, pos=pos, vel=vel,
                     data=data, box_x=box.get("#X"), box_y=box.get("#Y"),
                     box_z=box.get("#Z"), columns=columns,
                     have_vel=n_vel > 0)


def data_column(d: ChkptData, name: str):
    """Extra-data column by #C header name (None when absent)."""
    if d.columns is None or d.data is None or d.data.ndim != 2:
        return None
    try:
        j = d.columns.index(name)
    except ValueError:
        return None
    k = j - (len(d.columns) - d.data.shape[1])
    return d.data[:, k] if 0 <= k < d.data.shape[1] else None


def _format_ascii(body: np.ndarray, precision: int) -> bytes:
    """Rows of (number, type, floats...) as '%d %d %.<p>g ...' lines."""
    n, ncol = body.shape
    if n == 0:
        return b"\n"
    row = "%d %d " + " ".join(["%%.%dg" % precision] * (ncol - 2)) + "\n"
    ints = body[:, :2].astype(np.int64)
    out = []
    for a in range(0, n, _FORMAT_ROWS):
        vals = np.empty((min(n, a + _FORMAT_ROWS) - a, ncol), object)
        vals[:, :2] = ints[a:a + _FORMAT_ROWS]
        vals[:, 2:] = body[a:a + _FORMAT_ROWS, 2:]
        out.append((row * len(vals)) % tuple(vals.ravel().tolist()))
    return "".join(out).encode()


def write_chkpt(path: str, d: ChkptData, binary: bool = False,
                double: bool = False, comment: str = "",
                precision: int = 12):
    """``precision`` is the ASCII significant-digit count (the HPO
    compile flag's %.16e formats, imd_io.c:2297 -> precision=17)."""
    n_data = d.data.shape[1] if d.data.ndim == 2 else 1
    data = d.data.reshape(len(d.number), n_data)
    cols = d.columns or (["number", "type", "mass", "x", "y", "z",
                          "vx", "vy", "vz", "Epot"]
                         + [f"d{i}" for i in range(1, n_data)])
    with open(path, "wb") as f:
        c = ("L" if double else "l") if binary else "A"
        hdr = [f"#F {c} 1 1 1 3 3 {n_data}", "#C " + " ".join(cols)]
        for key, v in (("#X", d.box_x), ("#Y", d.box_y), ("#Z", d.box_z)):
            if v is not None:
                hdr.append(key + " " + " ".join(f"{x:.16e}" for x in v))
        if comment:
            hdr.append("## " + comment)
        hdr.append("#E")
        f.write(("\n".join(hdr) + "\n").encode())
        if binary:
            fdt = "<f8" if double else "<f4"
            nf = 1 + 3 + 3 + n_data
            rec = np.dtype([("number", "<i4"), ("type", "<i4"),
                            ("f", fdt, (nf,))])
            out = np.empty(len(d.number), rec)
            out["number"] = d.number
            out["type"] = d.type
            out["f"][:, 0] = d.mass
            out["f"][:, 1:4] = d.pos
            out["f"][:, 4:7] = d.vel
            out["f"][:, 7:] = data
            f.write(out.tobytes())
        else:
            body = np.column_stack([d.number.astype(np.float64),
                                    d.type.astype(np.float64), d.mass,
                                    d.pos, d.vel, data])
            f.write(_format_ascii(body, precision))


# ---------------------------------------------------------------------------
# .itr sidecar
# ---------------------------------------------------------------------------

def write_itr(path: str, *, checkpoint: int, startstep: int, box_x, box_y,
              box_z, extra: Optional[Dict] = None):
    with open(path, "w") as f:
        f.write(f"# checkpoint {checkpoint}\n")
        f.write(f"startstep \t{startstep}\n")
        f.write("box_x \t%.16f %.16f %.16f\n" % tuple(box_x))
        f.write("box_y \t%.16f %.16f %.16f\n" % tuple(box_y))
        f.write("box_z \t%.16f %.16f %.16f\n" % tuple(box_z))
        for k, v in (extra or {}).items():
            if isinstance(v, (tuple, list, np.ndarray)):
                f.write(f"{k} \t" + " ".join(f"{x:.16g}" for x in v) + "\n")
            else:
                f.write(f"{k} \t{v}\n")


def read_itr(path: str) -> Dict:
    with open(path) as f:
        return parse_param_text(f.read())
