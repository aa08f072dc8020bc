"""PCD v0.7 file I/O (host-side, numpy; a copy of pcr_tpu/utils/pcd.py).

Replaces ``o3d.io.read_point_cloud`` of the reference scripts.  Supports the
subset of the format the reference datasets use: FIELDS x y z [rgb], TYPE F,
SIZE 4, DATA ascii | binary.

The faster C++ reader (``pcr_tpu_torch.native``) backs the loaders; this
module is the portable fallback and the format authority for tests.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


@dataclass
class PcdData:
    """Decoded PCD contents: xyz always, plus optional extra fields."""

    points: np.ndarray                      # (N, 3) float32
    colors: np.ndarray | None = None        # (N, 3) float32 in [0, 1] (from packed rgb)
    fields: dict = field(default_factory=dict)


def _parse_header(fh):
    header = {}
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("unexpected EOF in PCD header")
        text = line.decode("ascii", errors="replace").strip()
        if not text or text.startswith("#"):
            continue
        key, _, rest = text.partition(" ")
        key = key.upper()
        header[key] = rest.split()
        if key == "DATA":
            return header


def read_pcd(path: str | os.PathLike) -> PcdData:
    """Read a PCD v0.7 file (ascii or binary) into numpy arrays."""
    with open(path, "rb") as fh:
        header = _parse_header(fh)
        fields = [f.lower() for f in header["FIELDS"]]
        sizes = [int(s) for s in header["SIZE"]]
        types = [t.upper() for t in header["TYPE"]]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        dtype_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            base = _TYPE_MAP.get((typ, size))
            if base is None:
                raise ValueError(f"unsupported PCD field type {typ}{size}")
            if count == 1:
                dtype_fields.append((name, "<" + base))
            else:
                dtype_fields.append((name, "<" + base, (count,)))
        dtype = np.dtype(dtype_fields)

        if mode == "binary":
            raw = fh.read(dtype.itemsize * n_points)
            rec = np.frombuffer(raw, dtype=dtype, count=n_points)
        elif mode == "ascii":
            rec = np.loadtxt(fh, dtype=np.float64, max_rows=n_points)
            rec = np.rec.fromarrays(
                [rec[:, i].astype(dtype_fields[i][1]) for i in range(len(fields))],
                dtype=dtype,
            )
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    points = np.stack(
        [rec["x"].astype(np.float32), rec["y"].astype(np.float32), rec["z"].astype(np.float32)],
        axis=1,
    )
    colors = None
    extras = {}
    if "rgb" in fields:
        # Packed float rgb (PCL convention): reinterpret float32 as uint32 0xRRGGBB
        packed = rec["rgb"].view(np.uint32)
        r = ((packed >> 16) & 0xFF).astype(np.float32) / 255.0
        g = ((packed >> 8) & 0xFF).astype(np.float32) / 255.0
        b = (packed & 0xFF).astype(np.float32) / 255.0
        colors = np.stack([r, g, b], axis=1)
    for name in fields:
        if name not in ("x", "y", "z", "rgb"):
            extras[name] = np.asarray(rec[name])
    return PcdData(points=points, colors=colors, fields=extras)


def write_pcd(path: str | os.PathLike, points: np.ndarray,
              colors: np.ndarray | None = None, binary: bool = True) -> None:
    """Write points (N, 3) [+ colors (N, 3) in [0,1]] as PCD v0.7."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    fields, sizes, types, counts = ["x", "y", "z"], [4, 4, 4], ["F"] * 3, [1] * 3
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if colors is not None:
        colors = np.asarray(colors)
        rgb = (
            (np.clip(colors[:, 0] * 255, 0, 255).astype(np.uint32) << 16)
            | (np.clip(colors[:, 1] * 255, 0, 255).astype(np.uint32) << 8)
            | np.clip(colors[:, 2] * 255, 0, 255).astype(np.uint32)
        )
        fields.append("rgb"); sizes.append(4); types.append("F"); counts.append(1)
        cols.append(rgb.view(np.float32))
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(map(str, sizes))}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(map(str, counts))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    rec = np.empty(n, dtype=np.dtype([(f, "<f4") for f in fields]))
    for f, c in zip(fields, cols):
        rec[f] = c
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(rec.tobytes())
        else:
            np.savetxt(fh, np.stack(cols, axis=1), fmt="%.8f")
