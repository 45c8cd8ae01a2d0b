"""Cloud file input: .npz (synthetic-trees schema) and .ply.

Counterpart of the cloud readers in `smart_tree_tpu/data/file.py`
(`unpackage_data`, `load_data_npz`, `load_ply_cloud`, `load_cloud`). The
skeleton arrays of an npz are not read yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .cloud import Cloud

_NPZ_CLOUD_KEYS = (
    "xyz", "rgb", "vector", "medial_vector", "class_l",
    "branch_direction", "branch_ids",
)


def unpackage_data(data) -> Cloud:
    return Cloud.from_numpy(
        **{k: data[k] for k in data.files if k in _NPZ_CLOUD_KEYS}
    )


def load_data_npz(path) -> Cloud:
    with np.load(path) as data:
        return unpackage_data(data)


def load_ply_cloud(path) -> Cloud:
    """Minimal PLY point reader: binary_little_endian or ascii, float
    x/y/z and optional uchar/float rgb (zero rgb when absent)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"format":
                fmt = parts[1].decode()
            elif parts[0] == b"element":
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == b"property" and in_vertex:
                if parts[1] == b"list":
                    raise ValueError("list property in vertex element unsupported")
                props.append((parts[2].decode(), parts[1].decode()))
        typemap = {
            "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
            "uint": "<u4", "uint32": "<u4",
        }
        dtype = np.dtype([(name, typemap[t]) for name, t in props])
        if fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype,
                                count=n_vertex)
        elif fmt == "ascii":
            rec = np.loadtxt(f, dtype=dtype, max_rows=n_vertex)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    if {"red", "green", "blue"} <= set(rec.dtype.names):
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1).astype(np.float32)
        if rec["red"].dtype == np.uint8:
            rgb /= 255.0
    else:
        rgb = np.zeros_like(xyz)
    return Cloud(xyz=xyz, rgb=rgb)


def load_cloud(path) -> Cloud:
    """Load a .npz or .ply cloud."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            cld = Cloud.from_numpy(**{k: data[k] for k in data.files})
    elif path.suffix == ".ply":
        cld = load_ply_cloud(path)
    else:
        raise ValueError(f"unsupported cloud format {path.suffix} (npz and ply are ported)")
    cld.filename = path
    return cld
