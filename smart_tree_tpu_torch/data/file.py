"""File IO: clouds in (npz, PLY, PCD, xyz / pts / txt, OBJ); npz skeletons and
PLY clouds, linesets and meshes out.

Counterpart of `smart_tree_tpu/data/file.py`: the npz schema is xyz / rgb /
medial_vector (legacy "vector") / class_l plus flattened skeleton arrays; the
PLY writers give the same bytes as the JAX package's. `load_cloud` also
reads .pcd (ascii, binary, LZF binary_compressed), .xyz / .pts / .txt and
.obj clouds (the JAX package's readers, ported), without open3d.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .branch import BranchSkeleton
from .cloud import Cloud
from .tree import TreeSkeleton

_NPZ_CLOUD_KEYS = (
    "xyz", "rgb", "vector", "medial_vector", "class_l",
    "branch_direction", "branch_ids",
)


def unpackage_data(data) -> Tuple[Cloud, Optional[TreeSkeleton]]:
    cld = Cloud.from_numpy(
        **{k: data[k] for k in data.files if k in _NPZ_CLOUD_KEYS}
    )
    skeleton = _skeleton_from_arrays(data) if "skeleton_xyz" in data.files else None
    return cld, skeleton


def _skeleton_from_arrays(data) -> TreeSkeleton:
    branch_id = np.asarray(data["branch_id"]).astype(int)
    parent_id = np.asarray(data["branch_parent_id"]).astype(int)
    skeleton_xyz = np.asarray(data["skeleton_xyz"])
    skeleton_radii = np.asarray(data["skeleton_radii"]).reshape(-1, 1)
    sizes = np.asarray(data["branch_num_elements"]).astype(int)
    offsets = np.cumsum(np.append([0], sizes))
    branches = {}
    for i, (_id, pid) in enumerate(zip(branch_id, parent_id)):
        sl = slice(offsets[i], offsets[i] + sizes[i])
        branches[int(_id)] = BranchSkeleton(
            int(_id), int(pid), skeleton_xyz[sl], skeleton_radii[sl]
        )
    return TreeSkeleton(int(data["tree_id"]) if "tree_id" in data.files else 0, branches)


def package_data(skeleton: TreeSkeleton, cloud: Cloud) -> dict:
    data = {
        "tree_id": skeleton._id,
        "xyz": np.asarray(cloud.xyz),
        "rgb": np.asarray(cloud.rgb) if cloud.rgb is not None else np.zeros_like(cloud.xyz),
        "medial_vector": np.asarray(cloud.medial_vector),
        "class_l": np.asarray(cloud.class_l),
    }
    if cloud.branch_ids is not None:
        data["branch_ids"] = np.asarray(cloud.branch_ids)
    if cloud.branch_direction is not None:
        data["branch_direction"] = np.asarray(cloud.branch_direction)
    data.update(_skeleton_arrays(skeleton))
    return data


def _skeleton_arrays(skeleton: TreeSkeleton) -> dict:
    branches = list(skeleton.branches.values())
    return {
        "skeleton_xyz": np.concatenate([b.xyz for b in branches]),
        "skeleton_radii": np.concatenate([b.radii for b in branches]),
        "branch_id": np.asarray([b._id for b in branches]),
        "branch_parent_id": np.asarray([b.parent_id for b in branches]),
        "branch_num_elements": np.asarray([len(b) for b in branches]),
    }


def save_data_npz(path, skeleton: TreeSkeleton, cloud: Cloud) -> None:
    np.savez_compressed(path, **package_data(skeleton, cloud))


def load_data_npz(path) -> Tuple[Cloud, Optional[TreeSkeleton]]:
    with np.load(path) as data:
        return unpackage_data(data)


def save_skeleton(path, skeleton: TreeSkeleton) -> None:
    np.savez(path, tree_id=skeleton._id, **_skeleton_arrays(skeleton))


def load_skeleton(path) -> TreeSkeleton:
    with np.load(path) as data:
        return _skeleton_from_arrays(data)


def save_ply_cloud(path, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if rgb is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if rgb is None:
            f.write(xyz.astype("<f4").tobytes())
        else:
            rgb8 = np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"], rec["rgb"] = xyz, rgb8
            f.write(rec.tobytes())


def save_ply_lineset(path, vertices: np.ndarray, edges: np.ndarray) -> None:
    vertices = np.asarray(vertices, np.float32)
    edges = np.asarray(edges, np.int32)
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
        f"element edge {len(edges)}",
        "property int vertex1", "property int vertex2",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(vertices.astype("<f4").tobytes())
        f.write(edges.astype("<i4").tobytes())


def save_ply_mesh(path, vertices: np.ndarray, triangles: np.ndarray,
                  vertex_colors: np.ndarray | None = None) -> None:
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(triangles)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if vertex_colors is None:
            f.write(vertices.astype("<f4").tobytes())
        else:
            c8 = np.clip(np.asarray(vertex_colors) * 255, 0, 255).astype(np.uint8)
            rec = np.zeros(len(vertices), dtype=[("v", "<f4", 3), ("c", "u1", 3)])
            rec["v"], rec["c"] = vertices, c8
            f.write(rec.tobytes())
        rec = np.zeros(len(triangles), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"], rec["idx"] = 3, triangles
        f.write(rec.tobytes())


def ply_element_counts(path) -> dict:
    """Element counts from a PLY header: {"vertex": n, "edge": n, ...}."""
    counts = {}
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        for line in f:
            parts = line.split()
            if parts and parts[0] == b"end_header":
                return counts
            if parts and parts[0] == b"element":
                counts[parts[1].decode()] = int(parts[2])
    raise ValueError(f"{path}: PLY header has no end_header")


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


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Pure-python libLZF decompressor (PCL's binary_compressed codec).

    Control byte < 32 -> literal run of ctrl+1 bytes; otherwise a back
    reference of (ctrl>>5)+2 bytes (+1 extension byte when the 3-bit length
    saturates) at offset ((ctrl&0x1f)<<8 | next)+1."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - (((ctrl & 0x1F) << 8) | data[i]) - 1
            i += 1
            for _ in range(length + 2):  # may overlap itself
                out.append(out[ref])
                ref += 1
    if len(out) != expected:
        raise ValueError(f"LZF: expected {expected} bytes, got {len(out)}")
    return bytes(out)


def load_pcd_cloud(path) -> Cloud:
    """PCD reader: ascii / binary / binary_compressed, PCL's packed-float
    rgb or separate r / g / b fields; NaN rows (organised clouds) dropped."""
    typemap = {
        ("F", 4): "<f4", ("F", 8): "<f8",
        ("I", 1): "i1", ("I", 2): "<i2", ("I", 4): "<i4", ("I", 8): "<i8",
        ("U", 1): "u1", ("U", 2): "<u2", ("U", 4): "<u4", ("U", 8): "<u8",
    }
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points, data_mode = 0, None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no DATA line in PCD header")
            parts = line.split()
            if not parts or parts[0] == b"#":
                continue
            key = parts[0].upper()
            if key == b"FIELDS":
                fields = [p.decode() for p in parts[1:]]
            elif key == b"SIZE":
                sizes = [int(p) for p in parts[1:]]
            elif key == b"TYPE":
                types = [p.decode() for p in parts[1:]]
            elif key == b"COUNT":
                counts = [int(p) for p in parts[1:]]
            elif key == b"POINTS":
                n_points = int(parts[1])
            elif key == b"WIDTH" and n_points == 0:
                n_points = int(parts[1])
            elif key == b"HEIGHT" and n_points and int(parts[1]) > 1:
                pass  # POINTS (or WIDTH*HEIGHT) already captured
            elif key == b"DATA":
                data_mode = parts[1].decode()
                break
        if not counts:
            counts = [1] * len(fields)
        names, dts = [], []
        for name, size, t, cnt in zip(fields, sizes, types, counts):
            for c in range(cnt):
                names.append(name if cnt == 1 else f"{name}_{c}")
                dts.append(typemap[(t, size)])
        dtype = np.dtype(list(zip(names, dts)))

        if data_mode == "ascii":
            rec = np.loadtxt(f, dtype=dtype, max_rows=n_points)
            rec = np.atleast_1d(rec)
        elif data_mode == "binary":
            rec = np.frombuffer(
                f.read(dtype.itemsize * n_points), dtype=dtype, count=n_points
            )
        elif data_mode == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(f.read(8), "<u4")
            raw = _lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
            # compressed PCD stores fields SoA: all x, then all y, ...
            rec = np.empty(n_points, dtype=dtype)
            off = 0
            for name, dt in zip(names, dts):
                itemsize = np.dtype(dt).itemsize
                rec[name] = np.frombuffer(
                    raw[off : off + itemsize * n_points], dtype=dt
                )
                off += itemsize * n_points
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode}")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    finite = np.isfinite(xyz).all(axis=1)  # organized clouds pad with NaN
    rgb = None
    if "rgb" in names or "rgba" in names:
        key = "rgb" if "rgb" in names else "rgba"
        packed = rec[key]
        if packed.dtype.kind == "f":  # PCL packs bytes into a float
            packed = packed.view(np.uint32)
        rgb = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], axis=1
        ).astype(np.float32) / 255.0
    elif {"r", "g", "b"} <= set(names):
        rgb = np.stack([rec["r"], rec["g"], rec["b"]], axis=1).astype(np.float32)
        if rec["r"].dtype == np.uint8:
            rgb /= 255.0
    if rgb is None:
        rgb = np.zeros_like(xyz)  # zero rgb when absent
    return Cloud(xyz=xyz[finite], rgb=rgb[finite])


def _cloud_from_columns(cols: np.ndarray) -> Cloud:
    """xyz [+ rgb] from a float column matrix (shared by .xyz/.pts/.obj).
    Trailing columns beyond 3 are treated as rgb when there are >= 3 of
    them (last 3 taken, so `x y z i r g b` .pts rows work); 0-255 colors
    are normalized."""
    xyz = cols[:, :3].astype(np.float32)
    rgb = None
    if cols.shape[1] >= 6:
        rgb = cols[:, -3:].astype(np.float32)
        if rgb.size and rgb.max() > 1.0:
            rgb = rgb / 255.0
    if rgb is None:
        rgb = np.zeros_like(xyz)  # zero rgb when absent
    finite = np.isfinite(xyz).all(axis=1)
    return Cloud(xyz=xyz[finite], rgb=rgb[finite])


def load_xyz_cloud(path) -> Cloud:
    """Whitespace-separated `x y z [r g b]` rows (.xyz / .pts; a leading
    bare point-count line, common in .pts, is skipped)."""
    with open(path) as f:
        first = f.readline().split()
        skip = 1 if len(first) == 1 else 0
    cols = np.loadtxt(path, dtype=np.float64, skiprows=skip, ndmin=2)
    return _cloud_from_columns(cols)


def load_obj_cloud(path) -> Cloud:
    """Vertex positions (+ per-vertex colors when present) from a Wavefront
    .obj; faces, normals and texture coordinates are skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                rows.append([float(t) for t in line.split()[1:7]])
    if not rows:
        return Cloud(xyz=np.zeros((0, 3), np.float32),
                     rgb=np.zeros((0, 3), np.float32))
    width = min(len(r) for r in rows)
    cols = np.asarray([r[:width] for r in rows], np.float64)
    return _cloud_from_columns(cols)


def load_cloud(path) -> Cloud:
    """Load a .npz (synthetic-trees schema), .ply, .pcd, .xyz / .pts / .txt
    or .obj cloud. Any other suffix raises ValueError: the port does not read
    through open3d."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            cld = Cloud.from_numpy(**{k: data[k] for k in data.files})
    elif path.suffix == ".ply":
        cld = load_ply_cloud(path)
    elif path.suffix == ".pcd":
        cld = load_pcd_cloud(path)
    elif path.suffix in (".xyz", ".pts", ".txt"):
        cld = load_xyz_cloud(path)
    elif path.suffix == ".obj":
        cld = load_obj_cloud(path)
    else:
        raise ValueError(
            f"unsupported cloud format {path.suffix} (npz/ply/pcd/xyz/"
            "pts/obj are built in; others need open3d)"
        )
    cld.filename = path
    return cld


def load_json(path):
    with open(path) as f:
        return json.load(f)
