"""File IO: npz (synthetic-trees schema) and PLY clouds, linesets and meshes.

Counterpart of `smart_tree_tpu/data/file.py`: the npz schema is xyz / rgb /
medial_vector (legacy "vector") / class_l plus flattened skeleton arrays; the
PLY writers give the same bytes as the JAX package's. Readers for .pcd,
.xyz and .obj clouds are not ported.
"""

from __future__ import annotations

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
