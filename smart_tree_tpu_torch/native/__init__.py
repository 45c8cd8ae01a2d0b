"""Native host runtime: `st_native.cpp` built with g++ and bound with ctypes.

Counterpart of `smart_tree_tpu/native/__init__.py`, with the same entry
points and signatures (`voxelize`, `cube_filter`, `block_ids`) over the
port's own copy of the C++ source, and one of its own: `tile_blocks`, the
tiler's halo binning in one pass over the points. Differences by design:

  - the library is built at first use into `build/torch_native/` beside the
    package (git-ignored). Its name carries a hash of the source, the flags
    and the target g++ resolves `-march=native` to, so a library built on
    one host is never loaded on another. The build writes a temporary file
    and `os.replace`s it into place, so processes that build at once each
    leave a whole library;
  - a failed build RAISES: the main path (`data/dataset.py::voxelize_host`)
    never falls back to numpy quietly, and there is no switch to turn the
    library off. The numpy versions below (`voxelize_plain`,
    `block_ids_plain`, `tile_blocks_plain`; `utils/maths.py::cube_filter`)
    are the plain versions the tests hold the library against.

Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.maths import cube_filter as cube_filter_plain

_SRC = Path(__file__).resolve().with_name("st_native.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
# no fused multiply-add: st_tile_blocks rounds each face as numpy does
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    # xyz, n, voxel, origin, out_coords, out_first -> occupied voxels
    "st_voxelize": [_F, ctypes.c_int64, ctypes.c_float, _F, _I32, _I64],
    # xyz, n, centre, size, out_mask -> points inside
    "st_cube_filter": [_F, ctypes.c_int64, _F, ctypes.c_float, _U8],
    # xyz, n, block_size, out_ids, out_block_coords -> blocks
    "st_block_ids": [_F, ctypes.c_int64, ctypes.c_float, _I64, _I32],
    # xyz, n, ids, blocks, block_size, buffer_size, out_offsets, out_rows
    # (null: count only), out_interior, out_tests -> rows
    "st_tile_blocks": [_F, ctypes.c_int64, _I64, ctypes.c_int64, ctypes.c_double,
                       ctypes.c_double, _I64, _I64, _U8, _I64],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: smart_tree_tpu_torch.native builds st_native.cpp with g++ "
            "at first use (the host dedup of data/dataset.py::voxelize_host needs it)"
        )
    return found


def _digest(gxx: str) -> str:
    """Hash of the source, the flags and the target `-march=native` means on
    this host (g++'s own answer)."""
    target = subprocess.run(
        [gxx, "-march=native", "-Q", "--help=target"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(target.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile st_native.cpp (if not built yet for this host) and return the
    library path. Raises RuntimeError with the compiler's output on failure."""
    gxx = _gxx()
    lib_path = _BUILD_DIR / f"libst_native_{_digest(gxx)}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int64
            _lib = lib
        return _lib


def _points(xyz) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"expected points of shape [N, 3], got {xyz.shape}")
    return xyz


def _vec3(v) -> np.ndarray:
    v = np.ascontiguousarray(v, np.float32).reshape(-1)
    if v.shape != (3,):
        raise ValueError(f"expected 3 values, got shape {v.shape}")
    return v


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def voxelize(xyz: np.ndarray, voxel: float, origin) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel dedup: (coords int32 [M,3] lexicographically sorted, first int64
    [M], the lowest original row of each voxel), as `voxelize_plain`."""
    lib = load()
    xyz, origin = _points(xyz), _vec3(origin)
    n = len(xyz)
    coords = np.empty((n, 3), np.int32)
    first = np.empty(n, np.int64)
    m = lib.st_voxelize(_ptr(xyz, _F), n, voxel, _ptr(origin, _F),
                        _ptr(coords, _I32), _ptr(first, _I64))
    if m < 0:
        raise RuntimeError(f"st_voxelize failed on {n} points")
    return coords[:m].copy(), first[:m].copy()


def cube_filter(xyz: np.ndarray, centre, size: float) -> np.ndarray:
    """Bool mask of the points inside the half-open cube centre +- size/2,
    compared in float32 (`utils/maths.py::cube_filter` on float32 inputs)."""
    lib = load()
    xyz, centre = _points(xyz), _vec3(centre)
    mask = np.empty(len(xyz), np.uint8)
    lib.st_cube_filter(_ptr(xyz, _F), len(xyz), _ptr(centre, _F), size, _ptr(mask, _U8))
    return mask.astype(bool)


def block_ids(xyz: np.ndarray, block_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 [N], block coords int32 [B,3]): floor(xyz / block_size) per
    point, blocks numbered in the order they are first seen."""
    lib = load()
    xyz = _points(xyz)
    n = len(xyz)
    ids = np.empty(n, np.int64)
    blocks = np.empty((n, 3), np.int32)
    m = lib.st_block_ids(_ptr(xyz, _F), n, block_size, _ptr(ids, _I64), _ptr(blocks, _I32))
    if m < 0:
        raise RuntimeError(f"st_block_ids failed on {n} points")
    return ids, blocks[:m].copy()


def _block_coords(ids) -> np.ndarray:
    ids = np.ascontiguousarray(ids, np.int64)
    if ids.ndim != 2 or ids.shape[1] != 3:
        raise ValueError(f"expected block ids of shape [B, 3], got {ids.shape}")
    return ids


def tile_blocks(xyz: np.ndarray, ids, block_size: float, buffer_size: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The halo rows of each block, in one pass over the points: (offsets
    int64 [B+1], rows int64, interior bool, point-box tests). Block b's rows
    are rows[offsets[b]:offsets[b+1]], the points inside the cube of side
    block_size + 2 * buffer_size around the block's centre ids[b] *
    block_size + block_size / 2, ascending; interior marks those inside the
    cube of side block_size. Equal to `tile_blocks_plain`, whose tests are
    points x blocks; here a test is one block looked up for a point whose
    every axis lies within that block's buffered faces."""
    lib = load()
    xyz, ids = _points(xyz), _block_coords(ids)
    block_size, buffer_size = float(block_size), float(buffer_size)
    if not block_size > 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    n, nb = len(xyz), len(ids)
    offsets = np.empty(nb + 1, np.int64)
    tests = np.zeros(1, np.int64)
    args = (_ptr(xyz, _F), n, _ptr(ids, _I64), nb, block_size, buffer_size,
            _ptr(offsets, _I64))
    total = lib.st_tile_blocks(*args, None, None, _ptr(tests, _I64))
    if total == -1:
        raise ValueError("block ids repeat")
    if total < 0:
        raise RuntimeError(f"st_tile_blocks failed on {n} points, {nb} blocks")
    rows = np.empty(total, np.int64)
    interior = np.empty(total, np.uint8)
    lib.st_tile_blocks(*args, _ptr(rows, _I64), _ptr(interior, _U8), None)
    return offsets, rows, interior.view(bool), int(tests[0])


def tile_blocks_plain(xyz: np.ndarray, ids, block_size: float, buffer_size: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """numpy version of `tile_blocks`: one cube filter of the whole cloud a
    block, and one of its rows for the interior."""
    xyz, ids = np.asarray(xyz, np.float32), _block_coords(ids)
    offsets, rows, interior = [0], [], []
    for centre in ids * block_size + block_size / 2:
        r = np.flatnonzero(cube_filter_plain(xyz, centre, block_size + 2 * buffer_size))
        rows.append(r)
        interior.append(cube_filter_plain(xyz[r], centre, block_size))
        offsets.append(offsets[-1] + len(r))
    return (np.asarray(offsets, np.int64), np.concatenate(rows or [np.zeros(0, np.int64)]),
            np.concatenate(interior or [np.zeros(0, bool)]), len(xyz) * len(ids))


def voxelize_plain(xyz: np.ndarray, voxel: float, origin) -> Tuple[np.ndarray, np.ndarray]:
    """numpy version of `voxelize` (np.unique(axis=0, return_index=True))."""
    g = np.floor((np.asarray(xyz, np.float32) - np.asarray(origin, np.float32)) / np.float32(voxel))
    coords, first = np.unique(g.astype(np.int32), axis=0, return_index=True)
    return coords, first.astype(np.int64)


def block_ids_plain(xyz: np.ndarray, block_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """numpy version of `block_ids`."""
    g = np.floor(np.asarray(xyz, np.float32) / np.float32(block_size)).astype(np.int32)
    if len(g) == 0:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.int32)
    _, first, inverse = np.unique(g, axis=0, return_index=True, return_inverse=True)
    seen = np.argsort(first, kind="stable")       # blocks in first-seen order
    rank = np.empty_like(seen)
    rank[seen] = np.arange(len(seen))
    return rank[inverse.reshape(-1)].astype(np.int64), g[first[seen]]
