"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process, all started together,
for sm_90a; the objects are linked into one shared library with a plain C
interface and loaded with ctypes. The build runs at first use, from the
sources in this package only, into `build/torch_kernels/` beside the
package (listed in .gitignore); the library's name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
not. Nothing here runs at import time: this module imports on hosts
without nvcc or a card.
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

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = ("slab_conv.cu", "fused_conv.cu", "radius_count.cu", "tracer.cu", "tiler.cu")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p, so ctypes does not
# cut 64-bit addresses to int
_SIGNATURES = {
    # feats, n, cin, rulebook, m, weights, cout, scratch, out, slab, blk, stream
    "st_slab_conv": [_P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P],
    # -> output rows per CTA
    "st_slab_conv_tile": [],
    # cin, cout -> bytes of weight-fragment scratch
    "st_slab_conv_scratch_bytes": [_I, _I],
    # feats, n, cin, rulebook, m, k3, weights, cout, out, stream
    "st_fused_conv": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P],
    # src, n, order, lo2, hi2, reach, keys, pts, m, ox, oy, oz, h, gx, gy, gz,
    # cap, certain, possible, stream
    "st_radius_count": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _I,
                        _I, _P, _P, _P],
    # pts, radii, jumps, levels, n, dist, allocated, branch_ids, path_branch,
    # path_pos, parents, max_branches, hop_cap, chain, path, pathv, win, hdr,
    # steps, stream
    "st_tracer_steps": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                        _P, _I, _P],
    # xyz, n, ids, blocks, block, half_block, half_halo, half_in, reach, origin, hdr,
    # stream
    "st_tile_bin": [_P, _L, _P, _I, _D, _D, _D, _D, _I, _P, _P, _P],
    # xyz, n, ids, blocks, block, half_block, half_halo, half_in, reach, origin, voxel,
    # side, bits, rows, count, start, rec, tmp, rank, ucount, vstart, key, first,
    # interior, hdr, stream
    "st_tile_sort": [_P, _L, _P, _I, _D, _D, _D, _D, _I, _P, _F, _I, _I, _L, _P, _P, _P, _P,
                     _P, _P, _P, _P, _P, _P, _P, _P],
    # table, slots, batch_size, rows, key, first, interior, vstart, side, origin, xyz,
    # voxel, step, bits, int8_res, out_key, out_res, out_interior, out_index,
    # out_origin, stream
    "st_tile_gather": [_P, _I, _I, _L, _P, _P, _P, _P, _I, _P, _P, _D, _D, _I, _I, _P, _P, _P,
                       _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a host with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if not built yet) and return the library path.
    The compiler's register and shared-memory report is kept beside the
    library in `ptxas.log`."""
    lib_path = _BUILD_DIR / f"libst_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        procs = []
        objs = []
        for name in _SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
            procs.append(
                (name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
            )
        logs = []
        failed = []
        for name, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        (_BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp_lib), *objs],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_lib, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(what: str, feats, weights) -> None:
    """The hand kernels are forward-only and take raw pointers: their result
    carries no autograd history. Raise rather than return a tensor whose
    gradient would silently be missing."""
    if needs_grad(feats, weights):
        raise RuntimeError(
            f"{what} has no backward: feats or weights require grad. Call it under "
            "torch.no_grad(), or go through core.sparse_ops.gather_conv, which "
            "differentiates through gather + matmul"
        )
