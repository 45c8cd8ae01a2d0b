"""How often the first CPU root of a process misses the exact one, and the
fingerprint of such a miss (CPU only).

    python3 -m smart_tree_tpu_torch.scripts.first_root_race [--children 200]
    PYTHONPATH=OTHER python3 smart_tree_tpu_torch/scripts/first_root_race.py
    python3 -m smart_tree_tpu_torch.scripts.first_root_race --fingerprint

The first two forms import torch and the port (this tree's, or OTHER's, a
`git archive` of another commit) and touch no torch math, then fork
children one at a time. Each child's first torch math is one of
  sqrt     torch.sqrt of 11,200 fp32 values (6 chunks of 1,867 at 8 threads)
  settled  the same after `device.settle_cpu_math` where the port has it,
           else after a one-element torch.sqrt
  knn      the port's knn on tests/test_torch_knn.py's first case (700
           sources, 900 destinations, k 16, r 0.6)
held against float64: the roots to 2 fp32 ulps, the KNN distances as
tests/test_torch_knn_exact.py holds them. Prints one JSON line: per mode the
children that missed and the worst error over its bound.

--fingerprint builds x * rsqrtps(x), the SSE 12-bit reciprocal-root
estimate, with gcc and puts it in place of the root on chunks 1 and 2 of
the 6 that torch splits knn's 700 x 16 distances into on 8 threads, for that
same case: it prints the mismatch count at rtol 1e-6 and the largest
absolute and relative differences, the three numbers a failing run reports.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch

from smart_tree_tpu_torch import device

knn_mod = importlib.import_module("smart_tree_tpu_torch.neighbors.knn")

ROOTS = np.random.default_rng(0).uniform(1e-3, 0.36, 11200).astype(np.float32)
_ESTIMATE_C = r"""
#include <immintrin.h>
void estimate(const float *x, float *y, long n) {
    for (long i = 0; i < n; i++) {
        __m128 v = _mm_set1_ps(x[i]);
        y[i] = _mm_cvtss_f32(_mm_mul_ps(v, _mm_rsqrt_ps(v)));
    }
}
"""


def _case():
    """tests/test_torch_knn.py's first case: two unit-normal clouds."""
    return tuple(np.random.default_rng(s).normal(size=(n, 3)).astype(np.float32)
                 for s, n in ((1, 700), (2, 900)))


def _root_error(y) -> float:
    exact = np.sqrt(ROOTS.astype(np.float64))
    return float((np.abs(y.astype(np.float64) - exact) / exact).max())


def _child(mode: str) -> float:
    """The child's first torch math; its worst error over the bound (> 1 a miss)."""
    if mode == "knn":
        src, dst = _case()
        d, i = (t.numpy() for t in knn_mod.knn(torch.from_numpy(src), torch.from_numpy(dst),
                                                16, 0.6, device="cpu"))
        hit = i >= 0
        diff = src.astype(np.float64)[:, None] - dst.astype(np.float64)[np.maximum(i, 0)]
        exact = np.sqrt((diff * diff).sum(-1))[hit]
        atol = 2 * float(np.spacing(np.float32(max(np.abs(src).max(), np.abs(dst).max()))))
        return float((np.abs(d[hit] - exact) / (2.4e-7 * exact + atol)).max())
    if mode == "settled":
        getattr(device, "settle_cpu_math", lambda: torch.sqrt(torch.ones(1)))()
    return _root_error(torch.sqrt(torch.from_numpy(ROOTS)).numpy()) / 2.4e-7


def race(children: int) -> dict:
    out = {}
    for mode in ("sqrt", "settled", "knn"):
        missed, worst = 0, 0.0
        for _ in range(children):
            r, w = os.pipe()
            pid = os.fork()
            if pid == 0:
                os.close(r)
                try:
                    os.write(w, repr(_child(mode)).encode())
                except BaseException:
                    traceback.print_exc()
                    os._exit(1)
                os._exit(0)
            os.close(w)
            with os.fdopen(r) as f:
                text = f.read()
            if os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) != 0:
                raise RuntimeError(f"a {mode} child failed")
            over = float(text)
            missed += over > 1
            worst = max(worst, over)
        out[mode] = {"children": children, "missed": missed, "worst_over_bound": worst}
    return out


def fingerprint() -> dict:
    src, dst = _case()
    d, i = knn_mod.knn(torch.from_numpy(src), torch.from_numpy(dst), 16, 0.6, device="cpu")
    # the squared distances the port takes the root of, computed as it does
    s, t, _ = knn_mod._centre(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.ones(900, dtype=torch.bool))
    diff = s[:, None, :] - t[i.clamp_min(0)]
    d2 = (diff * diff).sum(dim=2).numpy().ravel().copy()
    with tempfile.TemporaryDirectory() as tmp:
        c, so = Path(tmp) / "estimate.c", Path(tmp) / "estimate.so"
        c.write_text(_ESTIMATE_C)
        subprocess.run(["gcc", "-O1", "-msse", "-shared", "-fPIC", str(c), "-o", str(so)],
                       check=True)
        est = np.empty_like(d2)
        ctypes.CDLL(str(so)).estimate(d2.ctypes.data_as(ctypes.c_void_p),
                                      est.ctypes.data_as(ctypes.c_void_p),
                                      ctypes.c_long(d2.size))
    actual = d.numpy().ravel().copy()
    size = -(-actual.size // 6)   # at::parallel_for's chunks at grain 2048 on 8 threads
    actual[size : 3 * size] = est[size : 3 * size]
    hit = i.numpy().ravel() >= 0
    a, e = actual[hit], d.numpy().ravel()[hit]
    bad = ~np.isclose(a, e, rtol=1e-6, atol=0)
    diff = np.abs(a.astype(np.float64) - e)
    return {"distances": int(hit.sum()), "mismatched": int(bad.sum()),
            "max_abs": float(diff[bad].max()), "max_rel": float((diff / e)[bad].max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--children", type=int, default=200, help="children per mode")
    ap.add_argument("--fingerprint", action="store_true")
    args = ap.parse_args(argv)
    result = fingerprint() if args.fingerprint else race(args.children)
    print(json.dumps({"port": str(Path(knn_mod.__file__).parents[2]), "threads":
                      torch.get_num_threads(), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
