"""The weights a configuration serves, as one checkpoint file that the
program's loader and the plain reference both read.

  "weights": "<path>"        a checkpoint of the repository, read as data
  "weights": {"seed": <n>}   drawn by the architecture's `draw(model, n)`
                             (arch/<arch>.py) and written once to
                             build/benchmark_weights/ of the checkout,
                             keyed by the configuration's name, the seed and
                             a hash of its `model` section and the
                             architecture's source; later runs read it back

The seed sits in the configuration's file, so every run of a cell serves
the same model; the traffic alone follows `--seed`.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from pathlib import Path

import numpy as np

from . import spec


def weights_cache(root):
    """The checkout's directory for drawn weights (build/, beside the pools)."""
    return Path(root) / "build" / "benchmark_weights"


def weights_path(cfg, root=spec.ROOT):
    """The checkpoint file of configuration `cfg` (its file's dict) in the
    checkout `root`, drawn and written first where it is a seeded draw that
    no earlier run of the checkout left."""
    w = cfg["weights"]
    if isinstance(w, str):
        return spec.ROOT / w
    seed = int(w["seed"])
    model = cfg["model"]
    arch = spec.arch_module(spec.arch_name(model), root)
    h = hashlib.sha256(json.dumps(model, sort_keys=True).encode())
    h.update(Path(arch.__file__).read_bytes())
    path = weights_cache(root) / f"{cfg['name']}.{seed}.{h.hexdigest()[:16]}.npz"
    if not path.exists():
        arrays = {k: np.asarray(v, np.float32) for k, v in arch.draw(model, seed).items()}
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".part")
        _write_npz(tmp, arrays)
        os.replace(tmp, path)
    return path


def _write_npz(path, arrays):
    """An `.npz` whose bytes follow from the arrays alone (np.savez stamps
    each member with the time of writing)."""
    with zipfile.ZipFile(path, "w") as z:
        for k, v in arrays.items():
            with z.open(zipfile.ZipInfo(f"{k}.npy", date_time=(1980, 1, 1, 0, 0, 0)), "w",
                        force_zip64=True) as f:
                np.lib.format.write_array(f, v, allow_pickle=False)
