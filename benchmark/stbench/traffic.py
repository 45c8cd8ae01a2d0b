"""A traffic mix's pool of clouds, made from the run's seed.

The mix's file fixes the clouds (the generator, its parameters and its own
seed), so every run carries the same work in the same order; the run's seed
shuffles the order of each cloud's points. The program keeps the first
point of each voxel, so each seed hands it other points, other input
features and other medial predictions over the same voxels, blocks and
batches: new inputs of the same sizes. (Turning the clouds instead moved
the blocks, and with them the work, by several per cent from seed to seed.)

The generator's clouds depend on the mix alone, so a run keeps them in a
cache directory of the checkout (`make_pool(cache_dir=)`), keyed by the
generator's parameters and the source of this file and the generator, and
only the first run of a mix in a checkout makes them.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from . import generator


def _trees(p):
    return [(xyz, rgb) for xyz, rgb, _ in generator.tree_draws(
        p["tree_seed"], p["trees"], p["points_per_m2"], p["foliage_points"])]


def _forest(p):
    return [generator.make_forest(p["trees"], p["points_per_m2"], p["forest_seed"],
                                  p["foliage_points"])]


# generator: (function of the mix, the mix's keys it reads)
GENERATORS = {"trees": (_trees, ("tree_seed", "trees", "points_per_m2", "foliage_points")),
              "forest": (_forest, ("forest_seed", "trees", "points_per_m2",
                                   "foliage_points"))}


def _key(mix):
    _, keys = GENERATORS[mix["generator"]]
    h = hashlib.sha256(json.dumps({k: mix[k] for k in ("generator",) + keys},
                                  sort_keys=True).encode())
    for src in (__file__, generator.__file__):
        h.update(Path(src).read_bytes())
    return h.hexdigest()[:20]


def generated(mix, cache_dir=None):
    """[(xyz, rgb)] as the mix's generator makes them, read from
    `cache_dir` where an earlier run left them there."""
    make, _ = GENERATORS[mix["generator"]]
    if cache_dir is None:
        return make(mix)
    path = Path(cache_dir) / f"{mix['generator']}-{_key(mix)}.npz"
    if path.exists():
        with np.load(path) as f:
            return [(f[f"xyz{i}"], f[f"rgb{i}"]) for i in range(int(f["n"]))]
    clouds = make(mix)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".part")
    with open(tmp, "wb") as f:
        np.savez(f, n=len(clouds), **{f"{a}{i}": c[j] for i, c in enumerate(clouds)
                                       for j, a in enumerate(("xyz", "rgb"))})
    os.replace(tmp, path)
    return clouds


def make_pool(mix, seed, cache_dir=None):
    """[(xyz float32 [N,3], rgb float32 [N,3])] of `mix` under `seed`,
    centred."""
    rng = np.random.default_rng(seed)
    pool = []
    for xyz, rgb in generated(mix, cache_dir):
        order = rng.permutation(len(xyz))
        pool.append((generator.centre(xyz[order]), rgb[order]))
    return pool
