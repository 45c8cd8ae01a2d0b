"""Single-tree overfit probe for the training path (counterpart of
`tools/overfit_probe.py`).

If a few hundred steps on ONE tree cannot drive the in-sample direction
cosine near 1, the training machinery (loss plumbing, normalisation, batch
norms) is broken and no amount of data will fix it; if they can, direction
quality is a data / generalisation problem. Prints the per-head losses every
`--log-every` steps (direction loss = mean(1 - cos) over branch voxels).

    python -m smart_tree_tpu_torch.tools.overfit_probe --steps 400

Runs on the card; `--device cpu` runs the plain PyTorch versions on the CPU.
The JAX tool steps a data-parallel replica on every device of its mesh, each
with the same batch; this one steps one device, which is the same update.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..data.dataset import collate, voxelize_host
from ..data.synthetic import generate_tree
from ..device import resolve_device
from ..nn.convert import load_model
from ..nn.model import SmartTree
from ..train.step import StepConfig, TrainState, train_step
from ..train.train import encode_targets

VOXEL = 0.01
# the weights' seed when none are given: the JAX tool initialises from
# PRNGKey(0) whatever its --seed, which picks the tree only
INIT_SEED = 0


def labelled(cloud) -> tuple:
    """(xyz [N, 3], targets [N, 5] = radius, direction, class) as fp32."""
    xyz = np.asarray(cloud.xyz, np.float32)
    targets = np.concatenate(
        [
            np.asarray(cloud.radius).reshape(-1, 1).astype(np.float32),
            np.asarray(cloud.direction).astype(np.float32),
            np.asarray(cloud.class_l).reshape(-1, 1).astype(np.float32),
        ],
        axis=1,
    )
    return xyz, targets


def initial_model(features: str, planes: Sequence[int] | None = None,
                  variables: Mapping[str, torch.Tensor] | None = None) -> SmartTree:
    """The probe's model on the CPU: `variables` (a state dict, e.g.
    `nn.convert.params_from_jax` of the JAX tool's `init_template`) when
    given, else default heads at `planes` from the seeded generator."""
    channels = 4 if features == "local" else 3
    if variables is not None:
        model = load_model(variables, torch.device("cpu"))
        if model.input_channels != channels:
            raise ValueError(f"the variables take {model.input_channels} input channels, "
                             f"features {features!r} give {channels}")
        return model
    kw = {} if planes is None else {"unet_planes": tuple(planes)}
    return SmartTree(input_channels=channels, generator=torch.Generator().manual_seed(INIT_SEED),
                     **kw)


def device_batch(vb, device: torch.device) -> tuple:
    """One collated batch in the compressed encoding of the train step, with
    its leading device axis of 1, on `device`."""
    c16, res, orig = vb.compressed_xyz_upload()
    radius16, dir_cls8 = encode_targets(vb.targets)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)[None]).to(device)
                 for a in (c16, res, radius16, dir_cls8, vb.valid, orig))


def fetched(i: int, losses: Mapping[str, torch.Tensor], t0: float) -> dict:
    """Step i's losses as floats, and the seconds since t0 read after the
    fetch (which waits for the step)."""
    out = {"step": i, **{k: float(v) for k, v in losses.items()}}
    out["seconds"] = time.time() - t0
    return out


def logged(i: int, steps: int, log_every: int) -> bool:
    return i % log_every == 0 or i == steps - 1


def line(rec: dict) -> str:
    return (f"step {rec['step']:4d}  radius {rec['radius']:.4f}  "
            f"direction {rec['direction']:.4f} (cos {1 - rec['direction']:.3f})  "
            f"class {rec['class_l']:.4f}  [{rec['seconds']:.1f}s]")


def run(steps: int = 400, lr: float = 0.05, seed: int = 0, capacity: int = 65536,
        log_every: int = 25, fp16: bool = False, features: str = "xyz",
        direction_loss: str = "cosine", variables=None, device=None,
        echo: Callable[[str], None] | None = None) -> list:
    """Train `steps` Adam steps on the seed's tree; every step's losses, as
    {"step", "radius", "direction", "class_l", "seconds"}. `echo`, when
    given, receives the tool's lines (the tree's size, then every logged
    step)."""
    device = resolve_device(device)
    cloud, _ = generate_tree(seed=seed, height=8.0, trunk_radius=0.15,
                             points_per_m2=4000.0, foliage_points=4000)
    xyz, targets = labelled(cloud)
    coords, data, origin = voxelize_host(xyz, np.concatenate([xyz, targets], 1), VOXEL)
    if echo:
        echo(f"tree: {len(xyz)} pts -> {len(coords)} voxels")
    vb = collate([(coords, data[:, :3], data[:, 3:], "probe", origin)], 1,
                 capacity=capacity, voxel_size=VOXEL)
    state = TrainState(initial_model(features, variables=variables).to(device), lr=lr)
    sc = StepConfig(
        spatial_shape=vb.spatial_shape, device_batch=1,
        compute_dtype=torch.bfloat16 if fp16 else torch.float32,
        voxel_size=VOXEL, direction_loss=direction_loss, feature_mode=features,
    )
    batch = device_batch(vb, device)
    records = []
    t0 = time.time()
    for i in range(steps):
        records.append(fetched(i, train_step(state, batch, sc), t0))
        if echo and logged(i, steps, log_every):
            echo(line(records[-1]))
    return records


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=65536)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--fp16", action="store_true")
    ap.add_argument("--features", default="xyz", choices=["xyz", "local"])
    ap.add_argument("--direction-loss", default="cosine", choices=["cosine", "l2raw"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    run(steps=args.steps, lr=args.lr, seed=args.seed, capacity=args.capacity,
        log_every=args.log_every, fp16=args.fp16, features=args.features,
        direction_loss=args.direction_loss, device=args.device,
        echo=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
