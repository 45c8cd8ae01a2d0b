"""`train-smart-tree-torch`: the training entry point (counterpart of
`smart_tree_tpu/train/train.py`, same config surface, conf/training.yaml).

    python -m smart_tree_tpu_torch.train.train directory=data/trees \\
        json_path=data/trees/split.json num_epoch=20

Epoch loop with validation and test evaluation, ReduceLROnPlateau on the
validation loss, best-weights save, a full checkpoint every epoch (weights,
Adam moments, scheduler, epoch) that `resume=<dir>` continues from,
`warm_start=<weights.npz>`, early stop. Runs on the card unless `device=cpu`
is given; one device (training across cards is later work).

Without `--config=` the configuration is `utils.configs.DEFAULT_TRAINING`,
which a test holds equal to conf/training.yaml, so the entry point also works
on a host without PyYAML.
"""

from __future__ import annotations

import logging
import pickle
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import TreeDataset, collate, voxelize_host
from ..device import resolve_device
from ..nn.convert import load_npz, save_npz, variables_from_model
from ..nn.model import SmartTree
from ..utils.configs import (apply_overrides, default_training_config, instantiate, load_yaml,
                             resolve)
from .schedule import ReduceLROnPlateau
from .step import StepConfig, TrainState, batch_to_device, eval_step, train_step
from .tracker import MetricsSink, Tracker

log = logging.getLogger("smart_tree_tpu_torch.train")

# losses are fetched this many steps late, so the host prepares and enqueues
# the next steps while the device still works on the earlier ones
LOSS_FETCH_LAG = 4


def _pack_bins(sizes, budget: int, max_items: int):
    """Greedy first-fit-decreasing packing of item indices into bins under a
    voxel budget: batches fill the fixed capacity instead of wasting it as
    padding."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    bins = []
    for i in order:
        placed = False
        for b in bins:
            if len(b) < max_items and sum(sizes[j] for j in b) + sizes[i] <= budget:
                b.append(i)
                placed = True
                break
        if not placed:
            bins.append([i])
    return bins


def encode_targets(targets: np.ndarray):
    """(fp16 radius [..., 1], int8 direction * 127 and class [..., 4]) of
    fp32 targets [..., 5]."""
    radius16 = targets[..., 0:1].astype(np.float16)
    dir_cls8 = np.concatenate(
        [np.clip(np.round(targets[..., 1:4] * 127), -127, 127), targets[..., 4:5]],
        axis=-1,
    ).astype(np.int8)
    return radius16, dir_cls8


def _device_batches(dataset: TreeDataset, cfg, n_dev: int = 1, shuffle=True):
    """Yield [n_dev, cap, ...] stacked arrays in the compressed encoding
    (int16 coords, fp16 residual xyz, fp16 radius, int8 direction / class).
    Items are budget-packed: a window of voxelised items is bin-packed to the
    fixed capacity, so batches carry up to `batch_size` items and nearly no
    padding. `n_dev` is 1 on this package's single-device path; the stacking
    axis is kept so the arrays equal the reference's."""
    per_dev_items = max(cfg["batch_size"] // n_dev, 1)
    cap = int(cfg["batch_capacity"])
    voxel = float(cfg["voxel_size"])
    assert list(cfg["input_features"]) == ["xyz"], (
        "the compressed encoding holds xyz only; extend _device_batches for "
        f"other input_features ({cfg['input_features']})"
    )
    order = np.arange(len(dataset))
    if shuffle:
        dataset.rng.shuffle(order)

    window = 10 * per_dev_items * n_dev  # pack within a sliding window
    for wstart in range(0, len(order), window):
        items = [dataset.item(i) for i in order[wstart : wstart + window]]
        bins = _pack_bins([len(it[0]) for it in items], cap, per_dev_items)
        for bstart in range(0, len(bins), n_dev):
            group = bins[bstart : bstart + n_dev]
            while len(group) < n_dev:
                group.append(group[-1])  # repeat: shapes stay fixed
            subs = [
                collate([items[i] for i in b], per_dev_items, capacity=cap,
                        on_overflow="warn", voxel_size=voxel)
                for b in group
            ]
            comp = [s.compressed_xyz_upload() for s in subs]
            radius16, dir_cls8 = encode_targets(np.stack([s.targets for s in subs]))
            yield (
                np.stack([c[0] for c in comp]),            # coords i16
                np.stack([c[1] for c in comp]),            # res f16
                radius16,
                dir_cls8,
                np.stack([s.valid for s in subs]),         # doubles as mask
                np.stack([c[2] for c in comp]),            # origins f32
            )


def _prefetch(it, depth: int = 2):
    """Run a host-side batch iterator in a background thread so numpy
    augmentation and voxelisation overlap device compute."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(END)
        except BaseException as e:  # surface errors in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def run_epoch(state: TrainState, dataset, cfg, sc: StepConfig, device, train: bool,
              stats: dict | None = None) -> Tracker:
    """One pass over `dataset`. Logs where the host's time went: fetch
    (waiting for the batch thread), dispatch (upload and enqueueing the
    step) and device-wait (blocking on a loss). With a `stats` dict it also
    records those, the steps, the voxels and, on a card, the synchronised
    seconds per step after the first."""
    tracker = Tracker()
    step_fn = train_step if train else eval_step
    batches = _prefetch(_device_batches(dataset, cfg, shuffle=train))
    pending = []  # small in-flight window: keeps dispatch ahead of the device
    t_fetch = t_dispatch = t_sync = 0.0
    n_steps = voxels = 0
    t_first = None
    while True:
        t0 = time.time()
        batch = next(batches, None)
        t_fetch += time.time() - t0
        if batch is None:
            break
        t0 = time.time()
        losses = step_fn(state, batch_to_device(batch, device), sc)
        t_dispatch += time.time() - t0
        n_steps += 1
        voxels += int(batch[4].sum())
        if stats is not None and n_steps == 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_first = time.time()
        pending.append(losses)
        if len(pending) > LOSS_FETCH_LAG:
            t0 = time.time()
            tracker.update({k: float(v) for k, v in pending.pop(0).items()})
            t_sync += time.time() - t0
    t0 = time.time()
    for losses in pending:
        tracker.update({k: float(v) for k, v in losses.items()})
    t_sync += time.time() - t0
    log.info(
        "  %s: %d steps, fetch %.1fs, dispatch %.1fs, device-wait %.1fs",
        "train" if train else "eval", n_steps, t_fetch, t_dispatch, t_sync,
    )
    if stats is not None:
        stats.update(
            steps=n_steps, voxels=voxels, fetch_s=t_fetch, dispatch_s=t_dispatch,
            device_wait_s=t_sync, total_loss=tracker.total_loss,
            step_s=(time.time() - t_first) / (n_steps - 1) if n_steps > 1 else None,
        )
    return tracker


def save_checkpoint(path: Path, state: TrainState, scheduler, epoch: int, best: float):
    """variables.npz (flax layout, reads in both packages) and
    train_state.pkl (numpy Adam moments, scheduler, epoch, best, step)."""
    path.mkdir(parents=True, exist_ok=True)
    save_npz(path / "variables.npz", variables_from_model(state.model))
    with open(path / "train_state.pkl", "wb") as f:
        pickle.dump(
            {
                "opt_state": state.optimizer_state(),
                "scheduler": scheduler.state_dict(),
                "epoch": epoch,
                "best": best,
                "step": int(state.step),
            },
            f,
        )


def build_model(model_cfg, seed: int = 0) -> SmartTree:
    """A freshly initialised SmartTree (on the CPU) from the `model` node."""
    return SmartTree(
        input_channels=model_cfg["input_channels"],
        unet_planes=tuple(model_cfg["unet_planes"]),
        radius_fc_planes=tuple(model_cfg["radius_fc_planes"]),
        direction_fc_planes=tuple(model_cfg["direction_fc_planes"]),
        class_fc_planes=tuple(model_cfg["class_fc_planes"]),
        generator=torch.Generator().manual_seed(int(seed)),
    )


def step_config(cfg, device_batch: int) -> StepConfig:
    return StepConfig(
        spatial_shape=tuple(cfg["spatial_shape"]),
        device_batch=device_batch,
        compute_dtype=torch.bfloat16 if cfg.get("fp16", False) else torch.float32,
        matmul_precision=cfg.get("matmul_precision", "float32"),
        voxel_size=float(cfg["voxel_size"]),
        direction_loss=cfg.get("direction_loss", "cosine"),
        feature_mode=cfg.get("feature_mode", "xyz"),
        direction_min_radius=cfg.get("direction_min_radius"),
    )


def load_config(argv):
    """The composed configuration of a command line: `--config=<yaml>` or
    the built-in default, then key=value overrides, then interpolation."""
    cfg = None
    overrides = []
    for a in argv:
        if a.startswith("--config="):
            cfg = load_yaml(Path(a.split("=", 1)[1]))
        else:
            overrides.append(a)
    cfg = apply_overrides(default_training_config() if cfg is None else cfg, overrides)
    return resolve(cfg, cfg)


def main(argv=None, stats: dict | None = None) -> int:
    """Train. `stats`, when given, receives {"epochs": [per-epoch records of
    run_epoch's numbers for train / val / test], "out_dir": run directory}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = load_config(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(cfg.get("device"))

    sink = MetricsSink(**cfg.get("wandb", {}))
    np.random.seed(cfg.get("seed", 1))

    train_ds: TreeDataset = instantiate(cfg["train_dataset"])
    val_ds: TreeDataset = instantiate(cfg["validation_dataset"])
    test_ds: TreeDataset = instantiate(cfg["test_dataset"])
    log.info("datasets: train=%d val=%d test=%d", len(train_ds), len(val_ds), len(test_ds))

    model = build_model(cfg["model"], cfg.get("seed", 1))
    scheduler = ReduceLROnPlateau(lr=cfg["lr"])

    out_dir = Path(cfg.get("output_dir", "runs")) / sink.run_name
    start_epoch = 0
    best_val = float("inf")
    opt_state = None
    step = 0
    resume = cfg.get("resume")
    if resume:
        ckpt = Path(resume)
        model.load_state_dict(load_npz(ckpt / "variables.npz"), strict=True)
        with open(ckpt / "train_state.pkl", "rb") as f:
            ts = pickle.load(f)
        opt_state, step = ts["opt_state"], ts["step"]
        scheduler.load_state_dict(ts["scheduler"])
        start_epoch = ts["epoch"] + 1
        best_val = ts["best"]
        log.info("resumed from %s at epoch %d", ckpt, start_epoch)
    elif cfg.get("warm_start"):
        # continue from a weights-only checkpoint (params and batch
        # statistics): fresh Adam moments and epoch counter, warm network
        model.load_state_dict(load_npz(cfg["warm_start"]), strict=True)
        log.info("warm-started params from %s", cfg["warm_start"])

    state = TrainState(model.to(device), lr=cfg["lr"], step=step)
    if opt_state is not None:
        state.load_optimizer_state(opt_state)
    sc = step_config(cfg, max(int(cfg["batch_size"]), 1))
    if stats is not None:
        stats.update(epochs=[], out_dir=str(out_dir))

    epochs_no_improve = 0
    for epoch in range(start_epoch, cfg["num_epoch"]):
        t0 = time.time()
        state.set_lr(scheduler.lr)  # the scheduler's lr goes into the optimizer
        rec = {"epoch": epoch, "train": {}, "val": {}, "test": {}} if stats is not None else {}
        tr = run_epoch(state, train_ds, cfg, sc, device, True, rec.get("train"))
        tr.log("train", epoch, sink)
        va = run_epoch(state, val_ds, cfg, sc, device, False, rec.get("val"))
        va.log("val", epoch, sink)
        te = run_epoch(state, test_ds, cfg, sc, device, False, rec.get("test"))
        te.log("test", epoch, sink)
        if stats is not None:
            stats["epochs"].append(rec)

        val_loss = va.total_loss if va._count else float("inf")
        scheduler.step(val_loss)
        if val_loss < best_val:
            best_val = val_loss
            epochs_no_improve = 0
            save_checkpoint(out_dir, state, scheduler, epoch, best_val)
            save_npz(out_dir / "best_weights.npz", variables_from_model(state.model))
            log.info("epoch %d: new best val %.4f -> %s", epoch, best_val, out_dir)
        else:
            epochs_no_improve += 1
        # always-current checkpoint: lets a run be stopped and resumed at the
        # LAST epoch, not the last validation improvement
        save_checkpoint(out_dir / "last", state, scheduler, epoch, best_val)
        log.info("epoch %d done in %.1fs (lr=%.2e)", epoch, time.time() - t0, scheduler.lr)

        if cfg.get("capture_output") and epoch % int(cfg["capture_output"]) == 0:
            try:
                capture_epoch(state, val_ds, cfg, out_dir, epoch, sink)
            except Exception as e:  # pragma: no cover - capture is best-effort
                log.warning("capture failed: %s", e)

        if cfg.get("early_stop", False) and epochs_no_improve >= cfg["early_stop_epoch"]:
            log.info("early stop at epoch %d", epoch)
            break
    return 0


def fit_smoke(cloud, steps: int = 6, capacity: int = 8192, lr: float = 0.01,
              planes=(8, 16, 32), voxel_size: float = 0.01, device=None, seed: int = 0):
    """Overfit a few train steps on ONE cloud and return the per-step total
    losses: a fast probe of the whole train path (the card against the CPU,
    or for bisecting training breakage). The weights come from `seed`."""
    device = resolve_device(device)
    xyz = np.asarray(cloud.xyz, np.float32)
    targets = np.concatenate(
        [
            np.asarray(cloud.radius).reshape(-1, 1).astype(np.float32),
            np.asarray(cloud.direction).astype(np.float32),
            np.asarray(cloud.class_l).reshape(-1, 1).astype(np.float32),
        ],
        axis=1,
    )
    coords, data, origin = voxelize_host(xyz, np.concatenate([xyz, targets], 1), voxel_size)
    vb = collate(
        [(coords, data[:, :3], data[:, 3:], "smoke", origin)], 1,
        capacity=capacity, voxel_size=voxel_size,
    )
    model = build_model(
        dict(input_channels=3, unet_planes=planes, radius_fc_planes=(planes[0], 4, 1),
             direction_fc_planes=(planes[0], 4, 3), class_fc_planes=(planes[0], 4, 2)),
        seed,
    )
    state = TrainState(model.to(device), lr=lr)
    sc = StepConfig(spatial_shape=vb.spatial_shape, device_batch=1, voxel_size=voxel_size)
    c16, res, orig = vb.compressed_xyz_upload()
    radius16, dir_cls8 = encode_targets(vb.targets)
    batch = batch_to_device(
        [a[None] for a in (c16, res, radius16, dir_cls8, vb.valid, orig)], device
    )
    losses = []
    for _ in range(steps):
        out = train_step(state, batch, sc)
        losses.append(float(sum(out.values())))
    return np.asarray(losses)


def capture_epoch(state: TrainState, dataset, cfg, out_dir: Path, epoch: int,
                  sink: MetricsSink | None = None) -> None:
    """Render predicted segmentation and medial views of one validation
    cloud into the run dir (PNG, needs PIL), and upload the clouds when wandb
    is live."""
    from ..core.plan import build_plan
    from ..core.sparse_tensor import SparseVoxelTensor
    from ..viz.render import Renderer

    model = state.model
    device = next(model.parameters()).device
    coords, feats, targets, name, origin = dataset.item(0)
    xyz_abs = feats[:, :3]
    if cfg.get("feature_mode", "xyz") == "local":
        voxel = float(cfg["voxel_size"])
        centre = origin[None, :] + (coords + 0.5) * voxel
        feats = np.concatenate(
            [(xyz_abs - centre) / voxel, xyz_abs[:, 1:2]], axis=1
        ).astype(np.float32)
    nfeat = feats.shape[1]
    feats = np.concatenate([feats, xyz_abs], axis=1)  # carry xyz for the render
    cap = int(cfg["batch_capacity"])
    n = min(len(coords), cap)
    if n < len(coords):
        log.warning(
            "capture_epoch: cloud %s has %d voxels > batch_capacity %d, "
            "rendering the first %d only", name, len(coords), cap, n,
        )
    cpad = np.full((cap, 4), -1, np.int32)
    cpad[:n, 0] = 0
    cpad[:n, 1:] = coords[:n]
    fpad = np.zeros((cap, feats.shape[1]), np.float32)
    fpad[:n] = feats[:n]
    with torch.no_grad():
        x = SparseVoxelTensor.from_coords(
            torch.from_numpy(cpad).to(device), torch.from_numpy(fpad).to(device),
            tuple(cfg["spatial_shape"]), 1,
            valid=torch.from_numpy(np.arange(cap) < n).to(device),
        )
        plan = build_plan(x, len(model.unet_planes))
        preds = model.eval()(plan, x.feats[:, :nfeat])
    active = x.active.cpu().numpy()
    xyz = x.feats[:, nfeat:].cpu().numpy()[active]
    cls = np.argmax(preds["class_l"].cpu().numpy()[active], axis=1)
    cmap = np.asarray(cfg.get("cmap", [[1, 0, 0], [0, 1, 0]]), np.float32)
    seg_rgb = cmap[np.clip(cls, 0, len(cmap) - 1)]
    medial = (xyz + np.exp(preds["radius"].cpu().numpy()[active])
              * preds["direction"].cpu().numpy()[active])
    r = Renderer(960, 540)
    cap_dir = out_dir / "captures"
    cap_dir.mkdir(parents=True, exist_ok=True)
    r.capture_to_file(cap_dir / f"epoch{epoch:04d}_seg.png", xyz, seg_rgb)
    r.capture_to_file(cap_dir / f"epoch{epoch:04d}_medial.png", medial)
    if sink is not None:
        sink.log_cloud("capture/seg", xyz, seg_rgb, step=epoch)
        sink.log_cloud("capture/medial", medial, step=epoch)
    log.info("captured %s (epoch %d)", name, epoch)


if __name__ == "__main__":
    raise SystemExit(main())
