"""Loss tracking and a pluggable metrics sink (counterpart of
`smart_tree_tpu/train/tracker.py`): metrics always go to the Python logger,
and to wandb when it is importable and configured (`mode != "disabled"`).
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict

import numpy as np

log = logging.getLogger(__name__)


class Tracker:
    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._count = 0

    def update(self, losses: Dict[str, float]) -> None:
        for k, v in losses.items():
            self._sums[k] += float(v)
        self._count += 1

    @property
    def means(self) -> Dict[str, float]:
        c = max(self._count, 1)
        return {k: v / c for k, v in self._sums.items()}

    @property
    def total_loss(self) -> float:
        return float(sum(self.means.values()))

    def log(self, prefix: str, epoch: int, sink=None) -> Dict[str, float]:
        means = self.means
        msg = " ".join(f"{k}={v:.4f}" for k, v in means.items())
        log.info("[%s] epoch %d: %s total=%.4f", prefix, epoch, msg, self.total_loss)
        if sink is not None:
            sink.log({f"{prefix}/{k}": v for k, v in means.items()}, step=epoch)
        return means


class MetricsSink:
    """wandb-compatible sink; degrades to logging when wandb is missing."""

    def __init__(self, project=None, entity=None, mode="disabled", run_name=None):
        self._wandb = None
        self._run_name = run_name
        if mode != "disabled":
            try:  # pragma: no cover - optional dependency
                import wandb

                wandb.init(project=project, entity=entity, mode=mode, name=run_name)
                self._wandb = wandb
            except Exception as e:  # pragma: no cover
                log.warning("wandb unavailable (%s); logging to stdout only", e)

    @property
    def run_name(self) -> str:
        if self._wandb is not None and self._wandb.run is not None:
            return self._wandb.run.name
        return self._run_name or "local-run"

    def log(self, metrics: Dict[str, float], step: int | None = None) -> None:
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)
        else:
            log.debug("metrics %s: %s", step, metrics)

    def log_cloud(self, key: str, xyz, rgb=None, step: int | None = None) -> None:
        """Upload a 3D point cloud. No-op without wandb: the PNG captures in
        the run dir are the offline substitute."""
        if self._wandb is None:  # pragma: no cover - optional dependency
            return
        pts = np.asarray(xyz, np.float32)
        if rgb is not None:
            rgb255 = np.clip(np.asarray(rgb, np.float32) * 255, 0, 255)
            pts = np.concatenate([pts, rgb255], axis=1)
        self._wandb.log({key: self._wandb.Object3D(pts)}, step=step)
