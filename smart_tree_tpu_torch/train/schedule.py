"""ReduceLROnPlateau: the host-side learning-rate controller (counterpart of
`smart_tree_tpu/train/schedule.py`; torch's semantics with mode=min,
factor=0.1, patience=10). The package's own class, because the checkpoint
carries its `state_dict` fields and both packages read each other's."""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        assert mode in ("min", "max")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1 - self.threshold)
        return value > self.best * (1 + self.threshold)

    def step(self, value: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) lr."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad = state["num_bad"]
