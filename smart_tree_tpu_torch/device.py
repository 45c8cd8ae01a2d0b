"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and no
    card is visible, so a run never carries on quietly on the CPU.

    On a card it also switches TF32 off for matmul and cuDNN: fp32 products
    must be fp32. TF32 keeps about three decimal digits, and the K = 3
    distance products of the KNN lose the true neighbour outright with it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
