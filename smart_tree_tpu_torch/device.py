"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

_cpu_math_settled = False


def settle_cpu_math() -> None:
    """Give torch's CPU vector math its first call on one thread, once per
    process, and check that a root computed in parallel is then exact.

    torch takes sqrt, exp, log and the like of a float32 CPU tensor through
    MKL's vector math library, in chunks of at least 2048 elements, one per
    OpenMP thread. The library picks its code on its first call in a
    process, and a thread that enters it while another is still picking
    computes its whole chunk with a 12-bit estimate (sqrt as x * rsqrt(x),
    up to 3.7e-4 relative): a KNN distance off by 1.5e-4 m. A call on one
    element runs on the calling thread alone and settles the pick for every
    later call."""
    global _cpu_math_settled
    if _cpu_math_settled:
        return
    torch.sqrt(torch.ones(1))
    x = torch.linspace(0.5, 2.0, 1 << 15)
    root = torch.sqrt(x).double()  # in chunks, one per thread
    err = float(((root * root - x.double()).abs() / x.double()).max())
    if err > 4.8e-7:  # 2 ulps of the root, squared
        raise RuntimeError(f"torch.sqrt on the CPU is off by {err:.3g} relative even after "
                           "a first call on one thread; the KNN distances would be too")
    _cpu_math_settled = True


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and no
    card is visible, so a run never carries on quietly on the CPU.

    On a card it also switches TF32 off for matmul and cuDNN: fp32 products
    must be fp32. TF32 keeps about three decimal digits, and the K = 3
    distance products of the KNN lose the true neighbour outright with it.
    On the CPU it settles the vector math (`settle_cpu_math`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        settle_cpu_math()
    elif dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
