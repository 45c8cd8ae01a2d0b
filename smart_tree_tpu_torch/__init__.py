"""smart-tree in PyTorch and CUDA for NVIDIA Hopper (H100, sm_90a).

A port of `smart_tree_tpu` (JAX on TPU), which stays beside it as the
reference. This package imports torch and numpy only. The sub-package and
module names follow the JAX package (`core/`, `nn/`, `data/`, `infer/`,
`neighbors/`, `graph/`, `skeleton/`, `viz/`, `utils/`) so each counterpart is
easy to find.

Entry points (`cli.main`, `infer.pipeline.Pipeline`,
`infer.inference.ModelInference`, `skeleton.skeletonize.Skeletonizer`, the
kernel wrappers in `core.slab_conv` and `core.fused_conv`) run on `cuda`
unless the caller asks for `device="cpu"`; with no card and no CPU request
they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
