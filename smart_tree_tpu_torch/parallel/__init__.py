"""Several devices: block-parallel inference and data-parallel training
(counterpart of `smart_tree_tpu/parallel/`)."""

from .block_infer import (ShardedForward, device_groups, stack_device_batches,
                          stack_device_batches_compact)
from .dp import dp_eval_step, dp_train_step
from .mesh import make_devices, spawn_world, world

__all__ = [
    "ShardedForward",
    "device_groups",
    "dp_eval_step",
    "dp_train_step",
    "make_devices",
    "spawn_world",
    "stack_device_batches",
    "stack_device_batches_compact",
    "world",
]
