"""Data-parallel train and eval steps.

Counterpart of `smart_tree_tpu/parallel/dp.py` (`make_dp_train_step`,
`make_dp_eval_step`). One process per device, in a process group: every
rank holds a full replica of the model and its Adam state, and takes its own
row of the [W, cap, ...] batch stack that every rank builds alike
(`train/train.py::_device_batches`), which is what shard_map's `P(axis)`
hands each device. The steps are `train/step.py`'s with the collectives of
the JAX step:

  - the batch norms sum their statistics over the group (build the model
    with `SmartTree(bn_group=...)`, nn/norm.py);
  - after the backward every gradient is summed over the ranks and divided
    by the world size (`pmean`), so every rank takes the same Adam step;
  - the losses are averaged the same way, so every rank logs, schedules and
    stops alike.

The gradient is that of the mean of the ranks' losses, the cross-rank terms
of the batch statistics included, as JAX's. With `group=None` the steps are
`train_step` and `eval_step` on row 0 of the stack.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from ..train.step import StepConfig, TrainState, compute_losses


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_size(group) -> int:
    """The number of ranks of `group`; 1 for no group."""
    return 1 if group is None else dist.get_world_size(group)


def _local_batch(batch, device: torch.device, group=None) -> tuple:
    """This rank's row of each [W, ...] array (numpy or tensor) of a batch
    stack, as [1, ...] tensors on `device`."""
    r = _rank(group)
    return tuple(torch.as_tensor(a[r : r + 1]).to(device, non_blocking=True) for a in batch)


def _pmean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the group's ranks, in place (one
    all-reduce of their concatenation)."""
    if group is None:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def _pmean_losses(losses: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    out = {k: v.detach().clone() for k, v in losses.items()}
    _pmean_(list(out.values()), group)
    return out


def dp_train_step(state: TrainState, batch, sc: StepConfig, group=None) -> Dict[str, torch.Tensor]:
    """Forward and backward on this rank's row, gradients averaged over the
    ranks, one Adam update; returns the averaged losses (detached 0-dim
    tensors on the device)."""
    device = next(state.model.parameters()).device
    losses = compute_losses(state.model, _local_batch(batch, device, group), sc, train=True)
    state.optimizer.zero_grad(set_to_none=True)
    sum(losses.values()).backward()
    _pmean_([p.grad for p in state.model.parameters()], group)
    state.optimizer.step()
    state.step += 1
    return _pmean_losses(losses, group)


@torch.no_grad()
def dp_eval_step(state: TrainState, batch, sc: StepConfig, group=None) -> Dict[str, torch.Tensor]:
    """The eval losses of this rank's row, averaged over the ranks."""
    device = next(state.model.parameters()).device
    losses = compute_losses(state.model, _local_batch(batch, device, group), sc, train=False)
    return _pmean_losses(losses, group)
