"""Block-parallel inference over several devices.

Counterpart of `smart_tree_tpu/parallel/block_infer.py`. Blocks are
independent, so the JAX package stacks one batch per device on a mesh axis
and shard_maps the single-device forward over it, with no collective. Here
there is no shard_map: `ShardedForward` holds one replica of a
`ModelInference` per device (the model copied to the device, a copy stream
and a compute stream of its own) and each replica runs the port's own
per-batch halves on its batch, on its compute stream, so that the count
reads of one replica's exact plan never wait for another replica's batch
on the same card. A group's batches are all launched before the first is collected, so
the cards work at once. The download cull runs on each replica, as it runs
per shard in the JAX package.

`stack_device_batches` and `stack_device_batches_compact` are the JAX
package's host stacking, array for array: `device_groups` is their grouping
(the last batch repeated to fill a group, `keep` false on the repeats).
`ShardedForward` takes the groups and skips the repeats.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Sequence

import numpy as np
import torch


def device_groups(batches, n_dev: int):
    """Batches dealt `n_dev` at a time: [(chunk, keep)], a short last chunk
    filled by repeating its last batch, `keep` false on the repeats."""
    groups = []
    for start in range(0, len(batches), n_dev):
        chunk = list(batches[start : start + n_dev])
        real = len(chunk)
        chunk += [chunk[-1]] * (n_dev - real)
        groups.append((chunk, np.arange(n_dev) < real))
    return groups


def _pad_to(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def stack_device_batches(batches, n_dev: int):
    """[(chunk, coords16 [D,cap,4], res16 [D,cap,3], valid [D,cap], origins
    [D,items,3], keep [D])] from the full-download upload of each batch.
    All batches must share one (capacity, spatial shape, batch size)."""
    groups = []
    for chunk, keep in device_groups(batches, n_dev):
        comp = [b.compressed_xyz_upload() for b in chunk]
        groups.append((chunk, np.stack([c[0] for c in comp]), np.stack([c[1] for c in comp]),
                       np.stack([b.valid for b in chunk]), np.stack([c[2] for c in comp]),
                       keep))
    return groups


def stack_device_batches_compact(batches, n_dev: int, granularity: int, res_dtype):
    """The compact twin: each batch's valid-row prefix (`compact_upload`)
    padded to the group's largest stage. [(chunk, c16 [D,stage,4], res
    [D,stage,3], n [D], origins, keep, stage, bits [D, ceil(stage/8)])],
    `bits` the packed interior mask of the staged rows (padding rows 0)."""
    groups = []
    for chunk, keep in device_groups(batches, n_dev):
        comp = [b.compact_upload(granularity, res_dtype) for b in chunk]
        stage = max(len(c[0]) for c in comp)
        c16 = np.stack([_pad_to(c[0], stage) for c in comp])
        res = np.stack([_pad_to(c[1], stage) for c in comp])
        origins = np.stack([c[2] for c in comp])
        n = np.asarray([c[3] for c in comp], np.int32)
        bits = np.stack([np.packbits(_pad_to(b.mask[: len(c[0])], stage))
                         for b, c in zip(chunk, comp)])
        groups.append((chunk, c16, res, n, origins, keep, stage, bits))
    return groups


def on_device(device: torch.device):
    """The CUDA device context of `device` (the current device for kernel
    launches, events and streams); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedForward:
    """Counterpart of `make_sharded_forward`: one replica of `inference`
    per entry of `devices` (a device may appear more than once)."""

    def __init__(self, inference, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self.models = []
        self.streams = []    # (copy stream, compute stream) of each slot
        for dev in self.devices:
            with on_device(dev):
                self.models.append(copy.deepcopy(inference.model).to(dev).eval())
                self.streams.append((torch.cuda.Stream(dev), torch.cuda.Stream(dev))
                                    if dev.type == "cuda" else (None, None))

    def replicas(self, inference) -> List:
        """Shallow copies of `inference` that run on the devices: its
        settings as they are now, each slot's model, device and streams (and
        the caller's `link_bytes` and `plan_rows`, which they add to)."""
        out = []
        for dev, model, (copy_stream, compute) in zip(self.devices, self.models, self.streams):
            rep = copy.copy(inference)
            rep.device, rep.model, rep._copy_stream = dev, model, copy_stream
            rep._streams = [] if compute is None else [compute]
            out.append(rep)
        return out

    @staticmethod
    def launch(replicas, chunk, keep, run: str) -> list:
        """Queue the run half `run` of every kept batch of one group on its
        replica: [(replica, batch, queued result)]."""
        launched = []
        for rep, vb, k in zip(replicas, chunk, keep):
            if k:
                with on_device(rep.device), rep._slot(0):
                    launched.append((rep, vb, getattr(rep, run)(vb)))
        return launched

    @staticmethod
    def collect(launched, collect: str, sinks) -> None:
        """Read a launched group into the sinks, in device order."""
        for rep, vb, out in launched:
            with on_device(rep.device):
                getattr(rep, collect)(vb, out, sinks)
