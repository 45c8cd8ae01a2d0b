"""Devices and ranks.

Counterpart of `smart_tree_tpu/parallel/mesh.py`. The JAX package builds a
one-axis mesh over its devices and shards over it with shard_map; here the
two ways of using several cards are plain lists and process groups:

  - block-parallel inference runs in one process over a list of devices
    (`make_devices`, `ModelInference(devices=...)`);
  - data-parallel training runs one process per card in a
    `torch.distributed` process group, started by `torchrun` (which sets
    RANK, WORLD_SIZE and LOCAL_RANK) or by `spawn_world`.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# how long spawn_world waits for its ranks, start-up included
SPAWN_TIMEOUT_S = 120.0


def make_devices(n: int | None = None) -> List[torch.device]:
    """The first `n` visible cards, or all of them. Never the CPU: name
    `torch.device("cpu")` yourself to run there."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible; name the devices (for example "
                           "['cpu'] * 2) to run on the CPU")
    n = count if n is None else int(n)
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} cards, {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def world() -> tuple[int, int, int]:
    """(rank, world size, local rank): from the initialised process group,
    else from torchrun's environment, else (0, 1, 0)."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        return rank, dist.get_world_size(), int(env.get("LOCAL_RANK", rank))
    return int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)), int(env.get("LOCAL_RANK", 0))


def _rank_main(fn, rank, world_size, init_method, args, results):
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=SPAWN_TIMEOUT_S))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except Exception:  # the parent raises it; anything else ends the process unanswered
        results.put((rank, traceback.format_exc(), None))


def spawn_world(fn: Callable, world_size: int, init_method: str, args: Sequence = ()) -> list:
    """Run `fn(rank, world_size, *args)` in `world_size` fresh processes that
    share one gloo process group (`init_method`, for example
    "file:///tmp/x"; gloo reduces CPU and CUDA tensors, and `fn` may make
    NCCL groups with `dist.new_group`), and return their results in rank
    order. `fn` must be importable by name (a module's top-level function).
    Raises on a rank's exception, and kills every rank and raises when they
    have not all answered within SPAWN_TIMEOUT_S, so a hung rendezvous or
    collective fails instead of stalling."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, errors, answered = [None] * world_size, [], 0
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while answered < world_size and not errors:
            try:
                rank, err, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} died without an answer")
                elif time.monotonic() > deadline:
                    errors.append(f"not every rank answered within {SPAWN_TIMEOUT_S} s")
                continue
            answered += 1
            out[rank] = value
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn_world: " + "\n".join(errors))
    return out
