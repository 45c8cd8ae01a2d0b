"""Device-memory footprint model for the sparse-UNet forward, and the
budget a batch is sized against.

`estimate_forward_hbm` is the counterpart of
`smart_tree_tpu/core/memory.py`, term for term at its defaults, so that on
the CPU `ModelInference` splits a cloud into the same batches as the
reference:

  per level l, capacity cap_l, channels C_l:
    - conv gather transients, counted as ROW_CHUNK rows (or whole, up to
      `whole_gather_bytes`);
    - z-window tables and rulebook-build temporaries;
    - persistent plan tables and feature buffers.

The port's convs chunk where the JAX package's do (core/sparse_ops.py,
`ConvConfig.chunked`): route 3 gathers ROW_CHUNK rows at a time, forward
and backward, once a whole fp32 gather would pass CHUNK_BYTES (1 GiB). A
smaller gather is built whole, which the JAX package's model does not
count (it counts ROW_CHUNK rows). On a card, where the batches grow to
millions of voxels, `ModelInference` counts the port's own terms
(`CARD_FOOTPRINT`, measured against the allocator's peaks by chip_smoke.py
phase 20): those whole gathers, and 8-byte keys, query keys and indices
(the port holds keys in int64 and `searchsorted` returns int64) where the
JAX package's are 4 bytes.

The budget (`device_budget_bytes`) is a share of the card's own memory,
the share that the JAX package's default is of the chip it was set for;
on the CPU it is the JAX package's default itself.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .sparse_ops import CHUNK_BYTES, ROW_CHUNK

# The share of a card's total memory that one batch's forward is planned
# for: what the JAX package's 12 GiB default is of the 16 GB chip it was set
# for. The rest is the CUDA context, the weights and the allocator's slack.
BUDGET_SHARE = 0.75
# The JAX package's default budget, kept on the CPU so that the CPU splits a
# cloud into the reference's batches.
CPU_BUDGET_BYTES = 12 << 30


def device_budget_bytes(devices: Sequence[torch.device]) -> int:
    """Bytes one batch's forward may plan for on every device of `devices`:
    BUDGET_SHARE of a card's total memory (not its free memory, so that a
    card gets the same plan on every run), split evenly between the replicas
    that share the card, and CPU_BUDGET_BYTES on the CPU; the smallest over
    the devices."""
    cards = [torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
             for d in devices if d.type == "cuda"]
    budgets = [CPU_BUDGET_BYTES] if len(cards) < len(devices) else []
    for card in set(cards):
        total = torch.cuda.get_device_properties(card).total_memory
        budgets.append(int(BUDGET_SHARE * total) // cards.count(card))
    return min(budgets)


# estimate_forward_hbm's arguments for the port's forward on a card: int64
# keys, query keys and indices, and route-3 gathers built whole up to
# CHUNK_BYTES (the terms the JAX package's model leaves out)
CARD_FOOTPRINT = dict(index_bytes=8, whole_gather_bytes=CHUNK_BYTES)


def footprint_terms(devices: Sequence[torch.device]) -> dict:
    """The estimate_forward_hbm terms batches are sized with on `devices`:
    CARD_FOOTPRINT where one is a card; on the CPU the JAX package's model,
    so that the CPU splits a cloud into the reference's batches."""
    return dict(CARD_FOOTPRINT) if any(d.type == "cuda" for d in devices) else {}


def level_capacities(
    capacity: int, num_levels: int, factor: float, min_capacity: int = 256
) -> Tuple[int, ...]:
    """Mirror of core/plan.py build_plan's capacity schedule."""
    caps = [capacity]
    for _ in range(num_levels - 1):
        caps.append(max(int(caps[-1] * factor), min_capacity))
    return tuple(caps)


def estimate_forward_hbm(
    capacity: int,
    planes: Sequence[int],
    factor: float = 0.5,
    itemsize: int = 4,
    in_flight: int = 1,
    index_bytes: int = 4,
    whole_gather_bytes: int = 0,
    level_caps: Sequence[int] | None = None,
) -> dict:
    """Estimated peak device bytes of one forward at `capacity`:
    {"peak", "transient", "persistent", "per_level_transient",
    "level_capacities"}, with a 1.5x headroom on the peak.

    level_caps: the level capacities of an overflow rerun, in place of the
        schedule `factor` gives (level 0 stays `capacity`).

    index_bytes: bytes of a query key, a lookup result and a z-window query
        key (the JAX package's 4; CARD_FOOTPRINT's 8).
    whole_gather_bytes: a conv gather of at most this many fp32 bytes is
        counted whole, a larger one as ROW_CHUNK rows (the JAX package's 0:
        every gather as ROW_CHUNK rows). A level's convs gather C_l (head)
        or its widest Cin channels."""
    caps = level_capacities(capacity, len(planes), factor)
    if level_caps is not None:
        caps = (capacity, *(int(c) for c in level_caps[1:]))
    per_level = []
    persistent = 0
    for lvl, (cap_l, c_l) in enumerate(zip(caps, planes)):
        cin = 2 * c_l if lvl < len(planes) - 1 else c_l

        def rows(width):
            whole = cap_l * 27 * width * 4 <= whole_gather_bytes
            return cap_l if whole else min(cap_l, ROW_CHUNK)

        gather = max(2 * rows(w) * 27 * w * itemsize for w in (c_l, cin))
        zwin = cap_l * (3 * cin) * itemsize + cap_l * 3 * 4
        rulebook = 2 * cap_l * 27 * index_bytes
        per_level.append(gather + zwin + rulebook)
        tables = cap_l * 9 * (4 + index_bytes)
        if lvl < len(planes) - 1:
            tables += caps[lvl + 1] * 27 * 4 + cap_l * 27 * 4
        feats = cap_l * (3 * c_l) * itemsize
        persistent += tables + feats
    transient = max(per_level)
    peak = int(1.5 * (transient + persistent * max(1, in_flight)))
    return {
        "peak": peak,
        "transient": transient,
        "persistent": persistent,
        "per_level_transient": per_level,
        "level_capacities": caps,
    }


def max_capacity_for_budget(
    budget_bytes: int,
    planes: Sequence[int],
    factor: float = 0.5,
    itemsize: int = 4,
    in_flight: int = 1,
    floor: int = 1024,
    ceiling: int = 1 << 24,
    **terms,
) -> int:
    """Largest pow2 batch capacity whose estimated peak fits budget_bytes;
    `terms` are estimate_forward_hbm's index_bytes / whole_gather_bytes."""
    cap = floor
    best = floor
    while cap <= ceiling:
        est = estimate_forward_hbm(cap, planes, factor, itemsize, in_flight, **terms)
        if est["peak"] > budget_bytes:
            break
        best = cap
        cap *= 2
    return best
