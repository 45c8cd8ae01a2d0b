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

The port's route 3 (core/sparse_ops.py, `ConvConfig.chunked`) gathers
ROW_CHUNK rows at a time, forward and backward, once a whole fp32 gather
would pass CHUNK_BYTES (1 GiB), whatever the row count (the last chunk
short): the model's chunked term is then right for the exact plans' ragged
levels too. A smaller gather is built whole, which the JAX package's model
does not count (it counts ROW_CHUNK rows). On a card, where the batches grow to
millions of voxels, `ModelInference` counts the port's own terms
(`CARD_FOOTPRINT`, measured against the allocator's peaks by chip_smoke.py
phase 20): those whole gathers, and 8-byte keys, query keys and indices
(the port holds keys in int64 and `searchsorted` returns int64) where the
JAX package's are 4 bytes.

`estimate_serial_hbm` is the model of a Point Transformer V3 forward
(nn/ptv3.py), in the same terms: per level the rulebooks, orders and patch
indices of its plan and the encoder's skip features persist; the largest
of a level's conv gather, attention or MLP transients is the transient.

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

    level_caps: every level's rows, in place of `capacity` and the
        schedule `factor` gives: an exact plan's level counts (the port's
        inference plans; ModelInference holds each to the budget by them).

    index_bytes: bytes of a query key, a lookup result and a z-window query
        key (the JAX package's 4; CARD_FOOTPRINT's 8).
    whole_gather_bytes: a conv gather of at most this many fp32 bytes is
        counted whole, a larger one as ROW_CHUNK rows (the JAX package's 0:
        every gather as ROW_CHUNK rows). A level's convs gather C_l (head)
        or its widest Cin channels."""
    caps = level_capacities(capacity, len(planes), factor)
    if level_caps is not None:
        caps = tuple(int(c) for c in level_caps)
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
    return largest_pow2(lambda cap: estimate_forward_hbm(
        cap, planes, factor, itemsize, in_flight, **terms)["peak"] <= budget_bytes,
        floor, ceiling)


def largest_pow2(fits, floor: int = 1024, ceiling: int = 1 << 24) -> int:
    """The largest pow2 capacity from `floor` up to `ceiling` for which
    `fits(capacity)` holds while every smaller one does (`floor` if none)."""
    best, cap = floor, floor
    while cap <= ceiling and fits(cap):
        best, cap = cap, cap * 2
    return best


def estimate_serial_hbm(
    level_rows: Sequence[int],
    widths: Sequence[int],
    mlp_ratio: int = 4,
    stem_columns: int = 125,
    in_channels: int = 3,
    patch: int = 1024,
    itemsize: int = 4,
    in_flight: int = 1,
    index_bytes: int = 4,
    whole_gather_bytes: int = 0,
) -> dict:
    """Estimated peak device bytes of one Point Transformer V3 forward over
    `level_rows` voxels a level, `widths` each level's widest features:
    {"peak", "transient", "persistent", "per_level_transient"}, with the
    1.5x headroom of `estimate_forward_hbm`.

    Per level of n rows and width C, s = 2n + 4 * patch patch slots (a
    long item pads less than a patch, at most doubling it; four short
    items at most a patch each):
      persistent  keys, the 27-column rulebook, the parent map, four orders'
                  slot indices (gather over s, scatter over n) and their
                  sort's inverse, the skip features; level 0 the stem's
                  rulebook;
      transient   the residual stream and its normed copy, and the largest
                  of: the CPE's gather (27 C, whole up to
                  `whole_gather_bytes`, else ROW_CHUNK rows) with its
                  rounded operand; the attention's qkv, its patch copy in
                  fp32 and in the operand precision, and its output; the
                  MLP's hidden activations and their rounded copy; at level
                  0 the stem's gather."""
    per_level, persistent = [], 0
    for lvl, (n, c) in enumerate(zip(level_rows, widths)):
        n, c = int(n), int(c)
        slots = 2 * n + 4 * patch

        def gather(rows, width):
            whole = rows * width * 4 <= whole_gather_bytes
            return 2 * (rows if whole else min(rows, ROW_CHUNK)) * width * itemsize

        tables = n * (8 + 27 * 4 + index_bytes) + 4 * (slots + 2 * n) * index_bytes
        if lvl == 0:
            tables += n * stem_columns * 4
        persistent += tables + n * c * itemsize
        stream = 3 * n * c * itemsize
        attn = (n * 3 * c + slots * 3 * c * 2 + slots * c + n * c) * itemsize
        mlp = 3 * n * mlp_ratio * c * itemsize
        conv = gather(n, 27 * c)
        if lvl == 0:
            conv = max(conv, gather(n, stem_columns * in_channels))
        per_level.append(stream + max(conv, attn, mlp))
    transient = max(per_level)
    return {
        "peak": int(1.5 * (transient + persistent * max(1, in_flight))),
        "transient": transient,
        "persistent": persistent,
        "per_level_transient": per_level,
    }
