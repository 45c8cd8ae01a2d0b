"""Device-memory footprint model for the sparse-UNet forward.

Counterpart of `smart_tree_tpu/core/memory.py`, kept term for term so that
`ModelInference` splits a cloud into the same batches as the reference. Its
default budget (12 GiB) is the JAX package's; sizing for the H100's 80 GB is
later work.

  per level l, capacity cap_l, channels C_l:
    - conv gather transients, counted as ROW_CHUNK rows;
    - z-window tables and rulebook-build temporaries;
    - persistent plan tables and feature buffers.

The port's convs chunk where the JAX package's do (core/sparse_ops.py,
`ConvConfig.chunked`): route 3 gathers ROW_CHUNK rows at a time, forward
and backward, once a whole fp32 gather would pass 1 GiB. A smaller gather
is built whole, so a transient the model counts as ROW_CHUNK rows can
reach 1 GiB; the JAX package's model counts it the same way.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .sparse_ops import ROW_CHUNK


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
) -> dict:
    """Estimated peak device bytes of one forward at `capacity`:
    {"peak", "transient", "persistent", "per_level_transient",
    "level_capacities"}, with a 1.5x headroom on the peak."""
    caps = level_capacities(capacity, len(planes), factor)
    per_level = []
    persistent = 0
    for lvl, (cap_l, c_l) in enumerate(zip(caps, planes)):
        cin = 2 * c_l if lvl < len(planes) - 1 else c_l
        rows = min(cap_l, ROW_CHUNK)
        gather = 2 * rows * 27 * cin * itemsize
        zwin = cap_l * (3 * cin) * itemsize + cap_l * 3 * 4
        rulebook = 2 * cap_l * 27 * 4
        per_level.append(gather + zwin + rulebook)
        tables = cap_l * (9 + 9) * 4
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
) -> int:
    """Largest pow2 batch capacity whose estimated peak fits budget_bytes."""
    cap = floor
    best = floor
    while cap <= ceiling:
        est = estimate_forward_hbm(cap, planes, factor, itemsize, in_flight)
        if est["peak"] > budget_bytes:
            break
        best = cap
        cap *= 2
    return best
