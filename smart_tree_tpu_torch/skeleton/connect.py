"""Connecting disjoint skeletons (counterpart of
`smart_tree_tpu/skeleton/connect.py`).

Each secondary skeleton whose root (its lowest-y vertex) lies within
`max_distance` of a tube of the primary skeleton is grafted onto it: its
branches are renumbered into the primary's id space, its root branch gets
the branch owning the nearest tube as parent, and the point on that tube
is prepended to the root branch. Skeletons farther away stay separate.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..data.tree import DisjointTreeSkeleton, TreeSkeleton
from ..data.tube import collate_tubes
from ..device import resolve_device
from ..utils.queries import pts_to_nearest_tube


def _root_point(skeleton: TreeSkeleton) -> np.ndarray:
    pts = np.concatenate([b.xyz for b in skeleton.branches.values()])
    return pts[np.argmin(pts[:, 1])]


def connect_skeletons(
    disjoint: DisjointTreeSkeleton, max_distance: float = 0.5, device=None
) -> DisjointTreeSkeleton:
    """Graft secondary skeletons onto the primary where close enough.

    Returns a new DisjointTreeSkeleton whose first element is the merged
    skeleton (the grafted branches are the secondaries' own objects,
    renumbered in place, as in the JAX package); skeletons farther than
    `max_distance` follow it. The nearest-tube queries run on the card
    unless `device` names another."""
    dev = resolve_device(device)
    if len(disjoint.skeletons) <= 1:
        return disjoint
    primary = disjoint.skeletons[0]
    merged = dict(primary.branches)
    tube_owner: List[int] = []
    tubes = []
    for bid, b in primary.branches.items():
        bt = b.to_tubes()
        tubes += bt
        tube_owner += [bid] * len(bt)
    collated = collate_tubes(tubes) if tubes else None
    remaining = []
    next_id = (max(merged.keys()) if merged else -1) + 1
    for sk in disjoint.skeletons[1:]:
        if collated is None or not sk.branches:
            remaining.append(sk)
            continue
        root = _root_point(sk)
        v, idx, _ = pts_to_nearest_tube(root.reshape(1, 3), collated, device=dev)
        if float(np.linalg.norm(v[0])) > max_distance:
            remaining.append(sk)
            continue
        parent_bid = tube_owner[int(idx[0])]
        id_map = {}
        for old_id in sk.branches:
            id_map[old_id] = next_id
            next_id += 1
        for old_id, b in sk.branches.items():
            b.parent_id = id_map.get(b.parent_id, parent_bid)
            b._id = id_map[old_id]
            merged[b._id] = b
        # extend the grafted root branch to touch the primary's tube
        gb = merged[min(id_map.values())]
        gb.xyz = np.concatenate([(root + v[0]).reshape(1, 3), gb.xyz])
        gb.radii = np.concatenate([gb.radii[[0]], gb.radii])
    return DisjointTreeSkeleton([TreeSkeleton(primary._id, merged)] + remaining)
