"""Procedural synthetic trees (counterpart of
`smart_tree_tpu/data/synthetic.py`): a recursive branching skeleton and
surface points sampled on its tubes with exact medial vectors, plus optional
foliage (class 1) around branch tips. The same seed gives the same cloud as
the JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .branch import BranchSkeleton
from .cloud import Cloud
from .tree import TreeSkeleton


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _perp_basis(d):
    ref = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
    u = _unit(np.cross(d, ref))
    w = np.cross(d, u)
    return u, w


def generate_skeleton(
    rng: np.random.Generator,
    height: float = 4.0,
    trunk_radius: float = 0.08,
    max_depth: int = 4,
    children_per_branch: Tuple[int, int] = (2, 4),
    segment_len: float = 0.05,
) -> TreeSkeleton:
    """Recursive branching skeleton, y-up (root at the lowest y)."""
    branches: Dict[int, BranchSkeleton] = {}
    next_id = [0]

    def grow(start, direction, length, r0, r1, parent_id, depth):
        bid = next_id[0]
        next_id[0] += 1
        n = max(int(np.ceil(length / segment_len)) + 1, 2)
        ts = np.linspace(0.0, 1.0, n)
        curve = rng.normal(scale=0.15, size=3)
        pts = []
        d = direction.copy()
        p = start.copy()
        step = length / (n - 1)
        for _ in ts:
            pts.append(p.copy())
            d = _unit(d + curve * step + rng.normal(scale=0.03, size=3))
            p = p + d * step
        xyz = np.asarray(pts, np.float32)
        radii = ((1 - ts) * r0 + ts * r1).astype(np.float32).reshape(-1, 1)
        branches[bid] = BranchSkeleton(bid, parent_id, xyz, radii)

        if depth < max_depth and r1 > 0.004:
            n_children = rng.integers(children_per_branch[0], children_per_branch[1] + 1)
            for _ in range(n_children):
                t_at = rng.uniform(0.3, 1.0)
                i_at = min(int(t_at * (n - 1)), n - 1)
                base_d = _unit(xyz[min(i_at + 1, n - 1)] - xyz[max(i_at - 1, 0)])
                u, w = _perp_basis(base_d)
                ang = rng.uniform(0, 2 * np.pi)
                tilt = rng.uniform(0.4, 1.1)
                child_d = _unit(
                    base_d * np.cos(tilt)
                    + (u * np.cos(ang) + w * np.sin(ang)) * np.sin(tilt)
                )
                r_at = float(radii[i_at, 0])
                child_r0 = r_at * rng.uniform(0.5, 0.75)
                child_len = length * rng.uniform(0.35, 0.6)
                grow(xyz[i_at], child_d, child_len, child_r0, child_r0 * 0.35,
                     bid, depth + 1)

    grow(np.zeros(3), np.array([0.0, 1.0, 0.0]), height, trunk_radius,
         trunk_radius * 0.4, -1, 0)
    return TreeSkeleton(0, branches)


def sample_cloud(
    rng: np.random.Generator,
    skeleton: TreeSkeleton,
    points_per_m2: float = 30000.0,
    noise: float = 0.002,
    foliage_points: int = 0,
) -> Cloud:
    """Sample surface points on every tube with exact medial ground truth."""
    xyz_all, mv_all, bid_all, dir_all = [], [], [], []
    for branch in skeleton.branches.values():
        xyz, radii = branch.xyz, branch.radii[:, 0]
        for i in range(len(xyz) - 1):
            a, b = xyz[i], xyz[i + 1]
            r0, r1 = radii[i], radii[i + 1]
            seg = b - a
            seg_len = np.linalg.norm(seg)
            if seg_len < 1e-8:
                continue
            d = seg / seg_len
            area = 2 * np.pi * max((r0 + r1) / 2, 1e-4) * seg_len
            n_pts = max(int(points_per_m2 * area), 1)
            t = rng.uniform(0, 1, n_pts)
            ang = rng.uniform(0, 2 * np.pi, n_pts)
            u, w = _perp_basis(d)
            axis_pt = a[None, :] + t[:, None] * seg[None, :]
            r = (1 - t) * r0 + t * r1
            radial = np.cos(ang)[:, None] * u[None, :] + np.sin(ang)[:, None] * w[None, :]
            surf = axis_pt + radial * r[:, None]
            surf = surf + rng.normal(scale=noise, size=surf.shape)
            xyz_all.append(surf.astype(np.float32))
            mv_all.append((axis_pt - surf).astype(np.float32))
            dir_all.append(np.broadcast_to(d, surf.shape).astype(np.float32))
            bid_all.append(np.full(n_pts, branch._id, np.float32))

    xyz = np.concatenate(xyz_all)
    medial_vector = np.concatenate(mv_all)
    branch_direction = np.concatenate(dir_all)
    branch_ids = np.concatenate(bid_all).reshape(-1, 1)
    class_l = np.zeros((len(xyz), 1), np.float32)

    if foliage_points > 0:
        tips = np.stack(
            [b.xyz[-1] for b in skeleton.branches.values() if b.parent_id != -1]
            or [list(skeleton.branches.values())[0].xyz[-1]]
        )
        choice = rng.integers(0, len(tips), foliage_points)
        fxyz = tips[choice] + rng.normal(scale=0.15, size=(foliage_points, 3))
        fmv = rng.normal(scale=0.01, size=(foliage_points, 3))
        xyz = np.concatenate([xyz, fxyz.astype(np.float32)])
        medial_vector = np.concatenate([medial_vector, fmv.astype(np.float32)])
        branch_direction = np.concatenate(
            [branch_direction, np.zeros((foliage_points, 3), np.float32)]
        )
        branch_ids = np.concatenate(
            [branch_ids, np.full((foliage_points, 1), -1, np.float32)]
        )
        class_l = np.concatenate([class_l, np.ones((foliage_points, 1), np.float32)])

    return Cloud(
        xyz=xyz,
        rgb=np.full_like(xyz, 0.5),
        medial_vector=medial_vector,
        branch_direction=branch_direction,
        branch_ids=branch_ids,
        class_l=class_l,
    )


def generate_tree(
    seed: int = 0,
    height: float = 4.0,
    points_per_m2: float = 30000.0,
    foliage_points: int = 0,
    noise: float = 0.002,
    **kw,
) -> Tuple[Cloud, TreeSkeleton]:
    rng = np.random.default_rng(seed)
    skeleton = generate_skeleton(rng, height=height, **kw)
    cloud = sample_cloud(rng, skeleton, points_per_m2=points_per_m2,
                         foliage_points=foliage_points, noise=noise)
    return cloud, skeleton
