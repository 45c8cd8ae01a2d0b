"""The benchmark's traffic generator: procedural trees and forests.

A frozen copy of the program's generator at the commit that defined this
benchmark (`data/synthetic.py::generate_tree`, `tools/bench_scan.py::
make_forest` and `data/augmentations.py::CentreCloud` of the port), so that
a later change to the program cannot move the yardstick. The same seed gives
the same cloud as those functions did, bit for bit (a test holds the two
equal while the program keeps them).

Arrays only: a cloud here is (xyz float32 [N,3], rgb float32 [N,3]).
"""

from __future__ import annotations

import numpy as np


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _perp_basis(d):
    ref = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
    u = _unit(np.cross(d, ref))
    w = np.cross(d, u)
    return u, w


def generate_skeleton(rng, height=4.0, trunk_radius=0.08, max_depth=4,
                      children_per_branch=(2, 4), segment_len=0.05):
    """Recursive branching skeleton, y up: a list of (parent id, xyz float32
    [n,3], radii float32 [n]) in creation order."""
    branches = []

    def grow(start, direction, length, r0, r1, parent_id, depth):
        bid = len(branches)
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
        radii = ((1 - ts) * r0 + ts * r1).astype(np.float32)
        branches.append((parent_id, xyz, radii))

        if depth < max_depth and r1 > 0.004:
            n_children = rng.integers(children_per_branch[0], children_per_branch[1] + 1)
            for _ in range(n_children):
                t_at = rng.uniform(0.3, 1.0)
                i_at = min(int(t_at * (n - 1)), n - 1)
                base_d = _unit(xyz[min(i_at + 1, n - 1)] - xyz[max(i_at - 1, 0)])
                u, w = _perp_basis(base_d)
                ang = rng.uniform(0, 2 * np.pi)
                tilt = rng.uniform(0.4, 1.1)
                child_d = _unit(base_d * np.cos(tilt)
                                + (u * np.cos(ang) + w * np.sin(ang)) * np.sin(tilt))
                r_at = float(radii[i_at])
                child_r0 = r_at * rng.uniform(0.5, 0.75)
                child_len = length * rng.uniform(0.35, 0.6)
                grow(xyz[i_at], child_d, child_len, child_r0, child_r0 * 0.35, bid, depth + 1)

    grow(np.zeros(3), np.array([0.0, 1.0, 0.0]), height, trunk_radius,
         trunk_radius * 0.4, -1, 0)
    return branches


def sample_cloud(rng, branches, points_per_m2=30000.0, noise=0.002, foliage_points=0):
    """Surface points on every tube of the skeleton, plus foliage around the
    branch tips: (xyz, rgb)."""
    xyz_all = []
    for _, xyz, radii in branches:
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
    xyz = np.concatenate(xyz_all)
    if foliage_points > 0:
        tips = np.stack([b[1][-1] for b in branches if b[0] != -1] or [branches[0][1][-1]])
        choice = rng.integers(0, len(tips), foliage_points)
        fxyz = tips[choice] + rng.normal(scale=0.15, size=(foliage_points, 3))
        xyz = np.concatenate([xyz, fxyz.astype(np.float32)])
    return xyz, np.full_like(xyz, 0.5)


def generate_tree(seed=0, height=4.0, points_per_m2=30000.0, foliage_points=0,
                  noise=0.002, **kw):
    rng = np.random.default_rng(seed)
    branches = generate_skeleton(rng, height=height, **kw)
    return sample_cloud(rng, branches, points_per_m2=points_per_m2,
                        foliage_points=foliage_points, noise=noise)


def tree_draws(seed, n_trees, points_per_m2, foliage_points=30000):
    """The trees of `make_forest(n_trees, points_per_m2, seed)`, each as it
    comes from the generator, with its offset: [(xyz, rgb, offset)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_trees):
        xyz, rgb = generate_tree(
            seed=seed + i, height=float(rng.uniform(8, 14)),
            trunk_radius=float(rng.uniform(0.15, 0.3)),
            points_per_m2=points_per_m2, foliage_points=foliage_points)
        offset = np.asarray([rng.uniform(-20, 20), 0.0, rng.uniform(-20, 20)], np.float32)
        out.append((xyz, rgb, offset))
    return out


def make_forest(n_trees, points_per_m2, seed=0, foliage_points=30000):
    """`make_forest`: the trees of `tree_draws`, each moved by its offset."""
    trees = tree_draws(seed, n_trees, points_per_m2, foliage_points)
    return (np.concatenate([np.asarray(x) + off for x, _, off in trees]),
            np.concatenate([rgb for _, rgb, _ in trees]))


def centre(xyz):
    """`CentreCloud`: the bounding box's centre to the origin in x and z,
    its base to y = 0."""
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    dims = (hi - lo) / 2
    c = lo + dims
    offset = -c + np.asarray([0, dims[1], 0], c.dtype)
    return xyz + offset

