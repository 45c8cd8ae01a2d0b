"""The comparison that decides `correct`: what the timed path produced
against the plain reference, number by number, each against its limit.

Forward (every cell), over every interior voxel of a sampled cloud, rows
matched by the exact float32 position of the voxel's point. The shipped
model's heads span many orders of magnitude on these trees (logits to 1e7,
log radii to -5e5, so most radii are 0), so each number is the share of
rows whose answer is wrong by a margin that means something at any scale:
  rows_bad       rows the reference does not have, reference rows the
                 program left out, rows twice, and rows whose class or
                 medial vector the output format cannot hold (limit 0)
  class_flip     the share of rows whose class is not the reference's
  radius_off     the share of the medial-class rows (where the reference's
                 direction head is live) whose radius |medial vector| is
                 off the reference's exp(log radius) by more than
                 RADIUS_TOL of it, radii under RADIUS_FLOOR counted as that
  direction_off  the share of those rows with a radius whose unit direction
                 lies farther than DIRECTION_TOL from the reference's
Skeleton (pipeline cells), the reference skeletonising its own forward's
output as the program's output format carries it:
  skeleton_miss  the larger of the two shares of skeleton length (each
                 polyline sampled every 2 mm) that lies farther than 1 cm
                 from the other skeleton
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

SAMPLE_STEP = 0.002
MISS_TOL = 0.01
DEAD = 1.0
RADIUS_TOL = 0.05
RADIUS_FLOOR = 1e-3
DIRECTION_TOL = 0.1


def sample(sizes, n_check, seed):
    """Which clouds a run checks, as positions in `sizes` (the candidates'
    point counts): the largest (the first of them) and `n_check - 1` more
    drawn from the seed."""
    largest = int(np.argmax(sizes))
    others = [j for j in range(len(sizes)) if j != largest]
    n = min(len(others), int(n_check) - 1)
    if n <= 0:
        return [largest]
    rng = np.random.default_rng([seed, 1])
    return [largest] + [int(j) for j in rng.choice(others, n, replace=False)]


def encode_output(heads, medial_classes):
    """The reference's heads in the program's output format: the argmax
    class, and at rows of a medial class exp(float16 log radius) times the
    direction in int8 steps of 1/127, renormalised; elsewhere 0."""
    cls = heads.logits.argmax(axis=1)
    with np.errstate(over="ignore"):     # log radii past float16's range
        r = np.exp(heads.log_radius.astype(np.float16).astype(np.float32))
    q = np.clip(np.round(heads.direction * 127.0), -127, 127).astype(np.float32) / 127.0
    d = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-8)
    mv = (r[:, None] * d).astype(np.float32)
    mv[~np.isin(cls, medial_classes)] = 0.0
    return cls, mv


def _keys(xyz):
    return np.ascontiguousarray(xyz, np.float32).view(np.dtype((np.void, 12))).ravel()


def forward_numbers(out_xyz, out_mv, out_cls, ref_xyz, heads, medial_classes):
    """{number: value} of one cloud's forward output against the reference
    (`ref_xyz` is the cloud the reference was handed).

    A medial row's medial vector is zero where its direction head gives the
    zero vector (every input of its last layer cut by the ReLU); the
    reference's rows whose direction head is that dead (norm under DEAD;
    live rows read 20 and up) carry no radius in the output format and are
    left out of `radius_off` and `direction_off`."""
    n_ref = len(heads.point)
    u, inv = np.unique(np.concatenate([_keys(ref_xyz[heads.point]), _keys(out_xyz)]),
                       return_inverse=True)
    row_of = np.full(len(u), -1, np.int64)
    row_of[inv[:n_ref]] = np.arange(n_ref)
    idx = row_of[inv[n_ref:]]
    hit = idx >= 0
    distinct = len(np.unique(idx[hit]))
    cls = np.asarray(out_cls).reshape(-1)
    cls_i = np.rint(cls).astype(np.int64)
    ok_cls = (cls == cls_i) & (cls_i >= 0) & (cls_i < heads.logits.shape[1])
    mv = np.asarray(out_mv, np.float64)
    norm = np.linalg.norm(mv, axis=1)
    medial = np.isin(cls_i, medial_classes) & ok_cls
    bad_mv = ~np.isfinite(mv).all(axis=1) | (~medial & (norm != 0))
    rows_bad = (int((~hit).sum()) + (n_ref - distinct) + (int(hit.sum()) - distinct)
                + int((~ok_cls).sum()) + int(bad_mv.sum()))
    good = hit & ok_cls & ~bad_mv
    j = idx[good]
    flip = cls_i[good] != heads.logits[j].argmax(axis=1)
    m = good & medial
    m[m] = heads.direction_norm[idx[m]] >= DEAD
    r_ref = np.exp(heads.log_radius[idx[m]].astype(np.float64))
    r_off = np.abs(norm[m] - r_ref) > RADIUS_TOL * np.maximum(r_ref, RADIUS_FLOOR)
    md = m & (norm > 0)
    d_off = np.linalg.norm(mv[md] / norm[md, None] - heads.direction[idx[md]],
                           axis=1) > DIRECTION_TOL
    return {
        "rows_bad": rows_bad,
        "class_flip": float(flip.mean()) if len(flip) else 0.0,
        "radius_off": float(r_off.mean()) if len(r_off) else 0.0,
        "direction_off": float(d_off.mean()) if len(d_off) else 0.0,
    }


def _samples(skeletons):
    pts, wts = [np.zeros((0, 3))], [np.zeros(0)]
    for branches in skeletons:
        for xyz, _ in branches:
            xyz = np.asarray(xyz, np.float64)
            if len(xyz) < 2:
                continue
            a, b = xyz[:-1], xyz[1:]
            length = np.linalg.norm(b - a, axis=1)
            k = np.maximum(np.ceil(length / SAMPLE_STEP), 1).astype(np.int64)
            seg = np.repeat(np.arange(len(a)), k)
            t = (np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k) + 0.5) / k[seg]
            pts.append(a[seg] + t[:, None] * (b - a)[seg])
            wts.append(length[seg] / k[seg])
    return np.concatenate(pts), np.concatenate(wts)


def _miss(pa, wa, pb):
    if not wa.sum():
        return 0.0
    if not len(pb):
        return 1.0
    d, _ = cKDTree(pb).query(pa)
    return float(wa[d > MISS_TOL].sum() / wa.sum())


def skeleton_miss(program, reference):
    """The larger share of either skeleton's length that lies farther than
    MISS_TOL from the other; skeletons as [[(xyz, radii)]]."""
    pa, wa = _samples(program)
    pb, wb = _samples(reference)
    return max(_miss(pa, wa, pb), _miss(pb, wb, pa))


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number of `limits` read and
    within its limit."""
    rows = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    return len(rows) == len(limits) and all(v <= lim for _, v, lim in rows), rows
