"""Point -> tube (capsule) distance queries (counterpart of
`smart_tree_tpu/utils/queries.py`). Used by skeleton repair (data/tree.py)
and by skeleton -> point labelling.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.tube import CollatedTube
from ..device import resolve_device


def _nearest_tube(pts, a, b, r1, r2):
    """pts [N,3]; tubes a,b [M,3], r1,r2 [M], all fp32 on one device.

    Returns (vector [N,3] to the projection point on the nearest tube,
    idx [N] of that tube, radius [N] at the projection). Nearest = least
    |distance - radius|."""
    ab = b - a  # [M,3]
    ap = pts[:, None, :] - a[None, :, :]  # [N,M,3]
    # contraction over 3 elements, written as sums: never a TF32 matmul
    denom = (ab * ab).sum(dim=1)
    t = ((ap * ab[None, :, :]).sum(dim=2) / (denom + 1e-12)).clamp(0.0, 1.0)  # [N,M]
    proj = a[None, :, :] + t[:, :, None] * ab[None, :, :]  # [N,M,3]
    r = (1 - t) * r1[None, :] + t * r2[None, :]  # [N,M]
    off = proj - pts[:, None, :]
    d = torch.sqrt((off * off).sum(dim=2))  # [N,M]
    idx = torch.argmin((d - r).abs(), dim=1)  # [N]
    rows = torch.arange(pts.shape[0], device=pts.device)
    return proj[rows, idx] - pts, idx, r[rows, idx]


@torch.no_grad()
def pts_to_nearest_tube(pts: np.ndarray, tubes: CollatedTube, device=None):
    """Host wrapper: vectors, idx and radius of the nearest tube per point,
    as numpy arrays. Runs on the card unless `device` says otherwise."""
    dev = resolve_device(device)

    def up(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    v, idx, r = _nearest_tube(
        up(pts).reshape(-1, 3), up(tubes.a), up(tubes.b), up(tubes.r1), up(tubes.r2)
    )
    return v.cpu().numpy(), idx.cpu().numpy(), r.cpu().numpy()


def skeleton_to_points(xyz: np.ndarray, tubes: CollatedTube, chunk_size: int = 4096,
                       device=None):
    """Chunked point -> skeleton labelling.
    Returns (distances [N], radii [N], vectors [N,3])."""
    xyz = np.asarray(xyz, np.float32)
    dists, radii, vecs = [], [], []
    for start in range(0, len(xyz), chunk_size):
        v, _, r = pts_to_nearest_tube(xyz[start : start + chunk_size], tubes, device)
        dists.append(np.sqrt(np.einsum("ij,ij->i", v, v)))
        radii.append(r)
        vecs.append(v)
    return np.concatenate(dists), np.concatenate(radii), np.concatenate(vecs)
