"""A synthetic input of the branch tracer, shared by the CPU and card tests
(imports numpy only, so the card tests can take it without the JAX
conftest)."""

import numpy as np


def grown_tree(seed, n, trunk, dropped=0.0):
    """(points, radii, preds, root distances, component mask) of a straight
    trunk of `trunk` vertices 1 cm apart and n - trunk vertices each grown
    1 cm off a random earlier vertex; radii drawn in [5 mm, 3 cm); root
    distances along the predecessors; a share `dropped` of the vertices,
    drawn at random, left out of the component mask."""
    rng = np.random.default_rng(seed)
    preds = np.full(n, -1, np.int64)
    preds[1:trunk] = np.arange(trunk - 1)
    preds[trunk:] = (rng.uniform(size=n - trunk) * np.arange(trunk, n)).astype(np.int64)
    step = rng.normal(size=(n, 3))
    step *= 0.01 / np.linalg.norm(step, axis=1, keepdims=True)
    step[:trunk] = [0.0, 0.0, 0.01]
    pts, rd = np.zeros((n, 3)), np.zeros(n)
    for v in range(1, n):
        pts[v] = pts[preds[v]] + step[v]
        rd[v] = rd[preds[v]] + 0.01
    radii = rng.uniform(0.005, 0.03, n).astype(np.float32)
    mask = rng.uniform(size=n) >= dropped
    return pts.astype(np.float32), radii, preds, rd.astype(np.float32), mask
