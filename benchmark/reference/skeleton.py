"""Plain reference, the skeleton: a labelled cloud to branch polylines.

numpy and scipy, float64, written from smart-tree's published skeletoniser
and the configuration's settings:

  1. keep a medial point (point + medial vector) when at least `nb_points`
     medial points, itself included, lie closer than its radius (at least
     `min_filter_radius`);
  2. one medial point per cell of `medial_quantize` metres: the one of
     lowest surface y, then lowest index; vertices in (x, y, z) cell order;
  3. a graph joining each vertex to its K nearest vertices that lie within
     its radius (at least `min_connection_length`), both ways;
  4. connected components of at least `minimum_graph_vertices` vertices,
     the `max_components` largest (ties by lowest vertex), each rooted at its
     lowest surface point (ties by lowest vertex);
  5. shortest paths from the roots (Dijkstra); a vertex's predecessor is its
     lowest neighbour u with dist[u] + w <= dist[v] + 1e-5 (|dist[v]| + 1),
     stepping down (or equal, to a lower vertex); root distance summed along
     the predecessors;
  6. branches, greedily: the unallocated vertex farthest from its root
     (vertices whose predecessor is vertex 0 never seed, as in smart-tree)
     is traced back to an allocated vertex or the root; every vertex whose
     nearest path vertex lies within that vertex's radius is allocated; a
     path of two or more vertices is a branch, its parent the branch owning
     the vertex it stopped at;
  7. the post-processing: the first skeleton pruned (a branch goes with its
     parent, or when shorter than `min_skeleton_length` or its end radii
     both below `min_skeleton_radius`), every branch joined to the nearest
     point of its parent's tubes, radii box-filtered over
     `smooth_kernel_size` where a branch is longer than that.

The result is a list of skeletons, each a list of (xyz [n,3], radii [n]).
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components, dijkstra
from scipy.spatial import cKDTree


def _outlier_keep(pts, radii, nb_points):
    if len(pts) < nb_points:
        return np.zeros(len(pts), bool)
    d, _ = cKDTree(pts).query(pts, k=nb_points)
    return d[:, -1] < radii


def _reduce(pts, surface_y, cell):
    q = np.floor(pts.astype(np.float32) / np.float32(cell)).astype(np.int64)
    order = np.lexsort((np.arange(len(pts)), surface_y, q[:, 2], q[:, 1], q[:, 0]))
    qs = q[order]
    head = np.ones(len(order), bool)
    head[1:] = (qs[1:] != qs[:-1]).any(axis=1)
    return order[head]


def _graph(pts, radii, k):
    n = len(pts)
    d, j = cKDTree(pts).query(pts, k=min(k, n))
    d, j = d.reshape(n, -1), j.reshape(n, -1)
    i = np.repeat(np.arange(n), d.shape[1])
    ok = (d <= radii[:, None]).reshape(-1) & (j.reshape(-1) != i)
    u, v, w = i[ok], j.reshape(-1)[ok], d.reshape(-1)[ok]
    u, v, w = np.concatenate([u, v]), np.concatenate([v, u]), np.concatenate([w, w])
    # an edge found from both ends once
    order = np.lexsort((w, v, u))
    u, v, w = u[order], v[order], w[order]
    first = np.ones(len(u), bool)
    first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    return u[first], v[first], w[first]


def _predecessors(u, v, w, dist, roots, n):
    """Lowest qualifying neighbour u of each v, or -1."""
    du, dv = dist[u], dist[v]
    tol = 1e-5 * np.abs(dv) + 1e-5
    hit = np.isfinite(dv) & (du + w <= dv + tol) & ((du < dv) | ((du == dv) & (u < v)))
    pred = np.full(n, n, np.int64)
    np.minimum.at(pred, v[hit], u[hit])
    pred[pred == n] = -1
    pred[roots] = -1
    return pred


def _root_distance(pts, pred):
    n = len(pts)
    step = np.where(pred >= 0, np.linalg.norm(pts - pts[np.maximum(pred, 0)], axis=1), 0.0)
    d, p = step.copy(), pred.copy()
    for _ in range(max(int(n - 1).bit_length(), 1)):
        has = p >= 0
        pc = np.maximum(p, 0)
        d = d + np.where(has, d[pc], 0.0)
        p = np.where(has, p[pc], p)
    return d


def _trace(pts, radii, pred, seed_dist, max_branches):
    """The greedy loop: [(path vertices root-side first, parent branch)]."""
    n = len(pts)
    tree = cKDTree(pts)
    dist = seed_dist.copy()
    allocated = np.zeros(n, bool)
    branch_of = np.full(n, -1, np.int64)
    out = []
    while len(out) < max_branches:
        far = int(np.argmax(dist))
        if not dist[far] > 0:
            break
        path, v = [], far
        while v >= 0 and not allocated[v]:
            path.append(v)
            v = int(pred[v])
        path = np.asarray(path[::-1], np.int64)
        parent = int(branch_of[v]) if v >= 0 else -1
        cand = np.unique(np.concatenate(
            [np.asarray(c, np.int64) for c in tree.query_ball_point(pts[path], radii[path])]
            + [np.zeros(0, np.int64)]))
        cand = cand[dist[cand] >= 0]
        near_d, near_j = cKDTree(pts[path]).query(pts[cand])
        on = cand[near_d < radii[path][near_j]]
        allocated[on] = True
        allocated[path] = True
        dist[on] = -1.0
        dist[path] = -1.0
        if len(path) >= 2:
            branch_of[on] = len(out)
            branch_of[path] = len(out)
            out.append((path, parent))
    return out


def _prune(branches, min_radius, min_length):
    keep = {0: branches[0]}
    for bid, (xyz, radii, parent) in branches.items():
        if parent not in keep and bid != 0:
            continue
        if np.linalg.norm(np.diff(xyz, axis=0), axis=1).sum() < min_length:
            continue
        if max(radii[0], radii[-1]) < min_radius:
            continue
        keep[bid] = (xyz, radii, parent)
    return keep


def _repair(branches):
    for bid, (xyz, radii, parent) in list(branches.items()):
        if parent not in branches or len(xyz) == 0:
            continue
        pxyz, prad = branches[parent][0], branches[parent][1]
        if len(pxyz) < 2:
            continue
        a, b = pxyz[:-1], pxyz[1:]
        ab = b - a
        t = np.clip(((xyz[0] - a) * ab).sum(1) / ((ab * ab).sum(1) + 1e-12), 0.0, 1.0)
        proj = a + t[:, None] * ab
        r = (1 - t) * prad[:-1] + t * prad[1:]
        best = int(np.argmin(np.abs(np.linalg.norm(proj - xyz[0], axis=1) - r)))
        branches[bid] = (np.concatenate([proj[best][None], xyz]),
                         np.concatenate([radii[:1], radii]), parent)


def _smooth(branches, kernel_size):
    kernel = np.ones(kernel_size) / kernel_size
    for bid, (xyz, radii, parent) in branches.items():
        if len(radii) > kernel_size:
            branches[bid] = (xyz, np.convolve(radii, kernel, mode="same"), parent)


def skeletonize(xyz, medial_vector, class_l, s):
    """Skeletons of the points of `s["branch_classes"]`: [[(xyz, radii)]],
    each skeleton's branches in id order, after the post-processing."""
    sel = np.isin(np.asarray(class_l).reshape(-1), s["branch_classes"])
    surf = np.asarray(xyz, np.float32)[sel]
    mv = np.asarray(medial_vector, np.float32)[sel]
    # the medial points and radii as the labelled cloud states them, in
    # float32; everything after in float64
    medial = (surf + mv).astype(np.float64)
    radius = np.sqrt((mv ** 2).sum(axis=1)).astype(np.float64)
    surf = surf.astype(np.float64)
    keep = _outlier_keep(medial, np.maximum(radius, s["min_filter_radius"]), 8)
    rows = np.flatnonzero(keep)[_reduce(medial[keep], surf[keep, 1], s["medial_quantize"])]
    pts, radius, sy = medial[rows], radius[rows], surf[rows, 1]
    n = len(pts)
    if n == 0:
        return []
    u, v, w = _graph(pts, np.maximum(radius, s["min_connection_length"]), s["K"])
    g = coo_matrix((w, (u, v)), shape=(n, n)).tocsr()
    _, comp = connected_components(g, directed=False)
    label = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(label, comp, np.arange(n))
    label = label[comp]
    sizes = np.bincount(label, minlength=n)
    ids = np.flatnonzero(sizes >= s["minimum_graph_vertices"])
    ids = ids[np.lexsort((ids, -sizes[ids]))][: s["max_components"]]
    roots = np.asarray([np.flatnonzero(label == c)[np.argmin(sy[label == c])] for c in ids],
                       np.int64)
    dist = dijkstra(g, directed=False, indices=roots, min_only=True) if len(roots) else \
        np.full(n, np.inf)
    pred = _predecessors(u, v, w, dist, roots, n)
    seed = np.where((pred > 0) & np.isin(label, ids), _root_distance(pts, pred), -1.0)
    seed = np.where(np.isfinite(seed), seed, -1.0)
    per_comp = {}
    local = {}
    for gid, (path, parent) in enumerate(_trace(pts, radius, pred, seed, s["max_branches"])):
        comp_branches = per_comp.setdefault(int(label[path[0]]), {})
        local[gid] = len(comp_branches)
        comp_branches[len(comp_branches)] = (pts[path], radius[path],
                                             local.get(parent, -1) if parent >= 0 else -1)
    skeletons = [per_comp[int(c)] for c in ids if per_comp.get(int(c))]
    if s["prune_skeletons"] and skeletons:
        skeletons[0] = _prune(skeletons[0], s["min_skeleton_radius"], s["min_skeleton_length"])
    for branches in skeletons:
        if s["repair_skeletons"]:
            _repair(branches)
        if s["smooth_skeletons"]:
            _smooth(branches, s["smooth_kernel_size"])
    return [[(x, r) for x, r, _ in b.values()] for b in skeletons]
