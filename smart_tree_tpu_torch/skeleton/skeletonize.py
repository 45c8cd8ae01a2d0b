"""Skeletonizer: medial cloud -> DisjointTreeSkeleton (counterpart of
`smart_tree_tpu/skeleton/skeletonize.py`).

Stages:
  1. outlier_removal on medial points              (filter.py)
  2. medial_reduce to one point per cell           (quantize.py)
  3. nn_graph, radius clamped to min_connection    (graph.py, K=16)
  4. neighbor table + aligned chain shortcuts      (graph/table.py, shortcuts.py)
  5. connected components >= minimum_graph_vertices, largest first
  6. multi-source SSSP from each component's lowest-y surface point ->
     predecessor forest -> pointer-doubled root distances
  7. greedy branch extraction over all selected components (path.py)

Components never leave the device and are never renumbered. There is one
graph formulation, the gather form over the neighbor table, for the CPU and
the card alike. The cloud's arrays go up once; labels, sizes and the packed
branch encoding come down once.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..data.cloud import Cloud
from ..data.tree import DisjointTreeSkeleton, TreeSkeleton
from ..device import resolve_device
from ..graph.components import _cc_rounds, component_sizes
from ..graph.shortcuts import chain_shortcut_table
from ..graph.sssp import _bf_rounds, _dist_init, _pred_tbl, tree_distances
from ..graph.table import _build as _table_build
from ..graph.table import symmetrized
from ..utils.trace import span
from .filter import outlier_removal
from .graph import nn_graph
from .path import sample_forest
from .quantize import medial_reduce

log = logging.getLogger(__name__)


def _component_roots(labels, keep, y, comp_ids):
    """Lowest-y surface vertex per component, all components at once: the
    min y per label bucket, then the min vertex id among that component's
    y-minimizers. comp_ids -1 (padding) gives root -1."""
    n = y.shape[0]
    inf = float("inf")
    ymin = torch.full((n,), inf, device=y.device).scatter_reduce_(
        0, labels, torch.where(keep, y, inf), "amin", include_self=True)
    is_min = keep & (y == ymin[labels])
    vid = torch.arange(n, dtype=torch.int64, device=y.device)
    root_of = torch.full((n,), n, dtype=torch.int64, device=y.device).scatter_reduce_(
        0, labels, torch.where(is_min, vid, n), "amin", include_self=True)
    roots = root_of[comp_ids.clamp(0, n - 1)]
    return torch.where((comp_ids >= 0) & (roots < n), roots, -1)


def _select_components(sizes, min_vertices: int, max_components: int):
    """Ids of the `max_components` largest components with at least
    `min_vertices` vertices, largest first and the lowest id first among
    equal sizes; -1 padded. Labels are min vertex ids, so `sizes` is nonzero
    exactly at component roots."""
    top_sizes, comp_ids = torch.sort(sizes, descending=True, stable=True)
    top_sizes, comp_ids = top_sizes[:max_components], comp_ids[:max_components]
    return torch.where(top_sizes >= min_vertices, comp_ids, -1)


@contextlib.contextmanager
def _stage(stats, dev, name: str, key: str):
    """One stage as a span (utils/trace.py): with `stats` its seconds go to
    `stats[key]`, the device synchronised at the stage's end so that they
    hold its kernels."""
    with span(stats, name, key):
        yield
        if stats is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)


@dataclass
class Skeletonizer:
    K: int = 16
    min_connection_length: float = 0.02
    minimum_graph_vertices: int = 32
    hop_cap: int = 4096
    max_components: int = 64
    max_branches: int = 1024
    strict: bool = True  # raise on hop/branch-cap truncation (see path.py)
    # clamp outlier-filter acceptance radii so sub-voxel twigs survive (see
    # filter.py); None filters by the predicted radius alone
    min_filter_radius: float | None = 0.02
    # aligned chain shortcuts (graph/shortcuts.py): composite relaxation
    # edges collapse the Bellman-Ford and label-propagation round counts on
    # filament graphs; results unchanged up to float addition order
    sssp_shortcuts: bool = True
    # one representative medial point per cell of this size before the graph
    # is built (quantize.py); the default is the pipeline's inference voxel
    # size. None = the full unreduced graph
    medial_quantize: float | None = 0.01
    # the one field beyond the JAX dataclass: None means the card
    device: str | None = None

    def __post_init__(self):
        # fail at construction, not after minutes of inference, when no card
        # is there; on a card this also switches TF32 off
        resolve_device(self.device)

    def _graph_stage(self, medial_pts, radii, y, keep, stats):
        """KNN graph -> shortcut table -> neighbor table -> components ->
        selection -> roots -> SSSP -> predecessors -> root distances."""
        n = medial_pts.shape[0]
        k = self.K
        dev = medial_pts.device
        with _stage(stats, dev, "skeleton.knn_graph", "knn_graph_s"):
            graph = nn_graph(medial_pts, radii.clamp_min(self.min_connection_length),
                             k=k, valid=keep)

        with _stage(stats, dev, "graph.table_shortcuts", "table_shortcuts_s"):
            sc = (None, None)
            if self.sssp_shortcuts:
                sc = chain_shortcut_table(
                    graph.edges[:, 1].reshape(n, k),
                    graph.weights.reshape(n, k),
                    graph.valid.reshape(n, k),
                )
            flat = symmetrized(graph.edges, graph.weights, graph.valid)
            cap = 4 * k
            while True:
                table, overflow = _table_build(*flat, n, cap)
                if overflow == 0:
                    break
                cap *= 2
                log.info("skeletonize: neighbor-table overflow, cap -> %d", cap)

        with _stage(stats, dev, "graph.components", "components_s"):
            labels, cc_rounds = _cc_rounds(table.idx, table.w, n, *sc)
            labels = torch.where(keep, labels, torch.arange(n, device=labels.device))
            sizes = component_sizes(labels, keep)
            comp_ids = _select_components(sizes, self.minimum_graph_vertices,
                                          self.max_components)
            roots = _component_roots(labels, keep, y, comp_ids)

        with _stage(stats, dev, "graph.sssp", "sssp_s"):
            tol = 1e-6 if self.sssp_shortcuts else 0.0
            dist, rounds = _bf_rounds(table.idx, table.w, _dist_init(roots, n), tol, *sc)
            preds = _pred_tbl(table, roots, dist, n)
            hop = medial_pts - medial_pts[preds.clamp_min(0)]
            step = torch.sqrt((hop * hop).sum(dim=1))
            root_dist = tree_distances(preds, step, n)
        if stats is not None:
            stats.update(table_cap=cap, cc_rounds=cc_rounds, sssp_rounds=rounds)
        return labels, sizes, comp_ids, preds, root_dist

    @torch.no_grad()
    def forward(self, cloud: Cloud, stats: dict | None = None) -> DisjointTreeSkeleton:
        """`stats`, when given, receives the seconds of each stage (the
        device is then synchronised at stage ends), the stage's counts and
        the tracer's host fetches and greedy iterations (`tracer_fetches`,
        `tracer_iterations`, path.py)."""
        dev = resolve_device(self.device)
        if len(cloud) == 0:
            return DisjointTreeSkeleton([])

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        with _stage(stats, dev, "skeleton.upload", "upload_s"):
            medial_pts, radii, xyz = up(cloud.medial_pts), up(cloud.radius), up(cloud.xyz)

        with _stage(stats, dev, "skeleton.outlier_filter", "outlier_filter_s"):
            keep = outlier_removal(
                medial_pts, radii, nb_points=8, min_radius=self.min_filter_radius
            )
        if stats is not None:
            stats["medial_points"] = int(medial_pts.shape[0])

        with _stage(stats, dev, "skeleton.reduce", "reduce_s"):
            if self.medial_quantize:
                rep_idx, n_unique = medial_reduce(
                    medial_pts, xyz[:, 1], keep, self.medial_quantize
                )
                medial_pts, radii, xyz = medial_pts[rep_idx], radii[rep_idx], xyz[rep_idx]
                keep = torch.ones(n_unique, dtype=torch.bool, device=dev)
                log.info("skeletonize: medial_quantize %.3f m -> %d unique cells",
                         self.medial_quantize, n_unique)
        n = int(medial_pts.shape[0])
        if stats is not None:
            stats["graph_vertices"] = n
        if n == 0:
            return DisjointTreeSkeleton([])

        labels, sizes, comp_ids_d, preds, root_dist = self._graph_stage(
            medial_pts, radii, xyz[:, 1], keep, stats
        )

        with _stage(stats, dev, "skeleton.tracer", "tracer_s"):
            comp_ids = comp_ids_d[comp_ids_d >= 0]
            union_mask = keep & torch.isin(labels, comp_ids)
            labels_np, sizes_np = torch.stack([labels, sizes]).cpu().numpy()
            comp_ids = comp_ids.cpu().numpy()
            host_pts, host_radii = medial_pts.cpu().numpy(), radii.cpu().numpy()

            # ONE tracer run over the union of all selected components
            per_comp = sample_forest(
                medial_pts, radii, preds, root_dist, union_mask, labels_np,
                hop_cap=self.hop_cap, max_branches=self.max_branches,
                strict=self.strict, host_pts=host_pts, host_radii=host_radii,
                stats=stats,
            )

            skeletons: List[TreeSkeleton] = []
            for skeleton_id, comp in enumerate(comp_ids):
                branches = per_comp.get(int(comp), {})
                log.info("component %d: %d vertices -> %d branches",
                         skeleton_id, int(sizes_np[comp]), len(branches))
                if branches:
                    skeletons.append(TreeSkeleton(skeleton_id, branches))
        return DisjointTreeSkeleton(skeletons)
