"""Pipeline orchestrator: cloud in -> skeleton out (counterpart of
`smart_tree_tpu/infer/pipeline.py`, same constructor keys and processing
order): preprocess -> NN inference -> class filter -> skeletonize -> prune /
repair / smooth -> save. The interactive views go through viz/viewer.py,
which logs a warning and returns without open3d.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ..data.cloud import Cloud
from ..data.file import load_cloud, save_ply_cloud, save_ply_lineset, save_ply_mesh
from ..data.tree import DisjointTreeSkeleton
from ..device import resolve_device
from ..skeleton.skeletonize import Skeletonizer
from ..utils.trace import span
from .inference import ModelInference

log = logging.getLogger(__name__)


class Pipeline:
    def __init__(
        self,
        preprocessing,
        model_inference: ModelInference,
        skeletonizer: Skeletonizer,
        repair_skeletons: bool = False,
        smooth_skeletons: bool = False,
        smooth_kernel_size: int = 0,
        prune_skeletons: bool = False,
        min_skeleton_radius: float = 0.0,
        min_skeleton_length: float = 1000.0,
        view_model_output: bool = False,
        view_skeletons: bool = False,
        save_outputs: bool = False,
        save_path: str = "/",
        branch_classes=(0,),
        cmap=((1, 0, 0), (0, 1, 0)),
    ):
        # both stages' devices are checked, and TF32 switched off on a card,
        # before any cloud is read
        for stage in (model_inference, skeletonizer):
            if stage is not None:
                resolve_device(stage.device)
        self.preprocessing = preprocessing
        self.model_inference = model_inference
        self.skeletonizer = skeletonizer
        self.repair_skeletons = repair_skeletons
        self.smooth_skeletons = smooth_skeletons
        self.smooth_kernel_size = smooth_kernel_size
        self.prune_skeletons = prune_skeletons
        self.min_skeleton_radius = min_skeleton_radius
        self.min_skeleton_length = min_skeleton_length
        self.view_model_output = view_model_output
        self.view_skeletons = view_skeletons
        self.save_outputs = save_outputs
        self.save_path = save_path
        self.branch_classes = list(branch_classes)
        self.cmap = np.asarray(cmap, np.float32)

    def process_cloud(
        self, path: Optional[Path] = None, cloud: Optional[Cloud] = None,
        stats: dict | None = None,
    ) -> DisjointTreeSkeleton:
        """`stats`, when given, receives the seconds of each stage
        (`inference_s` from the cloud's load through the forward's downloads,
        `skeletonize_s`, `post_process_s`, `save_s`), the forward's own
        (ModelInference.forward) and the skeleton stage's seconds and counts
        (Skeletonizer.forward). The stages are spans (utils/trace.py)."""
        with span(stats, "pipeline.process_cloud"):
            with span(stats, "pipeline.inference", "inference_s"):
                cloud = load_cloud(path) if path is not None else cloud
                log.info("pipeline: %d points in", len(cloud))
                if self.preprocessing is not None:
                    cloud = self.preprocessing(cloud)
                # the forward ends with its downloads, so the host clock is
                # the stage's
                labelled = self.model_inference.forward(cloud, stats=stats)
            log.info("pipeline: inference done (%d labelled points)", len(labelled))
            if self.view_model_output:
                self._view_cloud(labelled)

            with span(stats, "skeleton.forward", "skeletonize_s"):
                branch_cloud = labelled.filter_by_class(self.branch_classes)
                log.info("pipeline: %d branch-class points", len(branch_cloud))
                skeleton = self.skeletonizer.forward(branch_cloud, stats=stats)
            log.info("pipeline: %d skeletons", len(skeleton.skeletons))
            with span(stats, "post.process", "post_process_s"):
                self.post_process(skeleton)

            if self.view_skeletons:
                self._view_skeleton(skeleton, cloud)

            if self.save_outputs:
                with span(stats, "post.save", "save_s"):
                    self.save(skeleton, labelled)
            return skeleton

    def post_process(self, skeleton: DisjointTreeSkeleton) -> None:
        # order: prune -> repair -> smooth
        if self.prune_skeletons:
            skeleton.prune(
                min_length=self.min_skeleton_length,
                min_radius=self.min_skeleton_radius,
            )
        if self.repair_skeletons:
            skeleton.repair()
        if self.smooth_skeletons:
            skeleton.smooth(self.smooth_kernel_size)

    def save(self, skeleton: DisjointTreeSkeleton, labelled: Cloud) -> None:
        from ..viz.mesh import skeleton_lineset, skeleton_tube_mesh

        sp = Path(self.save_path)
        sp.mkdir(parents=True, exist_ok=True)
        verts, edges = skeleton_lineset(skeleton)
        save_ply_lineset(sp / "skeleton.ply", verts, edges)
        mv, mt, mc = skeleton_tube_mesh(skeleton)
        save_ply_mesh(sp / "mesh.ply", mv, mt, mc)
        save_ply_cloud(sp / "cloud.ply", labelled.xyz, labelled.rgb)
        seg_rgb = self.cmap[np.asarray(labelled.class_l).reshape(-1).astype(int)]
        save_ply_cloud(sp / "seg_cld.ply", labelled.xyz, seg_rgb)

    def _view_cloud(self, cloud: Cloud) -> None:
        from ..viz.viewer import view_cloud

        view_cloud(cloud, self.cmap)

    def _view_skeleton(self, skeleton, cloud) -> None:
        from ..viz.viewer import view_skeleton

        view_skeleton(skeleton, cloud)
