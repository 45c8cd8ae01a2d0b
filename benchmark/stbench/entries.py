"""The program's entries a traffic mix drives, built from a configuration's
file: the system under test and nothing else is imported from the program.

  segment   `ModelInference.forward`: a cloud in, the labelled cloud out
  pipeline  `Pipeline.process_cloud`: a cloud in, the skeleton and four
            PLYs out (written to a directory of their own under TMPDIR,
            deleted once the cloud is done)

An entry returns, for each cloud, the labelled cloud the forward produced
and the skeleton (None for `segment`), and says what the program's
forward saw (`prepare`), which the reference is handed in its place.
`ModelInference` loads the configuration's checkpoint file
(stbench/weights.py: the repository's, or a seeded draw of its
architecture) with the architecture's `inference_kwargs(model)`, if any.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

from . import generator, spec
from .spec import ROOT
from .weights import weights_path

PLYS = ("skeleton.ply", "mesh.ply", "cloud.ply", "seg_cld.ply")


def _model_inference(cfg, device, root):
    from smart_tree_tpu_torch.infer.inference import ModelInference

    m = cfg["model"]
    arch = spec.arch_module(spec.arch_name(m), root)
    extra = arch.inference_kwargs(m) if hasattr(arch, "inference_kwargs") else {}
    return ModelInference(str(weights_path(cfg, root)), voxel_size=m["voxel_size"],
                          block_size=m["block_size"], buffer_size=m["buffer_size"],
                          batch_size=m["batch_size"], precision=m["precision"],
                          medial_classes=m["medial_classes"], device=device, **extra)


def _cloud(xyz, rgb):
    from smart_tree_tpu_torch.data.cloud import Cloud

    return Cloud(xyz=xyz, rgb=rgb)


class Segment:
    """ModelInference.forward alone."""

    def __init__(self, cfg, device, root=ROOT):
        self.mi = _model_inference(cfg, device, root)

    @staticmethod
    def prepare(xyz):
        return xyz

    def __call__(self, xyz, rgb, stats=None):
        return self.mi.forward(_cloud(xyz, rgb)), None

    def unet_passes(self):
        return len(self.mi.plan_rows)


class PipelineEntry:
    """Pipeline.process_cloud with the configuration's skeletoniser and
    post-processing; the forward's output is kept as it passes."""

    def __init__(self, cfg, device, root=ROOT):
        from smart_tree_tpu_torch.data.augmentations import AugmentationPipeline, CentreCloud
        from smart_tree_tpu_torch.infer.pipeline import Pipeline
        from smart_tree_tpu_torch.skeleton.skeletonize import Skeletonizer

        self.mi = _model_inference(cfg, device, root)
        sk = Skeletonizer(device=device, **cfg["skeletonizer"])
        p = cfg["pipeline"]
        self.pipeline = Pipeline(
            AugmentationPipeline([CentreCloud()]), self.mi, sk,
            repair_skeletons=p["repair_skeletons"], smooth_skeletons=p["smooth_skeletons"],
            smooth_kernel_size=p["smooth_kernel_size"], prune_skeletons=p["prune_skeletons"],
            min_skeleton_radius=p["min_skeleton_radius"],
            min_skeleton_length=p["min_skeleton_length"], save_outputs=True,
            branch_classes=p["branch_classes"])
        self._seen = []
        forward = self.mi.forward

        def kept(cloud, *a, **k):
            out = forward(cloud, *a, **k)
            self._seen.append(out)
            return out

        self.mi.forward = kept

    @staticmethod
    def prepare(xyz):
        return generator.centre(xyz)

    def __call__(self, xyz, rgb, stats=None):
        self._seen.clear()
        with tempfile.TemporaryDirectory(prefix="plys-") as d:
            self.pipeline.save_path = d
            skel = self.pipeline.process_cloud(cloud=_cloud(xyz, rgb), stats=stats)
            missing = [f for f in PLYS if not (Path(d) / f).is_file()]
        if missing:
            raise RuntimeError(f"the pipeline wrote no {missing}")
        return self._seen[-1], [[(b.xyz, b.radii[:, 0]) for b in s.branches.values()]
                                for s in skel.skeletons]

    def unet_passes(self):
        return len(self.mi.plan_rows)


ENTRIES = {"segment": Segment, "pipeline": PipelineEntry}


def make_entry(cfg, mix, device, root=ROOT):
    """The entry of `mix` over configuration `cfg`, its drawn weights (if
    any) kept in the checkout `root`."""
    return ENTRIES[mix["entry"]](cfg, device, root)


def labelled_arrays(cloud):
    """(xyz, medial vector, class) of a labelled cloud, as numpy arrays."""
    return (np.asarray(cloud.xyz, np.float32), np.asarray(cloud.medial_vector, np.float32),
            np.asarray(cloud.class_l).reshape(-1))
