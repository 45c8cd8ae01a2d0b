"""Host-side cloud augmentations (counterpart of
`smart_tree_tpu/data/augmentations.py`, same class names and config surface).

Numpy on the host, inside the input pipeline. Every class draws from the
`np.random.Generator` it is given and in the reference's order of draws, so
one seed gives both packages the same augmented cloud."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np

from ..utils.maths import euler_angles_to_rotation
from .cloud import Cloud


class Augmentation(ABC):
    @abstractmethod
    def __call__(self, cloud: Cloud, rng: np.random.Generator) -> Cloud:
        ...


def _relabelled(cloud: Cloud, xyz, medial_vector=None, branch_direction=None) -> Cloud:
    """`cloud` with new coordinates (and vectors where given), labels kept."""
    return Cloud(
        xyz,
        cloud.rgb,
        medial_vector=cloud.medial_vector if medial_vector is None else medial_vector,
        branch_direction=(cloud.branch_direction if branch_direction is None
                          else branch_direction),
        branch_ids=cloud.branch_ids,
        class_l=cloud.class_l,
        filename=cloud.filename,
    )


class Scale(Augmentation):
    def __init__(self, min_scale=0.9, max_scale=1.1):
        self.min_scale = min_scale
        self.max_scale = max_scale

    def __call__(self, cloud, rng):
        t = rng.uniform(self.min_scale, self.max_scale)
        return cloud.scale(t)


class FixedRotate(Augmentation):
    def __init__(self, xyz):
        self.rot_mat = euler_angles_to_rotation(np.asarray(xyz, np.float32))

    def __call__(self, cloud, rng):
        return cloud.rotate(self.rot_mat.astype(np.float32))


class RandomRotateY(Augmentation):
    """Random rotation about the y (up) axis: keeps gravity-aligned structure
    while decorrelating absolute position and orientation."""

    def __call__(self, cloud, rng):
        a = rng.uniform(0, 2 * np.pi)
        rot = euler_angles_to_rotation([0.0, a, 0.0]).astype(np.float32)
        return _relabelled(
            cloud,
            cloud.xyz @ rot,
            cloud.medial_vector @ rot if cloud.medial_vector is not None else None,
            cloud.branch_direction @ rot if cloud.branch_direction is not None else None,
        )


class RandomScale(Augmentation):
    """Label-aware uniform scale: unlike `Scale` (whose cloud.scale drops
    labels) this also scales the medial vectors, so radius and direction
    targets stay consistent."""

    def __init__(self, min_scale=0.8, max_scale=1.2):
        self.min_scale = min_scale
        self.max_scale = max_scale

    def __call__(self, cloud, rng):
        t = np.float32(rng.uniform(self.min_scale, self.max_scale))
        return _relabelled(
            cloud,
            cloud.xyz * t,
            cloud.medial_vector * t if cloud.medial_vector is not None else None,
        )


class CentreCloud(Augmentation):
    """Translate the bbox centre to the origin, keeping the y base."""

    def __call__(self, cloud, rng=None):
        centre, (x, y, z) = cloud.bbox
        offset = -centre + np.asarray([0, y, 0], centre.dtype)
        return _relabelled(cloud, cloud.xyz + offset)


class VoxelDownsample(Augmentation):
    def __init__(self, voxel_size):
        self.voxel_size = voxel_size

    def __call__(self, cloud, rng=None):
        g = np.floor(cloud.xyz / self.voxel_size).astype(np.int64)
        _, first = np.unique(g, axis=0, return_index=True)
        return cloud.filter(np.sort(first))


class FixedTranslate(Augmentation):
    def __init__(self, xyz):
        self.xyz = np.asarray(xyz, np.float32)

    def __call__(self, cloud, rng=None):
        return cloud.translate(self.xyz)


class RandomCrop(Augmentation):
    def __init__(self, max_x, max_y, max_z):
        self.max_translation = np.asarray([max_x, max_y, max_z], np.float32)

    def __call__(self, cloud, rng):
        offset = (rng.uniform(size=3).astype(np.float32) - 0.5) * self.max_translation
        p = cloud.xyz + offset
        mask = np.logical_and(p >= cloud.min_xyz, p <= cloud.max_xyz).all(axis=1)
        return cloud.filter(mask)


class RandomCubicCrop(Augmentation):
    """A cube of edge `size` around a random point (the training crop)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, cloud, rng):
        pt = cloud.xyz[rng.integers(0, len(cloud))]
        mask = np.logical_and(
            cloud.xyz >= pt - self.size / 2, cloud.xyz <= pt + self.size / 2
        ).all(axis=1)
        return cloud.filter(mask)


class RandomDropout(Augmentation):
    def __init__(self, max_drop_out):
        self.max_drop_out = max_drop_out

    def __call__(self, cloud, rng):
        keep = int((1.0 - self.max_drop_out * rng.uniform()) * len(cloud))
        idx = rng.integers(0, len(cloud), size=keep)
        return cloud.filter(idx)


class AugmentationPipeline(Augmentation):
    def __init__(self, augmentations: Sequence[Augmentation]):
        self.augmentations = list(augmentations)

    def __call__(self, cloud, rng=None):
        rng = rng or np.random.default_rng()
        for aug in self.augmentations:
            cloud = aug(cloud, rng)
        return cloud
