"""Host-side cloud augmentations used by inference (counterpart of
`smart_tree_tpu/data/augmentations.py`: `CentreCloud`,
`AugmentationPipeline`)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np

from .cloud import Cloud


class Augmentation(ABC):
    @abstractmethod
    def __call__(self, cloud: Cloud, rng: np.random.Generator) -> Cloud:
        ...


class CentreCloud(Augmentation):
    """Translate the bbox centre to the origin, keeping the y base."""

    def __call__(self, cloud, rng=None):
        centre, (x, y, z) = cloud.bbox
        offset = -centre + np.asarray([0, y, 0], centre.dtype)
        return Cloud(
            cloud.xyz + offset,
            cloud.rgb,
            medial_vector=cloud.medial_vector,
            branch_direction=cloud.branch_direction,
            branch_ids=cloud.branch_ids,
            class_l=cloud.class_l,
            filename=cloud.filename,
        )


class AugmentationPipeline(Augmentation):
    def __init__(self, augmentations: Sequence[Augmentation]):
        self.augmentations = list(augmentations)

    def __call__(self, cloud, rng=None):
        rng = rng or np.random.default_rng()
        for aug in self.augmentations:
            cloud = aug(cloud, rng)
        return cloud
