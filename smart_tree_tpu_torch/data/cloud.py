"""Cloud: the point-cloud domain type (numpy arrays on the host).

Counterpart of `smart_tree_tpu/data/cloud.py` without the pytree
registration: medial_pts = xyz + medial_vector, radius = |medial_vector|,
direction its normalised form. scale / translate / rotate drop the labels, as
the original smart-tree's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_ARRAY_FIELDS = (
    "xyz",
    "rgb",
    "medial_vector",
    "branch_direction",
    "branch_ids",
    "class_l",
)


@dataclass
class Cloud:
    xyz: np.ndarray
    rgb: Optional[np.ndarray] = None
    medial_vector: Optional[np.ndarray] = None
    branch_direction: Optional[np.ndarray] = None
    branch_ids: Optional[np.ndarray] = None
    class_l: Optional[np.ndarray] = None
    filename: Optional[Path] = None

    def __len__(self):
        return int(self.xyz.shape[0])

    def __str__(self):
        return f"Cloud with {self.xyz.shape[0]} points" + (
            f" ({self.filename})" if self.filename else ""
        )

    def _map(self, fn) -> "Cloud":
        kw = {
            f: (fn(getattr(self, f)) if getattr(self, f) is not None else None)
            for f in _ARRAY_FIELDS
        }
        return Cloud(**kw, filename=self.filename)

    def filter(self, mask_or_idx) -> "Cloud":
        return self._map(lambda a: a[mask_or_idx])

    def filter_by_class(self, classes) -> "Cloud":
        return self.filter(np.isin(self.class_l.reshape(-1), np.asarray(classes)))

    def filter_by_skeleton(self, skeleton, threshold: float = 1.1, device=None) -> "Cloud":
        """Keep the points within threshold * radius of the skeleton's tubes.
        The point-tube queries run on the card unless `device` names another."""
        from ..data.tube import collate_tubes
        from ..utils.queries import skeleton_to_points

        dists, radii, _ = skeleton_to_points(
            np.asarray(self.xyz), collate_tubes(skeleton.to_tubes()), device=device
        )
        return self.filter(dists < radii * threshold)

    # transforms (drop labels)
    def scale(self, factor) -> "Cloud":
        return Cloud(self.xyz * factor, self.rgb, filename=self.filename)

    def translate(self, offset) -> "Cloud":
        return Cloud(self.xyz + offset, self.rgb, filename=self.filename)

    def rotate(self, rot_mat) -> "Cloud":
        return Cloud(self.xyz @ rot_mat, self.rgb, filename=self.filename)

    @property
    def root_idx(self) -> int:
        """The lowest point (y is up)."""
        return int(np.argmin(self.xyz[:, 1]))

    @property
    def min_xyz(self):
        return self.xyz.min(axis=0)

    @property
    def max_xyz(self):
        return self.xyz.max(axis=0)

    @property
    def bbox(self):
        dims = (self.max_xyz - self.min_xyz) / 2
        return self.min_xyz + dims, dims

    @property
    def medial_pts(self):
        return self.xyz + self.medial_vector

    @property
    def radius(self):
        return np.sqrt((self.medial_vector**2).sum(axis=1))

    @property
    def direction(self):
        return self.medial_vector / (self.radius[:, None] + 1e-12)

    @property
    def number_classes(self) -> int:
        if self.class_l is None:
            return 1
        return int(self.class_l.max()) + 1

    @staticmethod
    def from_numpy(**kwargs) -> "Cloud":
        out = {}
        for key, value in kwargs.items():
            if key in _ARRAY_FIELDS:
                out[key] = np.asarray(value, np.float32)
            elif key == "vector":  # legacy synthetic-trees npz schema
                out["medial_vector"] = np.asarray(value, np.float32)
            elif key == "filename":
                out["filename"] = value
        return Cloud(**out)
