"""Batch helpers (counterpart of `smart_tree_tpu/train/helper.py`): turn padded
batched predictions back into per-item labelled Clouds."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.cloud import Cloud


def split_by_batch(coords: np.ndarray, valid: np.ndarray, batch_size: int):
    """Row indices per batch item."""
    b = np.asarray(coords)[:, 0]
    v = np.asarray(valid)
    return [np.nonzero(v & (b == i))[0] for i in range(batch_size)]


def to_labelled_clouds(
    preds: Dict[str, np.ndarray],
    feats: np.ndarray,
    coords: np.ndarray,
    valid: np.ndarray,
    batch_size: int,
    filenames=(),
) -> List[Cloud]:
    """Per-item Clouds with predicted medial vectors and class labels
    (medial_vector = exp(radius) * direction, class = argmax)."""
    radius = np.asarray(preds["radius"])
    direction = np.asarray(preds["direction"])
    class_l = np.asarray(preds["class_l"])
    feats = np.asarray(feats)
    clouds = []
    for i, rows in enumerate(split_by_batch(coords, valid, batch_size)):
        medial_vector = np.exp(radius[rows]) * direction[rows]
        clouds.append(
            Cloud(
                xyz=feats[rows, :3],
                rgb=feats[rows, 3:6] if feats.shape[1] >= 6 else None,
                medial_vector=medial_vector,
                class_l=np.argmax(class_l[rows], axis=1, keepdims=True).astype(
                    np.float32
                ),
                filename=filenames[i] if i < len(filenames) else None,
            )
        )
    return clouds
