"""Minimal Hydra-compatible config system (counterpart of
`smart_tree_tpu/utils/configs.py`): YAML configs with `_target_` /
`_partial_` recursive instantiation, `${dotted.path}` interpolation against
the config root, and `key=value` / `+key=value` CLI overrides.

PyYAML is imported only where YAML text is parsed (`load_yaml`, and override
values where it is installed), so `instantiate`, the override engine and the
default configurations as dicts (`DEFAULT_PIPELINE`, `DEFAULT_TRAINING`) work
on a host without it.
"""

from __future__ import annotations

import copy
import functools
import importlib
import json
import re
from pathlib import Path
from typing import Any, Dict, List

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_PART = re.compile(r"\$\{([^}]+)\}")


# conf/pipeline.yaml composed, key for key (a test holds the two equal)
DEFAULT_PIPELINE: Dict[str, Any] = {
    "_target_": "smart_tree_tpu_torch.infer.pipeline.Pipeline",
    "preprocessing": {
        "_target_": "smart_tree_tpu_torch.data.augmentations.AugmentationPipeline",
        "augmentations": [
            {"_target_": "smart_tree_tpu_torch.data.augmentations.CentreCloud"},
        ],
    },
    "model_inference": {
        "_target_": "smart_tree_tpu_torch.infer.inference.ModelInference",
        "weights_path": "smart_tree_tpu/weights/noble-elevator-58.npz",
        "voxel_size": 0.01,
        "block_size": 4,
        "buffer_size": 0.4,
        "batch_size": 4,
        "precision": "float32",
        "medial_classes": [0],
    },
    "skeletonizer": {
        "_target_": "smart_tree_tpu_torch.skeleton.skeletonize.Skeletonizer",
        "K": 16,
        "min_connection_length": 0.02,
        "minimum_graph_vertices": 32,
    },
    "view_model_output": False,
    "view_skeletons": False,
    "save_path": "./outputs",
    "save_outputs": True,
    "branch_classes": [0],
    "cmap": [[0.450, 0.325, 0.164], [0.541, 0.670, 0.164]],
    "repair_skeletons": True,
    "smooth_skeletons": True,
    "smooth_kernel_size": 11,
    "prune_skeletons": True,
    "min_skeleton_radius": 0.01,
    "min_skeleton_length": 0.02,
}


# conf/training.yaml as loaded, interpolations unresolved so that an override
# of `voxel_size` or `directory` reaches every dataset (a test holds the two
# equal)
_AUG = "smart_tree_tpu_torch.data.augmentations."


def _training_dataset(mode: str, augmentations: List[Dict[str, Any]],
                      cache: bool | None = None) -> Dict[str, Any]:
    node: Dict[str, Any] = {
        "_target_": "smart_tree_tpu_torch.data.dataset.TreeDataset",
        "mode": mode,
        "voxel_size": "${voxel_size}",
        "directory": "${directory}",
        "json_path": "${json_path}",
        "input_features": "${input_features}",
        "target_features": "${target_features}",
    }
    if cache is not None:
        node["cache"] = cache
    node["augmentation"] = {
        "_target_": _AUG + "AugmentationPipeline",
        "augmentations": augmentations,
    }
    return node


def _crop() -> Dict[str, Any]:
    return {"_target_": _AUG + "RandomCubicCrop", "size": 4.0}


DEFAULT_TRAINING: Dict[str, Any] = {
    "wandb": {"project": "tree", "entity": None, "mode": "disabled"},
    "seed": 1,
    "fp16": False,
    "num_epoch": 100,
    "lr_decay": True,
    "lr": 0.01,
    "direction_loss": "cosine",
    "direction_min_radius": None,
    "feature_mode": "local",
    "early_stop_epoch": 20,
    "early_stop": True,
    "batch_size": 4,
    "directory": "data/synthetic-trees",
    "json_path": "data/synthetic-trees/split.json",
    "voxel_size": 0.01,
    "batch_capacity": 98304,
    "spatial_shape": [416, 416, 416],
    "output_dir": "runs",
    "resume": None,
    "warm_start": None,
    "capture_output": 10,
    "input_features": ["xyz"],
    "target_features": ["radius", "direction", "class_l"],
    "train_dataset": _training_dataset(
        "train",
        [
            {"_target_": _AUG + "RandomRotateY"},
            {"_target_": _AUG + "RandomScale", "min_scale": 0.8, "max_scale": 1.2},
            _crop(),
            {"_target_": _AUG + "RandomDropout", "max_drop_out": 0.3},
        ],
        cache=True,
    ),
    "test_dataset": _training_dataset("test", [_crop()]),
    "validation_dataset": _training_dataset("validation", [_crop()], cache=True),
    "model": {
        "input_channels": 4,
        "unet_planes": [8, 16, 32, 64],
        "radius_fc_planes": [8, 8, 4, 1],
        "direction_fc_planes": [8, 8, 4, 3],
        "class_fc_planes": [8, 8, 4, 2],
    },
}


def default_pipeline_config() -> Dict[str, Any]:
    """A fresh copy of DEFAULT_PIPELINE for the caller to edit."""
    return copy.deepcopy(DEFAULT_PIPELINE)


def default_training_config() -> Dict[str, Any]:
    """A fresh copy of DEFAULT_TRAINING (unresolved) for the caller to edit."""
    return copy.deepcopy(DEFAULT_TRAINING)


def load_yaml(path) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _get_path(root: Dict[str, Any], dotted: str):
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def resolve(node: Any, root: Dict[str, Any]) -> Any:
    """Resolve ${...} interpolations recursively."""
    if isinstance(node, dict):
        return {k: resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [resolve(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:
            return resolve(_get_path(root, m.group(1)), root)
        if _INTERP_PART.search(node):
            return _INTERP_PART.sub(
                lambda mm: str(resolve(_get_path(root, mm.group(1)), root)), node
            )
    return node


def _import_target(target: str):
    module, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def instantiate(node: Any, **overrides) -> Any:
    """Recursively instantiate `_target_` nodes (hydra.utils.instantiate
    subset: _partial_, positional-free kwargs)."""
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return {k: instantiate(v) for k, v in node.items()}
    target = _import_target(node["_target_"])
    partial = bool(node.get("_partial_", False))
    kwargs = {
        k: instantiate(v)
        for k, v in node.items()
        if k not in ("_target_", "_partial_")
    }
    kwargs.update(overrides)
    if partial:
        return functools.partial(target, **kwargs)
    return target(**kwargs)


def _parse_value(text: str) -> Any:
    """The value of a key=value override: YAML where PyYAML is installed,
    else the JSON subset of it (numbers, true / false / null in any case,
    [lists], "strings") with anything else taken as a plain string."""
    try:
        import yaml
    except ImportError:
        word = text.strip().lower()
        if word in ("true", "false", "null"):
            return {"true": True, "false": False, "null": None}[word]
        try:
            value = json.loads(text)
        except ValueError:
            return text
        if isinstance(value, float) and "." not in text:
            return text  # PyYAML reads "1e-3" as a string: a float needs its dot
        return value
    return yaml.safe_load(text)


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """key=value and +key=value (add) CLI overrides, dotted paths."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        key, val = ov.split("=", 1)
        key = key.lstrip("+")
        parsed = _parse_value(val)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parsed
    return cfg


def compose(config_path, overrides: List[str] | None = None) -> Dict[str, Any]:
    cfg = load_yaml(config_path)
    if "defaults" in cfg:
        # Hydra defaults-list composition (config groups) is out of scope:
        # the shipped configs do not use it, and failing beats silently not
        # composing
        raise NotImplementedError(
            "hydra 'defaults:' composition is not supported by the built-in "
            "config engine; inline the composed keys or install hydra"
        )
    if overrides:
        cfg = apply_overrides(cfg, list(overrides))
    return resolve(cfg, cfg)


def default_conf_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "conf"
