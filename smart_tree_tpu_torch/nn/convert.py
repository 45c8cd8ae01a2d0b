"""Checkpoints into the port's state_dict, and back.

The shipped checkpoints (`smart_tree_tpu/weights/*.npz`) store flax
variables as "<collection>/<module path>/<leaf>" arrays. The port's module
names reproduce the flax paths, so a state_dict key is the path without the
collection, joined with dots: "params/UNet/Head/sequence.0/weight" becomes
"UNet.Head.sequence.0.weight" and "batch_stats/.../sequence.1/mean" becomes
"....sequence.1.mean". Conv weights keep the [K3, Cin, Cout] layout.

The way back (`variables_from_model`, `save_npz`) splits a state_dict key
into the flax path again, so a checkpoint the port writes loads in the JAX
package's `load_npz` and in the port's own.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .model import SmartTree

_COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """state_dict from the JAX package's nested variables
    ({"params": ..., "batch_stats": ...}, numpy or jax leaves)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in _COLLECTIONS:
        for path, v in _flatten(variables.get(collection, {})).items():
            sd[".".join(path)] = _tensor(v)
    return sd


def flax_path(key: str) -> tuple:
    """The flax variable path of a state_dict key. flax module names hold
    dots ("Encode.sequence", "sequence.0") and a head's weights are leaves
    named "sequence.<i>.weight", so the key does not split on every dot:

      Encode / Decode / input_conv   "<name>.sequence" is one scope, its
                                     children "0" and "1" the next
      Head / Tail (ResBlock)         "sequence.<i>" and "identity.0" are scopes
      *_head (SparseFC)              "sequence.<i>.weight" is one leaf,
                                     "sequence.<i>" a BatchNorm scope
    """
    t = key.split(".")
    out = []
    i = 0
    while i < len(t):
        if t[i] in ("Encode", "Decode", "input_conv"):
            out.append(f"{t[i]}.{t[i + 1]}")
            i += 2
        elif t[i] in ("sequence", "identity"):
            if t[0].endswith("_head") and t[-1] == "weight":
                out.append(".".join(t[i:]))
                break
            out.append(f"{t[i]}.{t[i + 1]}")
            i += 2
        else:
            out.append(t[i])
            i += 1
    return tuple(out)


def variables_from_model(model: SmartTree) -> Dict[str, Any]:
    """The model's parameters and running statistics as nested numpy dicts
    in the flax layout: {"params": {...}, "batch_stats": {...}}."""
    buffers = {name for name, _ in model.named_buffers()}
    out: Dict[str, Any] = {c: {} for c in _COLLECTIONS}
    for key, v in model.state_dict().items():
        node = out["batch_stats" if key in buffers else "params"]
        *scopes, leaf = flax_path(key)
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v.detach().to(torch.float32).cpu().numpy().copy()
    return out


def save_npz(path, variables: Mapping[str, Any]) -> None:
    """Nested variables to a checkpoint .npz of "<collection>/<path>" arrays."""
    flat = {}
    for collection, tree in variables.items():
        for p, v in _flatten(tree).items():
            flat[collection + "/" + "/".join(p)] = np.asarray(v)
    np.savez_compressed(path, **flat)


def resolve_weights(path) -> Path:
    """A weights path as given, or relative to the repository root."""
    path = Path(path)
    if not path.exists():
        alt = Path(__file__).resolve().parents[2] / path
        if alt.exists():
            return alt
    return path


def load_npz(path) -> Dict[str, torch.Tensor]:
    """state_dict straight from a checkpoint .npz (read-only)."""
    sd: Dict[str, torch.Tensor] = {}
    with np.load(resolve_weights(path)) as data:
        for k in data.files:
            collection, *parts = k.split("/")
            if collection not in _COLLECTIONS:
                raise ValueError(f"unexpected checkpoint entry {k!r}")
            sd[".".join(parts)] = _tensor(data[k])
    return sd


def model_from_variables(sd: Mapping[str, torch.Tensor]) -> SmartTree:
    """SmartTree with the widths recovered from the state_dict's shapes."""
    planes = []
    prefix = "UNet."
    while True:
        planes.append(int(sd[prefix + "Head.sequence.0.weight"].shape[1]))
        if prefix + "U.Head.sequence.0.weight" not in sd:
            break
        prefix += "U."

    def head_planes(h: str):
        idxs = sorted(
            int(k.split(".")[2])
            for k in sd
            if k.startswith(h + ".sequence.") and k.endswith(".weight")
        )
        pl = [int(sd[f"{h}.sequence.{idxs[0]}.weight"].shape[1])]
        pl += [int(sd[f"{h}.sequence.{i}.weight"].shape[2]) for i in idxs]
        return tuple(pl)

    return SmartTree(
        input_channels=int(sd["input_conv.sequence.0.weight"].shape[1]),
        unet_planes=tuple(planes),
        radius_fc_planes=head_planes("radius_head"),
        direction_fc_planes=head_planes("direction_head"),
        class_fc_planes=head_planes("class_head"),
    )


def load_model(sd: Mapping[str, torch.Tensor], device: torch.device) -> SmartTree:
    """An eval-mode SmartTree on `device` holding exactly `sd`."""
    model = model_from_variables(sd)
    model.load_state_dict(dict(sd), strict=True)
    return model.to(device).eval()
