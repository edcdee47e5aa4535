"""Weight bridge: the JAX package's Flax variables -> the port's modules.

``load_flax_params(model, params, frozen)`` takes the ``variables["params"]``
and ``variables["frozen"]`` trees as nested dicts of numpy arrays (no JAX
needed) and fills the torch module in place:

* Dense kernels (in, out) become Linear weights (out, in);
* Conv kernels HWIO become OIHW;
* GroupNorm and LayerNorm ``scale`` becomes ``weight``;
* FrozenBatchNorm ``scale/bias/mean/var`` fill the buffers of those names;
* raw parameters (``level_embed``, ``query_embed``, ``depth_pos_embed``)
  keep their names and shapes (the full query table of
  num_queries x group_num rows).

Flax's auto-generated submodule names are mapped by the fixed table
``AUTO_NAMES``, keyed by the torch module that holds them.  Any Flax key
left unused, any shape that differs and any port tensor left unfilled
raises ``ValueError``; nothing is written unless everything matches.

``load_labeler_state`` carries the pseudo-labeller's state across (it has
no learned weights): the template bank and the conv kernels, as numpy.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from monosowa_tpu_torch.models.depth_predictor import (DepthEncoderLayer,
                                                       DepthPredictor)
from monosowa_tpu_torch.models.layers import MLP
from monosowa_tpu_torch.models.monodetr import BBoxEmbed, MonoDETR
from monosowa_tpu_torch.models.transformer import VisualEncoderLayer

_FFN = {"Dense_0": "linear1", "Dense_1": "linear2"}
_MLP = {f"Dense_{i}": f"layers.{i}" for i in range(3)}

AUTO_NAMES: Dict[type, Dict[str, str]] = {
    # monodetr.py:115,119 — one GroupNorm per input projection
    MonoDETR: {f"GroupNorm_{i}": f"input_norm{i}" for i in range(4)},
    # depth_predictor.py:88,103,106 — in call order
    DepthPredictor: {"GroupNorm_0": "proj_norm",
                     "GroupNorm_1": "upsample_norm",
                     "GroupNorm_2": "downsample_norm",
                     "GroupNorm_3": "head1_norm",
                     "GroupNorm_4": "head2_norm"},
    # transformer.py:162-164 and depth_predictor.py:63-65 — the FFNs
    VisualEncoderLayer: _FFN,
    DepthEncoderLayer: _FFN,
    MLP: _MLP,
    BBoxEmbed: _MLP,
}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _torch_name(model: nn.Module, path: Tuple[str, ...], collection: str
                ) -> str:
    mod, names = model, []
    for key in path[:-1]:
        name = AUTO_NAMES.get(type(mod), {}).get(key, key)
        try:
            mod = mod.get_submodule(name)
        except AttributeError:
            raise ValueError(f"Flax {collection}/{'/'.join(path)}: the port "
                             f"has no module {'.'.join(names + [name])}")
        names.append(name)
    leaf = path[-1]
    if collection == "params" and leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join(names + [leaf])


def flax_leaf(model: nn.Module, torch_name: str) -> str:
    """The Flax leaf name of the port tensor ``torch_name``, the inverse of
    ``_torch_name``'s leaf rule: ``kernel`` for the weight of a dense or
    convolution layer, ``scale`` for the weight of a norm, otherwise the
    name's last part (``bias``, ``level_embed``, ``query_embed``, ...)."""
    mod_name, _, leaf = torch_name.rpartition(".")
    if leaf != "weight":
        return leaf
    mod = model.get_submodule(mod_name)
    return "kernel" if isinstance(mod, (nn.Linear, nn.Conv2d)) else "scale"


def _to_torch_layout(arr: np.ndarray, flax_leaf: str) -> np.ndarray:
    if flax_leaf == "kernel" and arr.ndim == 2:
        return arr.T                              # (in, out) -> (out, in)
    if flax_leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    return arr


def load_flax_params(model: nn.Module, params: Mapping,
                     frozen: Mapping = None) -> nn.Module:
    """Fill ``model`` from Flax ``params`` (and ``frozen``) trees."""
    state = model.state_dict(keep_vars=True)
    plan = {}
    errors = []
    for collection, tree in (("params", params), ("frozen", frozen or {})):
        for path, arr in _leaves(tree):
            try:
                name = _torch_name(model, path, collection)
            except ValueError as e:
                errors.append(str(e))
                continue
            arr = _to_torch_layout(arr, path[-1])
            if name not in state:
                errors.append(f"Flax {collection}/{'/'.join(path)} -> "
                              f"{name}: no such port tensor")
            elif tuple(state[name].shape) != arr.shape:
                errors.append(f"Flax {collection}/{'/'.join(path)} -> "
                              f"{name}: shape {arr.shape} != "
                              f"{tuple(state[name].shape)}")
            elif name in plan:
                errors.append(f"{name} filled twice")
            else:
                plan[name] = arr
    unfilled = sorted(set(state) - set(plan))
    if unfilled:
        errors.append(f"port tensors left unfilled: {unfilled}")
    if errors:
        raise ValueError("weight bridge mismatch:\n" + "\n".join(errors))
    with torch.no_grad():
        for name, arr in plan.items():
            t = state[name]
            t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model


def load_labeler_state(labeler, bank_points: np.ndarray,
                       occ_kernels: np.ndarray,
                       memb_kernels: np.ndarray) -> None:
    """Fill a ``sowa.pipeline.PseudoLabeler`` with the state of another
    labeller, as numpy arrays: the template bank (4, T, 3) and the conv
    kernels (NT, Y, K, K) of its first template.  The labeller has no
    learned weights; these arrays are all that its fit depends on.  Shapes
    must match the labeller's own (its ``FitConfig`` fixes the grid)."""
    dev = labeler.device
    for name, arr, want in (
            ("bank_points", bank_points, labeler.bank.points.shape),
            ("occ_kernels", occ_kernels, tuple(labeler.occ_kernels.shape)),
            ("memb_kernels", memb_kernels,
             tuple(labeler.memb_kernels.shape))):
        if tuple(np.shape(arr)) != tuple(want):
            raise ValueError(f"{name}: shape {np.shape(arr)} != "
                             f"{tuple(want)}")
    labeler.bank.points = np.array(bank_points, dtype=np.float32)
    labeler.template = torch.as_tensor(labeler.bank.points[0], device=dev)
    labeler.occ_kernels = torch.as_tensor(
        np.array(occ_kernels, dtype=np.float32), device=dev)
    labeler.memb_kernels = torch.as_tensor(
        np.array(memb_kernels, dtype=np.float32), device=dev)
