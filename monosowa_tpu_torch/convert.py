"""Weight bridge: the JAX package's Flax variables -> the port's modules.

``load_flax_params(model, params, frozen)`` takes the ``variables["params"]``
and ``variables["frozen"]`` trees as nested dicts of numpy arrays (no JAX
needed) and fills the torch module in place:

* Dense kernels (in, out) become Linear weights (out, in);
* Conv kernels HWIO become OIHW;
* GroupNorm and LayerNorm ``scale`` becomes ``weight``;
* FrozenBatchNorm ``scale/bias/mean/var`` fill the buffers of those names;
* raw parameters (``level_embed``, ``query_embed``, ``depth_pos_embed``,
  and of the variants ``tgt_embed``, ``refpoint_embed``, ``label_enc``)
  keep their names and shapes (the full query tables of
  num_queries x group_num rows), as do ``flax.linen.Embed`` tables
  (``position_embedding/{row,col}_embed/embedding``: ``layers.Embed``).

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


# ---------------------------------------------------------------------------
# the model zoo's param trees (sowa/zoo.py checkpoints)
# ---------------------------------------------------------------------------

# the zoo tree's leaf for a module's ``weight`` and the axis permutations
# tree -> port and port -> tree: a dense kernel (in, out) is the transposed
# weight, a convolution's HWIO kernel the OIHW weight (IOHW for a
# transposed one), a norm's scale the weight.  Other parameters (biases,
# raw tables) keep their names and layouts.
_WEIGHT_LEAVES = ((nn.Linear, "kernel", (1, 0), (1, 0)),
                  (nn.ConvTranspose2d, "kernel", (2, 3, 0, 1), (2, 3, 0, 1)),
                  (nn.Conv2d, "kernel", (3, 2, 0, 1), (2, 3, 1, 0)),
                  ((nn.LayerNorm, nn.GroupNorm), "scale", None, None))


def _weight_leaf(mod: nn.Module):
    """(tree leaf, tree -> port, port -> tree) of ``mod.weight``, or
    None for a module without one."""
    for types, leaf, to_port, to_tree in _WEIGHT_LEAVES:
        if isinstance(mod, types):
            return leaf, to_port, to_tree
    return None


def load_zoo_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill a zoo network of the port (``models/swin.py``,
    ``mask2former.py``, ``dinov2.py``, ``depth_anything.py``, ``sam.py``,
    ``efficientloftr.py``, ``vit_tracker.py``) from the JAX package's
    param tree (nested dicts and lists of numpy arrays, as
    ``sowa.zoo.load_checkpoint`` returns it).  Any tree leaf the port has
    no tensor for, any shape that differs and any port tensor left unfilled
    raise ``ValueError``; nothing is written unless everything matches."""
    from monosowa_tpu_torch.sowa.zoo import flatten_params

    state = module.state_dict(keep_vars=True)
    plan, errors = {}, []
    for path, arr in flatten_params(tree).items():
        *mods, leaf = path.split("/")
        try:
            mod = module.get_submodule(".".join(mods))
        except AttributeError:
            mod = None
        wl = _weight_leaf(mod) if mod is not None else None
        if wl is not None and leaf == wl[0]:
            tname, perm = "weight", wl[1]
        elif mod is not None and leaf in mod._parameters \
                and leaf != "weight":
            tname, perm = leaf, None
        else:
            errors.append(f"zoo {path}: the port has no such tensor")
            continue
        name = ".".join(mods + [tname])
        arr = np.asarray(arr) if perm is None else \
            np.asarray(arr).transpose(perm)
        if name not in state:
            errors.append(f"zoo {path} -> {name}: no such port tensor")
        elif tuple(state[name].shape) != arr.shape:
            errors.append(f"zoo {path} -> {name}: shape {arr.shape} != "
                          f"{tuple(state[name].shape)}")
        else:
            plan[name] = arr
    unfilled = sorted(set(state) - set(plan))
    if unfilled:
        errors.append(f"port tensors left unfilled: {unfilled}")
    if errors:
        raise ValueError("zoo weight bridge mismatch:\n" + "\n".join(errors))
    with torch.no_grad():
        for name, arr in plan.items():
            state[name].copy_(torch.from_numpy(np.array(arr,
                                                        dtype=np.float32)))
    return module


def zoo_params(module: nn.Module) -> dict:
    """The inverse of ``load_zoo_params``: the port network's weights as
    the JAX package's param tree of float32 numpy arrays (lists where the
    tree has lists), ready for the JAX forward or ``save_checkpoint``."""
    from monosowa_tpu_torch.sowa.zoo import unflatten_params

    flat = {}
    for name, t in module.state_dict().items():
        mod_name, _, tname = name.rpartition(".")
        mod = module.get_submodule(mod_name)
        arr = t.detach().float().cpu().numpy()
        wl = _weight_leaf(mod) if tname == "weight" else None
        leaf, perm = (wl[0], wl[2]) if wl is not None else (tname, None)
        if perm is not None:
            arr = arr.transpose(perm)
        path = mod_name.split(".") if mod_name else []
        flat["/".join(path + [leaf])] = np.ascontiguousarray(arr)
    return unflatten_params(flat)
