"""A local Hugging Face checkpoint directory, read with numpy and torch only.

The port's counterpart of ``from_pretrained(<local dir>)``, which the JAX
package's ``tools/import_zoo_checkpoint.py`` calls: the card's machine has
neither ``transformers`` nor ``safetensors``, so this module reads the two
halves of a directory written by ``save_pretrained`` itself.

* ``read_config(dir)`` -> an attribute tree over ``config.json`` that the
  ``config_from_hf_*`` functions read exactly as they read a transformers
  config.  ``save_pretrained`` leaves out the keys of the base config class
  that equal their defaults (``num_labels`` among them: only ``id2label``
  is written), and older releases leave out keys that later versions
  added.  Every gap is filled as the config class of its ``model_type``
  fills it (transformers 4.57): the class defaults of the keys the
  importers read, and the derived values (``num_labels`` from
  ``id2label``; a backbone's ``out_features`` / ``out_indices`` from each
  other and its stage names; SAM's ``mlp_dim`` from ``mlp_ratio`` and its
  prompt encoder's ``image_embedding_size``; the default backbones of
  Mask2Former and Depth Anything).
* ``read_state_dict(dir)`` -> ``{name: numpy array}``: ``model.safetensors``
  (an 8-byte little-endian header length, a JSON header, raw little-endian
  data; F32, F16 and BF16 tensors, BF16 widened by a 16-bit shift), a
  sharded ``model.safetensors.index.json``, else ``pytorch_model.bin``
  (``torch.load(weights_only=True)``, sharded or not).  Floating tensors
  come out as float32, as ``from_pretrained`` gives a float32 model;
  integer buffers keep their type.  Legacy names that ``from_pretrained``
  renames on load are renamed (``LayerNorm.gamma`` / ``.beta``), and SAM's
  tied positional table is filled from its twin where a file holds one
  copy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional

import numpy as np

CONFIG = "config.json"
SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"
TORCH_BIN_INDEX = "pytorch_model.bin.index.json"

# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------

# The class defaults (transformers 4.57) of every key a ``config_from_hf_*``
# reads, by model type; a nested config's own table by its key.
_SWIN = {"embed_dim": 96, "depths": [2, 2, 6, 2],
         "num_heads": [3, 6, 12, 24], "window_size": 7, "mlp_ratio": 4.0,
         "patch_size": 4, "num_channels": 3, "layer_norm_eps": 1e-5,
         "image_size": 224}
_DINOV2 = {"hidden_size": 768, "num_hidden_layers": 12,
           "num_attention_heads": 12, "mlp_ratio": 4, "patch_size": 14,
           "num_channels": 3, "image_size": 224, "layer_norm_eps": 1e-6,
           "use_swiglu_ffn": False}
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "swin": _SWIN,
    "dinov2": _DINOV2,
    "dinov2_with_registers": {**_DINOV2, "patch_size": 16,
                              "num_register_tokens": 4},
    "mask2former": {
        "feature_size": 256, "mask_feature_size": 256, "hidden_dim": 256,
        "encoder_layers": 6, "decoder_layers": 10, "num_attention_heads": 8,
        "encoder_feedforward_dim": 1024, "dim_feedforward": 2048,
        "num_queries": 100, "pre_norm": False, "common_stride": 4,
        "feature_strides": [4, 8, 16, 32]},
    "depth_anything": {
        "reassemble_factors": [4, 2, 1, 0.5],
        "neck_hidden_sizes": [48, 96, 192, 384], "fusion_hidden_size": 64,
        "head_hidden_size": 32, "head_in_index": -1,
        "depth_estimation_type": "relative", "max_depth": None},
    "sam": {},
    "sam.vision_config": {
        "hidden_size": 768, "output_channels": 256, "num_hidden_layers": 12,
        "num_attention_heads": 12, "image_size": 1024, "patch_size": 16,
        "layer_norm_eps": 1e-6, "mlp_ratio": 4.0, "use_abs_pos": True,
        "use_rel_pos": True, "window_size": 14,
        "global_attn_indexes": [2, 5, 8, 11], "mlp_dim": None},
    "sam.mask_decoder_config": {
        "hidden_size": 256, "mlp_dim": 2048, "num_hidden_layers": 2,
        "num_attention_heads": 8, "attention_downsample_rate": 2,
        "num_multimask_outputs": 3, "iou_head_depth": 3,
        "iou_head_hidden_dim": 256, "layer_norm_eps": 1e-6},
    "sam.prompt_encoder_config": {"image_size": 1024, "patch_size": 16},
    "efficientloftr": {
        "stage_num_blocks": [1, 2, 4, 14], "out_features": [64, 64, 128, 256],
        "stage_stride": [2, 1, 2, 2], "hidden_size": 256,
        "q_aggregation_kernel_size": 4, "kv_aggregation_kernel_size": 4,
        "q_aggregation_stride": 4, "kv_aggregation_stride": 4,
        "num_attention_layers": 4, "num_attention_heads": 8,
        "coarse_matching_skip_softmax": False,
        "coarse_matching_threshold": 0.2, "coarse_matching_temperature": 0.1,
        "coarse_matching_border_removal": 2, "fine_kernel_size": 8,
        "rope_theta": 10000.0, "partial_rotary_factor": 4.0,
        "fine_matching_slice_dim": 8,
        "fine_matching_regress_temperature": 10.0},
}
# the backbones a config class builds when its file names none
_DEFAULT_BACKBONE = {
    "mask2former": {"model_type": "swin", "depths": [2, 2, 18, 2],
                    "drop_path_rate": 0.3,
                    "out_features": ["stage1", "stage2", "stage3",
                                     "stage4"]},
    "depth_anything": {"model_type": "dinov2", "image_size": 518,
                       "hidden_size": 384, "num_attention_heads": 6,
                       "out_indices": [9, 10, 11, 12],
                       "apply_layernorm": True,
                       "reshape_hidden_states": False},
}
_SUB_CONFIGS = {"sam": ("vision_config", "mask_decoder_config",
                        "prompt_encoder_config")}


class HFConfig:
    """Read-only attribute view of one (nested) config dict."""

    def __init__(self, values: Dict[str, Any]):
        self.__dict__["_values"] = dict(values)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        raise AttributeError("HFConfig is read-only")


def _aligned_stages(d: Dict[str, Any], n_stages: int) -> None:
    """A backbone's ``stage_names``, ``out_features`` and ``out_indices``,
    each from the others as ``get_aligned_output_features_output_indices``
    makes them (neither given: the last stage)."""
    names = ["stem"] + [f"stage{i}" for i in range(1, n_stages + 1)]
    d["stage_names"] = names
    feats, idx = d.get("out_features"), d.get("out_indices")
    if feats is None and idx is None:
        feats, idx = [names[-1]], [len(names) - 1]
    elif feats is None:
        idx = [i % len(names) if i < 0 else i for i in idx]
        feats = [names[i] for i in idx]
    elif idx is None:
        idx = [names.index(f) for f in feats]
    d["out_features"], d["out_indices"] = list(feats), list(idx)


def config_tree(raw: Dict[str, Any], model_type: Optional[str] = None
                ) -> HFConfig:
    """``config.json``'s dict -> the attribute tree, gaps filled as its
    ``model_type``'s config class fills them."""
    model_type = model_type or raw.get("model_type")
    if model_type not in DEFAULTS:
        raise ValueError(f"config model_type {model_type!r}: the port reads "
                         f"{sorted(DEFAULTS)}")
    d = {**DEFAULTS[model_type], **raw, "model_type": model_type}
    id2label = d.get("id2label")
    d["num_labels"] = (len(id2label) if id2label
                       else int(d.get("num_labels", 2)))
    if model_type == "swin":
        _aligned_stages(d, len(d["depths"]))
    elif model_type.startswith("dinov2"):
        _aligned_stages(d, d["num_hidden_layers"])
    elif model_type == "depth_anything" and not d.get("max_depth"):
        d["max_depth"] = 1
    elif model_type == "sam.vision_config" and d["mlp_dim"] is None:
        d["mlp_dim"] = int(d["hidden_size"] * d["mlp_ratio"])
    elif model_type == "sam.prompt_encoder_config":
        d["image_embedding_size"] = d["image_size"] // d["patch_size"]
    if model_type in _DEFAULT_BACKBONE:
        bb = d.get("backbone_config") or _DEFAULT_BACKBONE[model_type]
        d["backbone_config"] = config_tree(bb)
    for key in _SUB_CONFIGS.get(model_type, ()):
        d[key] = config_tree(d.get(key) or {}, f"{model_type}.{key}")
    return HFConfig(d)


def read_config(path: str) -> HFConfig:
    """``<dir>/config.json`` (or a JSON file) -> :class:`HFConfig`."""
    if os.path.isdir(path):
        path = os.path.join(path, CONFIG)
    with open(path) as f:
        return config_tree(json.load(f))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

# the tensor types of the releases' files: floats, and int64 buffers
# (BatchNorm's num_batches_tracked, Swin's relative_position_index)
_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16,
                       "BF16": np.uint16, "I64": np.int64}


def _float32(arr: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "BF16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    if dtype == "F16":
        return arr.astype(np.float32)
    return arr


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file -> ``{name: array}``; float32 arrays are
    read-only views of a memory map of the file."""
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {dtype}")
        begin, end = info["data_offsets"]
        arr = data[begin:end].view(
            np.dtype(_SAFETENSORS_DTYPES[dtype]).newbyteorder("<"))
        out[name] = _float32(arr.reshape(info["shape"]), dtype)
    return out


def _read_torch_bin(path: str) -> Dict[str, np.ndarray]:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for name, t in sd.items():
        t = t.detach()
        out[name] = (t.float() if t.is_floating_point() else t).numpy()
    return out


def _shards(index_path: str) -> Iterable[str]:
    with open(index_path) as f:
        weight_map = json.load(f)["weight_map"]
    return sorted(set(weight_map.values()))


def rename_legacy_key(key: str) -> str:
    """``PreTrainedModel._fix_state_dict_key_on_load``'s LayerNorm renames
    (the weight-norm renames concern no model read here)."""
    if key.endswith("LayerNorm.beta"):
        return key[:-len("beta")] + "bias"
    if key.endswith("LayerNorm.gamma"):
        return key[:-len("gamma")] + "weight"
    return key


# tied tensors a file may hold once (``_tied_weights_keys``)
_TIED = (("shared_image_embedding.positional_embedding",
          "prompt_encoder.shared_embedding.positional_embedding"),)


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint directory's weights -> ``{name: array}`` in the files'
    names after ``from_pretrained``'s renames, floating tensors as
    float32."""
    files = []
    for index, single, reader in (
            (SAFETENSORS_INDEX, SAFETENSORS, read_safetensors),
            (TORCH_BIN_INDEX, TORCH_BIN, _read_torch_bin)):
        if os.path.exists(os.path.join(path, index)):
            files = [(os.path.join(path, s), reader)
                     for s in _shards(os.path.join(path, index))]
        elif os.path.exists(os.path.join(path, single)):
            files = [(os.path.join(path, single), reader)]
        if files:
            break
    if not files:
        raise FileNotFoundError(
            f"{path}: no {SAFETENSORS}, {SAFETENSORS_INDEX}, {TORCH_BIN} or "
            f"{TORCH_BIN_INDEX}")
    state: Dict[str, np.ndarray] = {}
    for file, reader in files:
        for name, arr in reader(file).items():
            state[rename_legacy_key(name)] = arr
    for a, b in _TIED:
        if (a in state) != (b in state):
            state[a if b in state else b] = state[b if b in state else a]
    return state


def read_checkpoint_dir(path: str):
    """-> (:class:`HFConfig`, state dict) of a local checkpoint directory;
    a name that is not a directory is refused (nothing is downloaded)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local directory: the checkpoint's files "
            f"({CONFIG} and {SAFETENSORS} or {TORCH_BIN}) must be on disk "
            "(nothing is downloaded)")
    return read_config(path), read_state_dict(path)


# ---------------------------------------------------------------------------
# the importers by checkpoint kind
# ---------------------------------------------------------------------------

# kind -> (config model types, the model class that ``from_pretrained``
# loads, where its public release is)
KINDS = {
    "depth_anything": (("depth_anything",), "DepthAnythingForDepthEstimation",
                       "depth-anything/Depth-Anything-V2-Metric-Outdoor-"
                       "Large-hf"),
    "mask2former": (("mask2former",), "Mask2FormerForUniversalSegmentation",
                    "facebook/mask2former-swin-base-coco-instance"),
    "sam": (("sam",), "SamModel", "facebook/sam-vit-huge"),
    "loftr": (("efficientloftr",), "EfficientLoFTRForKeypointMatching",
              "zju-community/efficientloftr"),
}


def import_checkpoint(kind: str, config: HFConfig,
                      state: Dict[str, np.ndarray]):
    """-> (the zoo's param tree, the port's config dataclass) of a
    checkpoint read by :func:`read_checkpoint_dir`, through the port's
    ``config_from_hf_*`` and ``import_hf_*`` of ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"unknown checkpoint kind {kind!r}; importable: "
                         f"{sorted(KINDS)} (vit_tracker checkpoints come "
                         "from training, not a public release)")
    if config.model_type not in KINDS[kind][0]:
        raise ValueError(f"a {kind!r} import needs a config of model_type "
                         f"{KINDS[kind][0]}, not {config.model_type!r}")
    if kind == "depth_anything":
        from monosowa_tpu_torch.models import depth_anything as m
        cfg = m.config_from_hf_depth_anything(config)
        return m.import_hf_depth_anything(state, cfg), cfg
    if kind == "mask2former":
        from monosowa_tpu_torch.models import mask2former as m
        cfg = m.config_from_hf_mask2former(config)
        return m.import_hf_mask2former(state, cfg), cfg
    if kind == "sam":
        from monosowa_tpu_torch.models import sam as m
        cfg = m.config_from_hf_sam(config)
        return m.import_hf_sam(state, cfg), cfg
    from monosowa_tpu_torch.models import efficientloftr as m
    cfg = m.config_from_hf_efficientloftr(config)
    return m.import_hf_efficientloftr(state, cfg), cfg


# ---------------------------------------------------------------------------
# seeded checkpoints in the public releases' layout
# ---------------------------------------------------------------------------
# ``hf_manifests/<kind>.json`` holds each shipped configuration's
# ``config.json`` (as ``save_pretrained`` writes it) and the names, shapes
# and types of its tensors (as ``save_pretrained`` writes them, tied
# copies left out); ``resnet50.json`` the torchvision ImageNet state dict's.
# ``tools/hf_manifests.py`` writes them from transformers' models built on
# the meta device; tests/test_torch_import_hf.py holds them to those
# models.

MANIFEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "hf_manifests")
_NP_OF = {"F32": np.float32, "I64": np.int64}
_SAFETENSORS_OF = {np.dtype(np.float32): "F32", np.dtype(np.uint16): "BF16",
                   np.dtype(np.int64): "I64"}


def load_manifest(kind: str) -> Dict[str, Any]:
    with open(os.path.join(MANIFEST_DIR, f"{kind}.json")) as f:
        return json.load(f)


SEED_POOL = 1 << 22             # standard normals drawn per seed


def seeded_tensors(manifest: Dict[str, Any], seed: int
                   ) -> Dict[str, np.ndarray]:
    """Values for the manifest's tensors from ``seed``: kernels and tables
    normal with std 1 / sqrt(fan in) (fan in: the product of all but the
    first dimension), norm scales 1 + N(0, 0.02), biases and running means
    N(0, 0.02), running variances 1 + |N(0, 0.1)|, integer buffers 0.  The
    normals are a pool of ``SEED_POOL`` draws, each tensor read from it
    cyclically at an offset of its own (drawing SAM ViT-H's 641 M values
    one by one takes most of a minute on the card's host)."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(SEED_POOL, dtype=np.float32)
    out = {}
    for name, shape, dtype in manifest["tensors"]:
        if dtype != "F32":
            out[name] = np.zeros(shape, _NP_OF[dtype])
            continue
        n = int(np.prod(shape, dtype=np.int64))
        x = np.empty(n, np.float32)
        off, done = int(rng.integers(SEED_POOL)), 0
        while done < n:
            take = min(SEED_POOL - off, n - done)
            x[done:done + take] = pool[off:off + take]
            done, off = done + take, 0
        x = x.reshape(shape)
        if name.endswith("running_var"):
            x = 1.0 + 0.1 * np.abs(x)
        elif len(shape) >= 2:
            x *= np.float32(1.0 / np.sqrt(np.prod(shape[1:])))
        elif name.endswith("weight"):
            x = 1.0 + 0.02 * x
        else:
            x *= np.float32(0.02)
        out[name] = x.astype(np.float32, copy=False)
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray],
                      bf16: bool = False) -> None:
    """``{name: array}`` -> one ``.safetensors`` file (little-endian; with
    ``bf16`` float32 arrays rounded to bfloat16, to nearest even)."""
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if bf16 and arr.dtype == np.float32:
            bits = arr.view(np.uint32)
            arr = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(
                np.uint16)
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        header[name] = {"dtype": _SAFETENSORS_OF[arr.dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + data.nbytes]}
        blobs.append(data)
        offset += data.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(np.array([len(head)], "<u8").tobytes())
        f.write(head)
        for data in blobs:
            f.write(memoryview(data).cast("B"))


def write_seeded_checkpoint(kind: str, out_dir: str, seed: int = 0,
                            bf16: bool = False) -> int:
    """A checkpoint directory in the public release's layout
    (``config.json`` and ``model.safetensors``) with :func:`seeded_tensors`
    values; returns the bytes of weights written."""
    manifest = load_manifest(kind)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, CONFIG), "w") as f:
        json.dump(manifest["config"], f, indent=2)
    tensors = seeded_tensors(manifest, seed)
    write_safetensors(os.path.join(out_dir, SAFETENSORS), tensors, bf16)
    return sum(a.nbytes // (2 if bf16 and a.dtype == np.float32 else 1)
               for a in tensors.values())


def write_seeded_resnet50(path: str, seed: int = 0) -> None:
    """torchvision's ResNet-50 state dict layout (``resnet50.json``) with
    :func:`seeded_tensors` values, saved with ``torch.save``."""
    import torch

    tensors = seeded_tensors(load_manifest("resnet50"), seed)
    torch.save({k: torch.from_numpy(v) for k, v in tensors.items()}, path)
