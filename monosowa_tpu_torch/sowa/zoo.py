"""Config-driven dispatch of the model zoo (the labeller's live networks).

Counterpart of the JAX package's ``sowa/zoo.py``.  A ``backends:`` config
section selects, per capability, the cached mode or a network restored
from a zoo checkpoint::

    backends:
      depth: cached | metric3d_hub | depth_anything
      depth_checkpoint: <path.npz>        # depth_anything mode
      depth_input_size: 518
      mask: cached | mask2former
      mask_checkpoint: <path.npz>
      mask_input_hw: [384, 1280]
      mask_car_labels: [2]
      sam_checkpoint: <path.npz>          # when paths.sam_path is unset
      matcher: orb | loftr
      matcher_checkpoint: <path.npz>
      matcher_input_hw: [480, 640]
      tracker: template | vit
      tracker_checkpoint: <path.npz>
    frames_creation:
      use_SAM: False                      # reference key, config.yaml:27
    paths:
      sam_path: <path.npz>                # reference key (loader.py:99)

Checkpoint format, the JAX package's own: one ``.npz`` holding the
flattened param tree (``/``-joined path keys, list indices as digit
segments) plus a ``__config__`` JSON blob describing the model's config
dataclass.  A checkpoint that the JAX package's ``save_checkpoint`` wrote
loads here unchanged, and the reverse; ``convert.load_zoo_params`` fills
the port's modules from the tree.

Ported: ``cached`` depth and masks, ``depth_anything``
(``models/depth_anything.py`` on ``models/dinov2.py``), ``mask2former``
(``models/mask2former.py`` on ``models/swin.py``), ``sam``
(``models/sam.py``, the refinement behind ``frames_creation.use_SAM``),
and the Waymo stitching path's ``loftr`` (``models/efficientloftr.py``,
``backends.matcher``; ``orb`` runs OpenCV on the host) and
``vit_tracker`` (``models/vit_tracker.py``, ``backends.tracker``;
``template`` matching by default).  ``metric3d_hub`` (a ``torch.hub``
download) raises ``NotImplementedError``.  The networks run on the card
unless ``device`` names another.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# param tree <-> flat npz
# ---------------------------------------------------------------------------

def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree of arrays -> flat ``{path: array}``."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"param key {k!r} may not contain '/'")
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of :func:`flatten_params`; all-digit key segments rebuild
    lists (sorted numerically)."""
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def build(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [build(node[k]) for k in sorted(keys, key=int)]
        return {k: build(v) for k, v in node.items()}

    return build(root)


# ---------------------------------------------------------------------------
# config dataclass <-> JSON
# ---------------------------------------------------------------------------

def _config_classes(kind: str) -> Dict[str, type]:
    """Name -> dataclass map for a checkpoint kind (lazy model imports)."""
    if kind == "depth_anything":
        from monosowa_tpu_torch.models.depth_anything import \
            DepthAnythingConfig
        from monosowa_tpu_torch.models.dinov2 import Dinov2Config
        return {"DepthAnythingConfig": DepthAnythingConfig,
                "Dinov2Config": Dinov2Config}
    if kind == "mask2former":
        from monosowa_tpu_torch.models.mask2former import Mask2FormerConfig
        from monosowa_tpu_torch.models.swin import SwinConfig
        return {"Mask2FormerConfig": Mask2FormerConfig,
                "SwinConfig": SwinConfig}
    if kind == "sam":
        from monosowa_tpu_torch.models.sam import (SamConfig,
                                                   SamDecoderConfig,
                                                   SamVisionConfig)
        return {"SamConfig": SamConfig, "SamVisionConfig": SamVisionConfig,
                "SamDecoderConfig": SamDecoderConfig}
    if kind == "loftr":
        from monosowa_tpu_torch.models.efficientloftr import \
            EfficientLoFTRConfig
        return {"EfficientLoFTRConfig": EfficientLoFTRConfig}
    if kind == "vit_tracker":
        from monosowa_tpu_torch.models.vit_tracker import ViTTrackerConfig
        return {"ViTTrackerConfig": ViTTrackerConfig}
    raise ValueError(f"unknown checkpoint kind {kind!r}")


def _cfg_to_jsonable(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {"__class__": type(cfg).__name__,
                **{f.name: _cfg_to_jsonable(getattr(cfg, f.name))
                   for f in dataclasses.fields(cfg)}}
    if isinstance(cfg, (list, tuple)):
        return [_cfg_to_jsonable(v) for v in cfg]
    return cfg


def _cfg_from_jsonable(data: Any, classes: Dict[str, type]) -> Any:
    if isinstance(data, dict) and "__class__" in data:
        cls = classes[data["__class__"]]
        kw = {k: _cfg_from_jsonable(v, classes)
              for k, v in data.items() if k != "__class__"}
        # tuples, as the dataclasses' defaults, for hashability
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kw.items()}
        return cls(**kw)
    if isinstance(data, list):
        return [_cfg_from_jsonable(v, classes) for v in data]
    return data


# ---------------------------------------------------------------------------
# checkpoint file
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, kind: str, params: Any, cfg: Any) -> None:
    """Serialise a model-zoo checkpoint (see the module docstring)."""
    _config_classes(kind)     # validate kind early
    meta = json.dumps({"kind": kind, "config": _cfg_to_jsonable(cfg)})
    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __config__=np.frombuffer(
        meta.encode(), dtype=np.uint8), **flat)


def load_checkpoint(path: str) -> Tuple[str, Any, Any]:
    """-> (kind, param tree, config dataclass)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__config__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__config__"}
    kind = meta["kind"]
    cfg = _cfg_from_jsonable(meta["config"], _config_classes(kind))
    return kind, unflatten_params(flat), cfg


def _load_checked(path: str, expect_kind: str) -> Tuple[Any, Any]:
    kind, params, cfg = load_checkpoint(path)
    if kind != expect_kind:
        raise ValueError(
            f"checkpoint {path} holds a {kind!r} model; expected "
            f"{expect_kind!r}")
    return params, cfg


# ---------------------------------------------------------------------------
# backend factories (driver entry points)
# ---------------------------------------------------------------------------

def _backends(cfg) -> Any:
    from monosowa_tpu_torch.config import Config
    return cfg.backends or Config({})


def depth_backend(cfg, depth_dir: str, device=None):
    """``--action lidar_scans`` depth source (reference metric3d.py:24-39):
    an object with ``predict_depth_for(frame)`` (cached mode) or
    ``predict_depth(image)`` and a settable ``fx`` (live modes)."""
    from monosowa_tpu_torch.sowa import depth as depth_mod

    b = _backends(cfg)
    kind = b.get("depth", "cached")
    if kind == "cached":
        return depth_mod.CachedDepthBackend(depth_dir)
    if kind == "metric3d_hub":
        raise NotImplementedError(
            "backends.depth 'metric3d_hub': TorchHubMetric3DBackend of the "
            "JAX package's sowa/depth.py loads Metric3D through torch.hub "
            "(a download); not ported")
    if kind == "depth_anything":
        params, dcfg = _load_checked(b.get("depth_checkpoint"),
                                     "depth_anything")
        return depth_mod.DepthAnythingBackend(
            params, dcfg, fx=depth_mod.CANONICAL_FOCAL,
            input_size=int(b.get("depth_input_size", 518)), device=device)
    raise ValueError(f"unknown backends.depth {kind!r}")


def mask_backend(cfg, device=None):
    """Live instance-segmentation backend (reference loader.py:80-95), or
    None for the cached mode (masks_raw/)."""
    b = _backends(cfg)
    kind = b.get("mask", "cached")
    if kind == "cached":
        return None
    if kind == "mask2former":
        from monosowa_tpu_torch.sowa.masks import (SCORE_THRESHOLD,
                                                   Mask2FormerBackend)

        params, mcfg = _load_checked(b.get("mask_checkpoint"), "mask2former")
        thresh = float((cfg.filtering or type(cfg)({}))
                       .get("score_detectron_thresh", SCORE_THRESHOLD))
        hw = b.get("mask_input_hw", (384, 1280))
        return Mask2FormerBackend(params, mcfg,
                                  car_label_ids=tuple(
                                      b.get("mask_car_labels", (2,))),
                                  score_threshold=thresh,
                                  input_hw=tuple(int(v) for v in hw),
                                  device=device)
    raise ValueError(f"unknown backends.mask {kind!r}")


def sam_refine_backend(cfg, device=None):
    """SAM box-prompted refinement when ``frames_creation.use_SAM`` is on
    (reference config.yaml:27 gating loader.py:1727-1739; weights from
    ``paths.sam_path``, else ``backends.sam_checkpoint``); None when it is
    off."""
    fc = cfg.frames_creation or type(cfg)({})
    if not fc.get("use_SAM", False):
        return None
    from monosowa_tpu_torch.sowa.masks import SamRefineBackend

    path = (cfg.paths or type(cfg)({})).get("sam_path") \
        or _backends(cfg).get("sam_checkpoint")
    if not path:
        raise ValueError("use_SAM: True needs paths.sam_path (a zoo "
                         "checkpoint produced by save_checkpoint)")
    params, scfg = _load_checked(path, "sam")
    return SamRefineBackend(params, scfg, device=device)


def matcher_backend(cfg, device=None):
    """Stitching keypoint matcher (reference kornia LoFTR,
    stitching.py:29-151): ORB on the host by default (OpenCV needed), the
    port's EfficientLoFTR on the card when ``backends.matcher: loftr``
    names a checkpoint."""
    from monosowa_tpu_torch.sowa import stitching as stitch_mod

    b = _backends(cfg)
    kind = b.get("matcher", "orb")
    if kind == "orb":
        return stitch_mod.OrbMatcherBackend()
    if kind == "loftr":
        params, lcfg = _load_checked(b.get("matcher_checkpoint"), "loftr")
        hw = b.get("matcher_input_hw", (480, 640))
        return stitch_mod.LoFTRMatcherBackend(
            params, lcfg, input_hw=tuple(int(v) for v in hw), device=device)
    raise ValueError(f"unknown backends.matcher {kind!r}")


def tracker_factory(cfg, device=None) -> Callable[[], Any]:
    """Single-object tracker factory for the pair-canvas mask tracking
    (reference ODTrack, tracker_ODTrack.py:10-58): template matching by
    default, the port's ViT tracker when ``backends.tracker: vit`` names a
    checkpoint.  Both run on ``device`` (default the card)."""
    import copy

    b = _backends(cfg)
    kind = b.get("tracker", "template")
    if kind == "template":
        from monosowa_tpu_torch.sowa.tracker2d import TemplateMatchTracker
        return lambda: TemplateMatchTracker(device=device)
    if kind == "vit":
        from monosowa_tpu_torch.sowa.tracker2d import ViTTrackerBackend

        params, tcfg = _load_checked(b.get("tracker_checkpoint"),
                                     "vit_tracker")
        # one network for every track; each track a shallow copy with
        # fresh state
        proto = ViTTrackerBackend(params, tcfg, device=device)

        def make():
            t = copy.copy(proto)
            t._template = None
            t._track_tokens = None
            t._box = None
            return t

        return make
    raise ValueError(f"unknown backends.tracker {kind!r}")
