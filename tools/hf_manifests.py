#!/usr/bin/env python
"""Write the port's checkpoint manifests (``monosowa_tpu_torch/sowa/
hf_manifests/<kind>.json``) from transformers, on the meta device.

A manifest holds one shipped configuration's ``config.json`` as
``save_pretrained`` writes it (``to_diff_dict``) and the name, shape and
type of every tensor that ``save_pretrained`` writes (the tied copies
left out).  ``resnet50.json`` holds torchvision's ImageNet ResNet-50 state
dict, spelled out here (no torchvision needed).  ``sowa/hf_checkpoint.py``
writes seeded checkpoints in these layouts; tests/test_torch_import_hf.py
holds every manifest to the models this script builds.

Usage (needs torch and transformers; no weights are downloaded)::

    python tools/hf_manifests.py [--check]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from monosowa_tpu_torch.sowa.hf_checkpoint import (KINDS,  # noqa: E402
                                                   MANIFEST_DIR)

# each public release's configuration, as its config.json gives it
RELEASE_CONFIGS = {
    "mask2former": dict(
        model_type="mask2former", num_labels=80,
        backbone_config=dict(
            model_type="swin", embed_dim=128, depths=[2, 2, 18, 2],
            num_heads=[4, 8, 16, 32], window_size=12, image_size=384,
            drop_path_rate=0.3,
            out_features=["stage1", "stage2", "stage3", "stage4"])),
    "depth_anything": dict(
        model_type="depth_anything", reassemble_hidden_size=1024,
        neck_hidden_sizes=[256, 512, 1024, 1024], fusion_hidden_size=256,
        depth_estimation_type="metric", max_depth=80,
        backbone_config=dict(
            model_type="dinov2", image_size=518, hidden_size=1024,
            num_hidden_layers=24, num_attention_heads=16,
            out_indices=[5, 12, 18, 24], apply_layernorm=True,
            reshape_hidden_states=False)),
    "sam": dict(
        model_type="sam",
        vision_config=dict(hidden_size=1280, num_hidden_layers=32,
                           num_attention_heads=16,
                           global_attn_indexes=[7, 15, 23, 31])),
    "loftr": dict(model_type="efficientloftr"),
}


def hf_config(kind: str):
    """The transformers config of a release (needs transformers)."""
    from transformers import CONFIG_MAPPING

    raw = dict(RELEASE_CONFIGS[kind])
    model_type = raw.pop("model_type")
    cls = CONFIG_MAPPING[model_type]
    if "backbone_config" in raw:
        bb = dict(raw["backbone_config"])
        raw["backbone_config"] = CONFIG_MAPPING[bb.pop("model_type")](**bb)
    return cls(**raw)


def hf_manifest(kind: str) -> dict:
    """A release's manifest from transformers' model built on the meta
    device."""
    import torch
    import transformers

    config = hf_config(kind)
    model_class = getattr(transformers, KINDS[kind][1])
    with torch.device("meta"):
        model = model_class(config)
    tied = set(model_class._tied_weights_keys or ())
    dtypes = {torch.float32: "F32", torch.int64: "I64"}
    tensors = [[name, list(t.shape), dtypes[t.dtype]]
               for name, t in model.state_dict().items() if name not in tied]
    diff = config.to_diff_dict()
    diff.pop("transformers_version", None)
    return {"kind": kind, "source": KINDS[kind][2],
            "model_class": KINDS[kind][1], "config": diff,
            "tensors": tensors}


def resnet50_manifest() -> dict:
    """torchvision's ``resnet50(weights="IMAGENET1K_V1")`` state dict
    layout."""
    tensors = []

    def bn(pre, ch):
        tensors.extend([[f"{pre}.weight", [ch], "F32"],
                        [f"{pre}.bias", [ch], "F32"],
                        [f"{pre}.running_mean", [ch], "F32"],
                        [f"{pre}.running_var", [ch], "F32"],
                        [f"{pre}.num_batches_tracked", [], "I64"]])

    tensors.append(["conv1.weight", [64, 3, 7, 7], "F32"])
    bn("bn1", 64)
    cin = 64
    for s, (mid, blocks) in enumerate(zip((64, 128, 256, 512),
                                          (3, 4, 6, 3))):
        out = mid * 4
        for b in range(blocks):
            pre = f"layer{s + 1}.{b}"
            c = cin if b == 0 else out
            tensors.append([f"{pre}.conv1.weight", [mid, c, 1, 1], "F32"])
            bn(f"{pre}.bn1", mid)
            tensors.append([f"{pre}.conv2.weight", [mid, mid, 3, 3], "F32"])
            bn(f"{pre}.bn2", mid)
            tensors.append([f"{pre}.conv3.weight", [out, mid, 1, 1], "F32"])
            bn(f"{pre}.bn3", out)
            if b == 0:
                tensors.append([f"{pre}.downsample.0.weight",
                                [out, c, 1, 1], "F32"])
                bn(f"{pre}.downsample.1", out)
        cin = out
    tensors += [["fc.weight", [1000, 2048], "F32"],
                ["fc.bias", [1000], "F32"]]
    return {"kind": "resnet50",
            "source": "torchvision resnet50 ImageNet weights",
            "tensors": tensors}


def manifests() -> dict:
    out = {kind: hf_manifest(kind) for kind in KINDS}
    out["resnet50"] = resnet50_manifest()
    return out


def dumps(manifest: dict) -> str:
    """One tensor a line, the config indented."""
    head = {k: v for k, v in manifest.items() if k != "tensors"}
    text = json.dumps(head, indent=1, sort_keys=True)[:-2]
    rows = ",\n  ".join(json.dumps(t) for t in manifest["tensors"])
    return f'{text},\n "tensors": [\n  {rows}\n ]\n}}\n'


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the files instead of writing them")
    args = ap.parse_args(argv)
    stale = []
    for kind, manifest in manifests().items():
        path = os.path.join(MANIFEST_DIR, f"{kind}.json")
        text = dumps(manifest)
        if args.check:
            with open(path) as f:
                if json.load(f) != json.loads(text):
                    stale.append(kind)
            continue
        os.makedirs(MANIFEST_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path} ({len(manifest['tensors'])} tensors)")
    if stale:
        print(f"stale manifests: {stale}")
    return 1 if stale else 0


if __name__ == "__main__":
    raise SystemExit(main())
