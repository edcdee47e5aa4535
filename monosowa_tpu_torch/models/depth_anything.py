"""Depth Anything: a DINOv2 trunk with the DPT neck and head (the model
zoo's monocular depth network).

Counterpart of the JAX package's ``models/depth_anything.py`` (Hugging
Face ``DepthAnythingForDepthEstimation`` layout): four hidden states of the
trunk, reassembled to image grids (1x1 projection, then a stride-k
transposed convolution up, none, or a stride-2 convolution down), 3x3 neck
convolutions, the fusion stage from the deepest map upward (pre-activation
residual units, a bilinear ``align_corners=True`` resize to the next map's
size or twice the size), and the head (a resize to the patch grid times
the patch, ReLU, then sigmoid times ``max_depth`` for metric checkpoints
or ReLU times it for relative ones).  Submodules are named after the JAX
param tree, so ``convert.load_zoo_params`` fills them by path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.models import zoo_layers as zl
from monosowa_tpu_torch.models.dinov2 import Dinov2, Dinov2Config
from monosowa_tpu_torch.ops.resize import resize_bilinear_torch


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    backbone: Dinov2Config
    out_indices: Sequence[int] = (9, 10, 11, 12)
    reassemble_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)
    neck_hidden_sizes: Sequence[int] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    head_in_index: int = -1
    depth_estimation_type: str = "relative"  # or "metric"
    max_depth: float = 1.0


class Reassemble(nn.Module):
    def __init__(self, c: int, ch: int, f: float, gen: torch.Generator):
        super().__init__()
        self.f = f
        self.projection = zl.conv(c, ch, 1, gen)
        if f > 1:
            self.resize = zl.conv_transpose(ch, ch, int(f), gen)
        elif f < 1:
            self.resize = zl.conv(ch, ch, 3, gen, stride=int(round(1 / f)),
                                  padding=1)

    def forward(self, g):
        g = zl.conv_nhwc(self.projection, g)
        return zl.conv_nhwc(self.resize, g) if self.f != 1 else g


class PreActResidual(nn.Module):
    def __init__(self, c: int, gen: torch.Generator):
        super().__init__()
        self.convolution1 = zl.conv(c, c, 3, gen, padding=1)
        self.convolution2 = zl.conv(c, c, 3, gen, padding=1)

    def forward(self, x):
        y = zl.conv_nhwc(self.convolution1, torch.relu(x))
        return zl.conv_nhwc(self.convolution2, torch.relu(y)) + x


class FusionLayer(nn.Module):
    """DepthAnythingFeatureFusionLayer."""

    def __init__(self, c: int, gen: torch.Generator):
        super().__init__()
        self.projection = zl.conv(c, c, 1, gen)
        self.residual_layer1 = PreActResidual(c, gen)
        self.residual_layer2 = PreActResidual(c, gen)

    def forward(self, fused: Optional[torch.Tensor], feat: torch.Tensor,
                out_hw) -> torch.Tensor:
        if fused is None:
            h = feat
        else:
            res = feat
            if fused.shape[1:3] != res.shape[1:3]:
                res = resize_bilinear_torch(res, fused.shape[1:3])
            h = fused + self.residual_layer1(res)
        h = self.residual_layer2(h)
        hw = out_hw if out_hw is not None else (h.shape[1] * 2,
                                                h.shape[2] * 2)
        h = resize_bilinear_torch(h, hw, align_corners=True)
        return zl.conv_nhwc(self.projection, h)


class Head(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig, gen: torch.Generator):
        super().__init__()
        fus = cfg.fusion_hidden_size
        self.conv1 = zl.conv(fus, fus // 2, 3, gen, padding=1)
        self.conv2 = zl.conv(fus // 2, cfg.head_hidden_size, 3, gen,
                             padding=1)
        self.conv3 = zl.conv(cfg.head_hidden_size, 1, 1, gen)


class DepthAnything(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """Weights are drawn on the host from a ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default ``cuda``)."""
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        c, fus = cfg.backbone.hidden_size, cfg.fusion_hidden_size
        self.backbone = Dinov2(cfg.backbone, gen)
        self.reassemble = nn.ModuleList(
            [Reassemble(c, ch, f, gen) for ch, f in
             zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)])
        self.neck_convs = nn.ModuleList(
            [zl.conv(ch, fus, 3, gen, padding=1, bias=False)
             for ch in cfg.neck_hidden_sizes])
        self.fusion = nn.ModuleList(
            [FusionLayer(fus, gen) for _ in cfg.neck_hidden_sizes])
        self.head = Head(cfg, gen)
        self.to(dev)
        self.eval()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) normalised NHWC -> depth (B, H', W'), H' =
        the patch grid times the patch (== H where the patch divides H)."""
        cfg, bb = self.cfg, self.cfg.backbone
        ph = pixels.shape[1] // bb.patch_size
        pw = pixels.shape[2] // bb.patch_size
        feats = self.backbone.features(pixels, cfg.out_indices)
        # drop the class (and register) tokens, back to the patch grid
        skip = 1 + bb.num_register_tokens
        stages: List[torch.Tensor] = []
        for s, rp, neck in zip(feats, self.reassemble, self.neck_convs):
            g = s[:, skip:].reshape(s.shape[0], ph, pw, s.shape[-1])
            stages.append(zl.conv_nhwc(neck, rp(g)))
        # fusion from the deepest stage upward
        rev = stages[::-1]
        fused = None
        for i, (layer, feat) in enumerate(zip(self.fusion, rev)):
            out_hw = rev[i + 1].shape[1:3] if i + 1 < len(rev) else None
            fused = layer(fused, feat, out_hw)
        head = self.head
        y = zl.conv_nhwc(head.conv1, fused)
        y = resize_bilinear_torch(y, (ph * bb.patch_size, pw * bb.patch_size),
                                  align_corners=True)
        y = zl.conv_nhwc(head.conv3, torch.relu(zl.conv_nhwc(head.conv2, y)))
        if cfg.depth_estimation_type == "metric":
            y = torch.sigmoid(y) * cfg.max_depth
        else:
            y = torch.relu(y) * cfg.max_depth
        return y[..., 0]
