"""ResNet-50 backbone with frozen batch norm (torch, NCHW).

Behavioral contract (MonoDETR/lib/models/monodetr/backbone.py:68-144):
torchvision ResNet-50 with FrozenBatchNorm2d, returning layer2/3/4 features
(strides 8/16/32, channels 512/1024/2048).  Module names match the JAX
package's (``layer{stage}_{block}``, ``down_conv``/``down_bn``) so the
weight bridge maps them one to one.  Every convolution computes in
``compute_dtype`` (the JAX package's backbone.py:28-90).
``load_torch_resnet_state`` fills it from torchvision's ImageNet weights.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from monosowa_tpu_torch.models.layers import (FrozenBatchNorm, conv,
                                              xavier_uniform_)

BACKBONE_CHANNELS = (512, 1024, 2048)
BACKBONE_STRIDES = (8, 16, 32)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, gen: torch.Generator,
                 stride: int = 1, downsample: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        out_ch = features * 4
        cd = compute_dtype
        self.conv1 = conv(c_in, features, 1, gen, bias=False,
                          compute_dtype=cd)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = conv(features, features, 3, gen, stride=stride,
                          padding=1, bias=False, compute_dtype=cd)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = conv(features, out_ch, 1, gen, bias=False,
                          compute_dtype=cd)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = downsample
        if downsample:
            self.down_conv = conv(c_in, out_ch, 1, gen, stride=stride,
                                  bias=False, compute_dtype=cd)
            self.down_bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return torch.relu(y + identity)


class ResNet50(nn.Module):
    """NCHW images -> (C3, C4, C5): strides 8/16/32, channels
    512/1024/2048.

    ``depth_input``: the 4-channel RGB-D stem (reference backbone.py:
    109-111; the JAX package's backbone.py:58-76): conv1 takes 4 input
    channels with a xavier-uniform init.  As in the JAX package the norm
    stays frozen (the reference swaps in a trainable BatchNorm2d)."""

    def __init__(self, gen: torch.Generator,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 compute_dtype: Optional[str] = None,
                 depth_input: bool = False):
        super().__init__()
        self.conv1 = conv(4 if depth_input else 3, 64, 7, gen, stride=2,
                          padding=3, bias=False, compute_dtype=compute_dtype)
        if depth_input:
            with torch.no_grad():
                xavier_uniform_(self.conv1.weight, gen)
        self.bn1 = FrozenBatchNorm(64)
        self.pool = nn.MaxPool2d(3, 2, 1)
        self.stage_sizes = tuple(stage_sizes)
        c_in = 64
        for stage, (blocks, w) in enumerate(zip(self.stage_sizes,
                                                (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            for b in range(blocks):
                self.add_module(
                    f"layer{stage + 1}_{b}",
                    Bottleneck(c_in, w, gen, stride=stride if b == 0 else 1,
                               downsample=(b == 0),
                               compute_dtype=compute_dtype))
                c_in = w * 4

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        y = self.pool(torch.relu(self.bn1(self.conv1(x))))
        outputs = []
        for stage, blocks in enumerate(self.stage_sizes):
            for b in range(blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y)
            if stage >= 1:
                outputs.append(y)
        return tuple(outputs)


def load_torch_resnet_state(backbone: ResNet50, state_path: str
                            ) -> ResNet50:
    """A torchvision ResNet-50 state dict (a ``.pth`` saved with
    ``torch.save``) into ``backbone`` in place: convolution weights as
    they are (both OIHW), each BatchNorm's weight / bias / running mean /
    running variance into the ``FrozenBatchNorm`` buffers ``scale`` /
    ``bias`` / ``mean`` / ``var``; ``num_batches_tracked`` and ``fc.*``
    are not read.  A 4-channel RGB-D stem keeps its fresh conv1 (the
    reference replaces conv1 after the pretrained load, backbone.py:
    109-111; the JAX package's backbone.py:128-132).  Any missing tensor or
    shape that differs raises ``KeyError`` / ``ValueError`` before
    anything is written.  Returns ``backbone``."""
    sd = torch.load(state_path, map_location="cpu", weights_only=True)
    pairs = []                                  # (port tensor, source)

    def put(tensor, name):
        src = sd[name]
        if tuple(src.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: {tuple(src.shape)} for "
                             f"{tuple(tensor.shape)}")
        pairs.append((tensor, src))

    def put_bn(bn: FrozenBatchNorm, src: str):
        for dst, key in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
            put(getattr(bn, dst), f"{src}.{key}")

    if backbone.conv1.weight.shape[1] == sd["conv1.weight"].shape[1]:
        put(backbone.conv1.weight, "conv1.weight")
    put_bn(backbone.bn1, "bn1")
    for stage, blocks in enumerate(backbone.stage_sizes):
        for b in range(blocks):
            pre = f"layer{stage + 1}.{b}"
            blk = getattr(backbone, f"layer{stage + 1}_{b}")
            for i in (1, 2, 3):
                put(getattr(blk, f"conv{i}").weight, f"{pre}.conv{i}.weight")
                put_bn(getattr(blk, f"bn{i}"), f"{pre}.bn{i}")
            if blk.downsample:
                put(blk.down_conv.weight, f"{pre}.downsample.0.weight")
                put_bn(blk.down_bn, f"{pre}.downsample.1")
    with torch.no_grad():
        for tensor, src in pairs:
            tensor.copy_(src)
    return backbone
