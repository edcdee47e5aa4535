"""Swin-Transformer backbone (the Mask2Former trunk of the model zoo).

Counterpart of the JAX package's ``models/swin.py`` (Hugging Face
``SwinBackbone`` layout): NHWC maps at the configured stages, each
layer-normed.  Window partition and the cyclic shift are reshapes and rolls;
the relative-position-bias index and the shifted-window mask (0 / -100,
not -inf) are numpy constants per (H, W).  A map that is no multiple of the
window is padded at its bottom and right, and the shift is kept at every
odd block whatever the map's size, as the JAX ``_swin_layer`` does (not as
Hugging Face drops it where the map fits in one window).

Submodules are named after the JAX param tree (``stage_0.block_1.attn.
query``, ``stage_0.downsample.reduction``, ``out_norm_1``), so
``convert.load_zoo_params`` fills them by path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from monosowa_tpu_torch.models import zoo_layers as zl


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    out_indices: Sequence[int] = (1, 2, 3, 4)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2 ** i)


@functools.lru_cache(maxsize=64)
def _rel_index(window: int) -> np.ndarray:
    """(w*w, w*w) gather index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=256)
def _shift_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """SW-MSA attention mask (num_windows, w*w, w*w) of 0 / -100."""
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(hp // window, window, wp // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int,
                 gen: torch.Generator):
        super().__init__()
        self.heads, self.window = heads, window
        self.query = zl.linear(dim, dim, gen)
        self.key = zl.linear(dim, dim, gen)
        self.value = zl.linear(dim, dim, gen)
        self.proj = zl.linear(dim, dim, gen)
        self.rel_bias_table = zl.param(((2 * window - 1) ** 2, heads), gen)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """x: (nW, w*w, C); mask: (windows per image, w*w, w*w) or None."""
        b, n, c = x.shape
        h = self.heads
        q = self.query(x).reshape(b, n, h, c // h)
        k = self.key(x).reshape(b, n, h, c // h)
        v = self.value(x).reshape(b, n, h, c // h)
        idx = zl.constant(_rel_index, (self.window,), x.device)
        bias = self.rel_bias_table[idx.reshape(-1)].reshape(
            n, n, h).permute(2, 0, 1)
        if mask is not None:
            m = mask.shape[0]
            bias = (bias[None, None] + mask[None, :, None]).expand(
                b // m, m, h, n, n).reshape(b, h, n, n)
        else:
            bias = bias[None]
        return self.proj(zl.attention(q, k, v, bias=bias))


class SwinLayer(nn.Module):
    def __init__(self, dim: int, heads: int, cfg: SwinConfig,
                 gen: torch.Generator):
        super().__init__()
        eps = cfg.layer_norm_eps
        hidden = int(dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, heads, cfg.window_size, gen)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = zl.linear(dim, hidden, gen)
        self.fc2 = zl.linear(hidden, dim, gen)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], window: int,
                shift: int) -> torch.Tensor:
        h, w = hw
        b, _, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        ph, pw = -h % window, -w % window
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = zl.constant(_shift_mask, (hp, wp, window, shift),
                               x.device)
        y = y.reshape(b, hp // window, window, wp // window, window, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)
        y = self.attn(y, mask)
        y = y.reshape(b, hp // window, wp // window, window, window, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, h * w, c)
        y = F.gelu(self.fc1(self.norm2(x)))
        return x + self.fc2(y)


class PatchMerge(nn.Module):
    def __init__(self, dim: int, cfg: SwinConfig, gen: torch.Generator):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=cfg.layer_norm_eps)
        # a raw (in, out) kernel in the JAX tree (no bias)
        self.reduction = zl.param((4 * dim, 2 * dim), gen)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, _, c = x.shape
        y = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                       y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
        return self.norm(y.reshape(b, -1, 4 * c)) @ self.reduction


class SwinStage(nn.Module):
    def __init__(self, si: int, cfg: SwinConfig, gen: torch.Generator):
        super().__init__()
        dim = cfg.stage_dim(si)
        self.depth = cfg.depths[si]
        for bi in range(self.depth):
            self.add_module(f"block_{bi}",
                            SwinLayer(dim, cfg.num_heads[si], cfg, gen))
        if si < len(cfg.depths) - 1:
            self.downsample = PatchMerge(dim, cfg, gen)


class SwinBackbone(nn.Module):
    def __init__(self, cfg: SwinConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.patch_proj = zl.conv(cfg.num_channels, cfg.embed_dim,
                                  cfg.patch_size, gen,
                                  stride=cfg.patch_size)
        self.embed_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        for i in cfg.out_indices:
            self.add_module(f"out_norm_{i}",
                            nn.LayerNorm(cfg.stage_dim(i - 1),
                                         eps=cfg.layer_norm_eps))
        for si in range(len(cfg.depths)):
            self.add_module(f"stage_{si}", SwinStage(si, cfg, gen))

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        """pixels (B, H, W, 3) normalised NHWC -> NHWC maps at the
        configured out stages (stride 4 * 2^(i-1), layer-normed), as
        ``SwinBackbone.forward`` with ``always_partition=True``."""
        cfg = self.cfg
        b = pixels.shape[0]
        x = zl.conv_nhwc(self.patch_proj, pixels)
        h, w = x.shape[1], x.shape[2]
        x = self.embed_norm(x.reshape(b, h * w, cfg.embed_dim))
        out: List[torch.Tensor] = []
        for si in range(len(cfg.depths)):
            stage = getattr(self, f"stage_{si}")
            for bi in range(stage.depth):
                shift = 0 if bi % 2 == 0 else cfg.window_size // 2
                x = getattr(stage, f"block_{bi}")(
                    x, (h, w), cfg.window_size, shift)
            if (si + 1) in cfg.out_indices:
                f = getattr(self, f"out_norm_{si + 1}")(x)
                out.append(f.reshape(b, h, w, cfg.stage_dim(si)))
            if hasattr(stage, "downsample"):
                x = stage.downsample(x, (h, w))
                h, w = (h + 1) // 2, (w + 1) // 2
        return out
