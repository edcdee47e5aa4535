"""The one-stream ViT single-object tracker of the Waymo mask tracking.

Counterpart of the JAX package's ``models/vit_tracker.py`` (the
OSTrack/ODTrack family that stands in for the reference's external ODTrack,
tracker_ODTrack.py:10): template and search crops and the propagated track
tokens attended jointly by a ViT, then a centre / offset / size head.  The
submodules carry the names of the JAX param tree (``patch_proj``,
``pos_z``, ``pos_x``, ``track_token``, ``block_<i>.{norm1,qkv,proj,norm2,
fc1,fc2}``, ``final_norm``, ``{score,offset,size}_head.convs.<j>``), so
``convert.load_zoo_params`` fills it from a ``vit_tracker`` zoo checkpoint
and ``zoo_params`` writes one; ``import_torch_tracker`` writes that tree
from a torch tracker's state dict.  Crops are NHWC, as in the JAX module.

Random weights are drawn on the host from an explicit ``torch.Generator``
with the distribution of the JAX ``init_tracker_params``: normal with std
0.02 for kernels and tables, zero biases, unit norm scales.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from monosowa_tpu_torch.models.zoo_layers import (conv, hf_array, hf_conv,
                                                  hf_dense, hf_norm, linear,
                                                  param)


@dataclasses.dataclass(frozen=True)
class ViTTrackerConfig:
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 6
    mlp_ratio: float = 4.0
    patch_size: int = 16
    template_size: int = 128
    search_size: int = 256
    num_track_tokens: int = 1
    layer_norm_eps: float = 1e-6

    @property
    def grid_t(self) -> int:
        return self.template_size // self.patch_size

    @property
    def grid_s(self) -> int:
        return self.search_size // self.patch_size


class _Block(nn.Module):
    def __init__(self, cfg: ViTTrackerConfig, gen: torch.Generator):
        super().__init__()
        c = cfg.hidden_size
        m = int(c * cfg.mlp_ratio)
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.qkv = linear(c, 3 * c, gen)
        self.proj = linear(c, c, gen)
        self.fc1 = linear(c, m, gen)
        self.fc2 = linear(m, c, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.cfg.num_heads
        d = c // h
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        probs = torch.softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), -1).to(x.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, c)
        x = x + self.proj(att)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class _Head(nn.Module):
    def __init__(self, dims, gen: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(conv(dims[i], dims[i + 1], 3, gen,
                                        padding=1)
                                   for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in and out; ReLU between the convolutions."""
        y = x.permute(0, 3, 1, 2)
        for j, layer in enumerate(self.convs):
            y = layer(y)
            if j < len(self.convs) - 1:
                y = F.relu(y)
        return y.permute(0, 2, 3, 1)


class ViTTracker(nn.Module):
    """JAX ``tracker_forward`` as a module."""

    def __init__(self, cfg: ViTTrackerConfig = ViTTrackerConfig(),
                 device=None, seed: int = 0):
        """Weights are drawn on the host from a ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default: the CPU; the
        backends pass theirs)."""
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        c = cfg.hidden_size
        self.patch_proj = conv(3, c, cfg.patch_size, gen,
                               stride=cfg.patch_size)
        self.pos_z = param((1, cfg.grid_t ** 2, c), gen)
        self.pos_x = param((1, cfg.grid_s ** 2, c), gen)
        self.track_token = param((1, cfg.num_track_tokens, c), gen)
        self.final_norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.score_head = _Head([c, c // 2, 1], gen)
        self.offset_head = _Head([c, c // 2, 2], gen)
        self.size_head = _Head([c, c // 2, 2], gen)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", _Block(cfg, gen))
        if device is not None:
            self.to(device)
        self.eval()

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, g*g, C) patch tokens."""
        x = self.patch_proj(img.permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1).reshape(img.shape[0], -1,
                                             self.cfg.hidden_size)

    def forward(self, template: torch.Tensor, search: torch.Tensor,
                track_tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """template (B, T, T, 3), search (B, S, S, 3) normalised crops,
        track_tokens (B, K, C) from the previous frame -> (box (B, 4) as
        normalised search-crop cxcywh, score map (B, gs, gs), new track
        tokens (B, K, C))."""
        cfg = self.cfg
        zt = self.embed(template) + self.pos_z
        xt = self.embed(search) + self.pos_x
        n_z = zt.shape[1]
        k = cfg.num_track_tokens
        tokens = torch.cat([track_tokens, zt, xt], 1)
        for i in range(cfg.num_layers):
            tokens = getattr(self, f"block_{i}")(tokens)
        tokens = self.final_norm(tokens)
        new_track = tokens[:, :k]
        xs = tokens[:, k + n_z:]
        gs = cfg.grid_s
        fmap = xs.reshape(xs.shape[0], gs, gs, cfg.hidden_size)
        score = self.score_head(fmap)[..., 0]
        offset = torch.sigmoid(self.offset_head(fmap))
        size = torch.sigmoid(self.size_head(fmap))
        idx = torch.argmax(score.reshape(score.shape[0], -1), -1)
        iy, ix = idx // gs, idx % gs
        bi = torch.arange(score.shape[0], device=score.device)
        off = offset[bi, iy, ix]
        sz = size[bi, iy, ix]
        cx = (ix.to(off.dtype) + off[:, 0]) / gs
        cy = (iy.to(off.dtype) + off[:, 1]) / gs
        box = torch.stack([cx, cy, sz[:, 0], sz[:, 1]], -1)
        return box, score, new_track


# ---------------------------------------------------------------- import


def import_torch_tracker(state: Dict[str, Any],
                         cfg: ViTTrackerConfig) -> Dict[str, Any]:
    """A torch tracker's state dict in the layout of the JAX package's
    torch mirror (tests/test_vit_tracker_parity.py: ``patch_proj``
    Conv2d, ``pos_z`` / ``pos_x`` / ``track_token`` tables,
    ``blocks.{i}.{norm1,qkv,proj,norm2,fc1,fc2}``, ``final_norm``,
    ``{score,offset,size}_head.{0,2}`` Conv2d) -> the zoo's param tree
    (the JAX package's ``import_torch_tracker`` tree, leaf for leaf)."""
    p: Dict[str, Any] = {
        "patch_proj": hf_conv(state, "patch_proj"),
        "pos_z": hf_array(state, "pos_z"),
        "pos_x": hf_array(state, "pos_x"),
        "track_token": hf_array(state, "track_token"),
        "final_norm": hf_norm(state, "final_norm"),
    }
    for head in ("score_head", "offset_head", "size_head"):
        p[head] = {"convs": [hf_conv(state, f"{head}.0"),
                             hf_conv(state, f"{head}.2")]}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        p[f"block_{i}"] = {
            "norm1": hf_norm(state, b + "norm1"),
            "norm2": hf_norm(state, b + "norm2"),
            **{k: hf_dense(state, b + k)
               for k in ("qkv", "proj", "fc1", "fc2")},
        }
    return p
