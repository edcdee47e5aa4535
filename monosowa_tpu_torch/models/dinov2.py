"""DINOv2 vision transformer (the trunk of the model zoo's depth network).

Counterpart of the JAX package's ``models/dinov2.py`` (Hugging Face
``Dinov2Model`` / ``Dinov2WithRegistersModel`` layout): patch embedding,
class (and register) tokens, the position table resampled to the patch
grid with torch's bicubic (antialiased for the with-registers variant),
pre-norm layers with layer scale, the GELU or SwiGLU FFN, and a float32
softmax.  Submodules are named after the JAX param tree (``layer_3.
attention.query``, ``patch_proj``, ``final_norm``), so
``convert.load_zoo_params`` fills them by path; ``import_hf_dinov2``
writes that tree from a transformers state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from monosowa_tpu_torch.models import zoo_layers as zl
from monosowa_tpu_torch.ops.resize import resize_bicubic_torch


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    hidden_size: int = 384
    num_hidden_layers: int = 12
    num_attention_heads: int = 6
    mlp_ratio: float = 4.0
    patch_size: int = 14
    num_channels: int = 3
    pos_grid: int = 37            # position-embedding grid side (image//patch)
    layer_norm_eps: float = 1e-6
    use_swiglu_ffn: bool = False
    num_register_tokens: int = 0
    antialias_pos_interp: bool = False  # with registers: antialiased bicubic

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def swiglu_hidden(self) -> int:
        h = int(self.hidden_size * self.mlp_ratio)
        return (int(h * 2 / 3) + 7) // 8 * 8


class Attention(nn.Module):
    def __init__(self, c: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.heads = heads
        self.query = zl.linear(c, c, gen)
        self.key = zl.linear(c, c, gen)
        self.value = zl.linear(c, c, gen)
        self.out = zl.linear(c, c, gen)

    def forward(self, x):
        b, n, c = x.shape
        h = self.heads
        q = self.query(x).reshape(b, n, h, c // h)
        k = self.key(x).reshape(b, n, h, c // h)
        v = self.value(x).reshape(b, n, h, c // h)
        return self.out(zl.attention(q, k, v))


class Mlp(nn.Module):
    def __init__(self, cfg: Dinov2Config, gen: torch.Generator):
        super().__init__()
        c = cfg.hidden_size
        self.swiglu = cfg.use_swiglu_ffn
        if self.swiglu:
            self.weights_in = zl.linear(c, 2 * cfg.swiglu_hidden(), gen)
            self.weights_out = zl.linear(cfg.swiglu_hidden(), c, gen)
        else:
            self.fc1 = zl.linear(c, int(c * cfg.mlp_ratio), gen)
            self.fc2 = zl.linear(int(c * cfg.mlp_ratio), c, gen)

    def forward(self, x):
        if self.swiglu:
            x1, x2 = self.weights_in(x).chunk(2, -1)
            return self.weights_out(F.silu(x1) * x2)
        return self.fc2(F.gelu(self.fc1(x)))


class Layer(nn.Module):
    def __init__(self, cfg: Dinov2Config, gen: torch.Generator):
        super().__init__()
        c, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(c, eps=eps)
        self.attention = Attention(c, cfg.num_attention_heads, gen)
        self.layer_scale1 = nn.Parameter(torch.ones(c))
        self.norm2 = nn.LayerNorm(c, eps=eps)
        self.mlp = Mlp(cfg, gen)
        self.layer_scale2 = nn.Parameter(torch.ones(c))

    def forward(self, x):
        x = x + self.attention(self.norm1(x)) * self.layer_scale1
        return x + self.mlp(self.norm2(x)) * self.layer_scale2


class Dinov2(nn.Module):
    def __init__(self, cfg: Dinov2Config, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.cls_token = zl.param((1, 1, c), gen)
        self.position_embeddings = zl.param(
            (1, cfg.pos_grid * cfg.pos_grid + 1, c), gen)
        self.patch_proj = zl.conv(cfg.num_channels, c, cfg.patch_size, gen,
                                  stride=cfg.patch_size)
        self.final_norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, c))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", Layer(cfg, gen))

    def _interp_pos(self, ph: int, pw: int) -> torch.Tensor:
        """The (1, G*G+1, C) table resampled to (1, ph*pw+1, C)
        (modeling_dinov2.py interpolate_pos_encoding)."""
        g, pos = self.cfg.pos_grid, self.position_embeddings
        if ph == g and pw == g:
            return pos
        grid = resize_bicubic_torch(
            pos[:, 1:].reshape(1, g, g, -1), (ph, pw), align_corners=False,
            antialias=self.cfg.antialias_pos_interp)
        return torch.cat([pos[:, :1], grid.reshape(1, ph * pw, -1)], 1)

    def hidden_states(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        """pixels (B, H, W, 3) normalised NHWC -> [embeddings, layer 1,
        ...], token sequences (B, 1 + registers + ph*pw, C)."""
        cfg = self.cfg
        b, h, w, _ = pixels.shape
        ph, pw = h // cfg.patch_size, w // cfg.patch_size
        x = zl.conv_nhwc(self.patch_proj, pixels).reshape(
            b, ph * pw, cfg.hidden_size)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], 1)
        x = x + self._interp_pos(ph, pw)
        if cfg.num_register_tokens:
            x = torch.cat([x[:, :1], self.register_tokens.expand(b, -1, -1),
                           x[:, 1:]], 1)
        states = [x]
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x)
            states.append(x)
        return states

    def features(self, pixels: torch.Tensor, out_indices: Sequence[int],
                 apply_layernorm: bool = True) -> List[torch.Tensor]:
        """``Dinov2Backbone.forward`` (reshape_hidden_states False): the
        hidden states by index (0 = embeddings), with the final layer norm;
        the class (and register) tokens kept."""
        states = self.hidden_states(pixels)
        return [self.final_norm(states[i]) if apply_layernorm else states[i]
                for i in out_indices]


# ---------------------------------------------------------------- import


def import_hf_dinov2(state: Dict[str, Any], cfg: Dinov2Config,
                     prefix: str = "") -> Dict[str, Any]:
    """A transformers Dinov2(WithRegisters)(Model|Backbone) state dict
    (optionally under ``prefix``, e.g. ``backbone.``) -> the zoo's param
    tree (the JAX package's ``import_hf_dinov2`` tree, leaf for leaf); a
    state without the final layer norm gets the identity one."""
    def g(n):
        return zl.hf_array(state, prefix + n)

    def lin(n):
        return zl.hf_dense(state, prefix + n)

    p: Dict[str, Any] = {
        "cls_token": g("embeddings.cls_token"),
        "position_embeddings": g("embeddings.position_embeddings"),
        "patch_proj": {
            "kernel": g("embeddings.patch_embeddings.projection.weight"
                        ).transpose(2, 3, 1, 0),
            "bias": g("embeddings.patch_embeddings.projection.bias")},
    }
    if cfg.num_register_tokens:
        p["register_tokens"] = g("embeddings.register_tokens")
    if prefix + "layernorm.weight" in state:
        p["final_norm"] = {"scale": g("layernorm.weight"),
                           "bias": g("layernorm.bias")}
    else:
        p["final_norm"] = {"scale": np.ones(cfg.hidden_size, np.float32),
                           "bias": np.zeros(cfg.hidden_size, np.float32)}
    for i in range(cfg.num_hidden_layers):
        base = f"encoder.layer.{i}."
        mlp = ({"weights_in": lin(base + "mlp.weights_in"),
                "weights_out": lin(base + "mlp.weights_out")}
               if cfg.use_swiglu_ffn else
               {"fc1": lin(base + "mlp.fc1"), "fc2": lin(base + "mlp.fc2")})
        p[f"layer_{i}"] = {
            "norm1": {"scale": g(base + "norm1.weight"),
                      "bias": g(base + "norm1.bias")},
            "norm2": {"scale": g(base + "norm2.weight"),
                      "bias": g(base + "norm2.bias")},
            "attention": {
                "query": lin(base + "attention.attention.query"),
                "key": lin(base + "attention.attention.key"),
                "value": lin(base + "attention.attention.value"),
                "out": lin(base + "attention.output.dense")},
            "layer_scale1": g(base + "layer_scale1.lambda1"),
            "layer_scale2": g(base + "layer_scale2.lambda1"),
            "mlp": mlp,
        }
    return p


def config_from_hf(hf_cfg: Any) -> Dinov2Config:
    """A transformers Dinov2Config / Dinov2WithRegistersConfig (or
    ``sowa/hf_checkpoint.py``'s tree of its ``config.json``) ->
    :class:`Dinov2Config`."""
    return Dinov2Config(
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        mlp_ratio=hf_cfg.mlp_ratio,
        patch_size=hf_cfg.patch_size,
        num_channels=hf_cfg.num_channels,
        pos_grid=hf_cfg.image_size // hf_cfg.patch_size,
        layer_norm_eps=hf_cfg.layer_norm_eps,
        use_swiglu_ffn=hf_cfg.use_swiglu_ffn,
        num_register_tokens=getattr(hf_cfg, "num_register_tokens", 0),
        antialias_pos_interp=getattr(hf_cfg, "num_register_tokens", 0) > 0,
    )
