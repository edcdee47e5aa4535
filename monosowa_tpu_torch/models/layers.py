"""Shared model building blocks (torch, float32).

Initialisers follow Flax's in distribution (not in bits): lecun-normal
(truncated at two standard deviations) for convolutions and dense layers,
zero biases, unit norm scales.  Every initialiser draws from an explicit
``torch.Generator`` so a seed fixes the whole model.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor):
    receptive = w[0, 0].numel() if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / _fans(w)[0]) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


def xavier_uniform_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(w)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(w, -limit, limit, generator=gen)


def dense(d_in: int, d_out: int, gen: torch.Generator,
          kernel_init=lecun_normal_) -> nn.Linear:
    """``nn.Linear`` initialised like ``flax.linen.Dense``."""
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        if kernel_init is None:
            lin.weight.zero_()
        else:
            kernel_init(lin.weight, gen)
        lin.bias.zero_()
    return lin


def conv(c_in: int, c_out: int, k: int, gen: torch.Generator,
         stride: int = 1, padding: int = 0, bias: bool = True) -> nn.Conv2d:
    """``nn.Conv2d`` initialised like ``flax.linen.Conv``."""
    c = nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding, bias=bias)
    with torch.no_grad():
        lecun_normal_(c.weight, gen)
        if bias:
            c.bias.zero_()
    return c


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Logit with clamping (reference: MonoDETR utils/misc.py
    inverse_sigmoid)."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(eps, 1.0)
    x2 = (1.0 - x).clamp(eps, 1.0)
    return torch.log(x1) - torch.log(x2)


class MLP(nn.Module):
    """Multi-layer perceptron with ReLU between layers (reference:
    monodetr.py MLP).  ``layers[i]`` is Flax's ``Dense_i``."""

    def __init__(self, d_in: int, hidden_dim: int, output_dim: int,
                 num_layers: int, gen: torch.Generator):
        super().__init__()
        dims = [d_in] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            dense(a, b, gen) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class FrozenBatchNorm(nn.Module):
    """BatchNorm with all four tensors frozen (reference backbone.py:28-65),
    NCHW.  The tensors are buffers, so no optimizer sees them."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        w = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        return x * w[:, None, None] + b[:, None, None]


class Dropout(nn.Module):
    """Inverted dropout in training mode (``flax.linen.Dropout``: keep with
    probability 1 - p and scale by 1 / (1 - p)); the identity in eval mode.

    The mask is drawn from ``generator``, which ``MonoDETR.forward`` sets
    on every dropout of the model, or, when it is None, from the default
    generator of the tensor's device (seeded by ``torch.manual_seed``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    """Dot-product MHA, batch-first: (B, Lq, D) x (B, Lk, D), with dropout
    on the attention weights in training mode.

    Separate q/k/v/out projections and the softmax written out, one-to-one
    with the JAX package's module (not ``nn.MultiheadAttention``, whose
    packed in-projection has other weights)."""

    def __init__(self, d_model: int, num_heads: int, gen: torch.Generator,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = dense(d_model, d_model, gen)
        self.k_proj = dense(d_model, d_model, gen)
        self.v_proj = dense(d_model, d_model, gen)
        self.out_proj = dense(d_model, d_model, gen)
        self.attn_dropout = Dropout(dropout)

    def forward(self, query, key, value):
        d = query.shape[-1]
        dh = d // self.num_heads

        def split(x):
            return x.reshape(x.shape[:-1] + (self.num_heads, dh))

        q = split(self.q_proj(query))
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        attn = self.attn_dropout(torch.softmax(logits, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out_proj(out.reshape(query.shape[:-1] + (d,)))
