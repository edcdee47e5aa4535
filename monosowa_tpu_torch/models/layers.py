"""Shared model building blocks (torch).

Initialisers follow Flax's in distribution (not in bits): lecun-normal
(truncated at two standard deviations) for convolutions and dense layers,
zero biases, unit norm scales.  Every initialiser draws from an explicit
``torch.Generator`` so a seed fixes the whole model.

Mixed precision follows the JAX package's policy (its ``models/layers.py``):
the params stay float32; a dense or convolution layer built with a
``compute_dtype`` casts its input, weight and bias to that dtype and returns
its output in it, as ``flax.linen.Dense(dtype=...)`` does; a layer built
without one (Flax's ``dtype=None``: the norms, the heads) promotes its input
with its params, so a bfloat16 activation comes out float32.  The policy
string is resolved from the input's device at every call (``resolve_dtype``),
as the JAX package resolves it at trace time.  A resolved float32 casts
nothing: the layer computes in its params' own dtype, so a ``.double()``
model on the CPU stays float64.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


COMPUTE_DTYPES = ("auto", "float32", "bfloat16", "float64")


def check_compute_dtype(compute_dtype: str, device=None) -> str:
    """Raises ``ValueError`` for a policy outside ``COMPUTE_DTYPES`` and for
    float64 on a device other than the CPU; returns the policy."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}; the port has "
                         f"{COMPUTE_DTYPES} (float64 on the CPU only)")
    if compute_dtype == "float64" and device is not None \
            and torch.device(device).type != "cpu":
        raise ValueError(f"compute_dtype 'float64' runs on the CPU only, "
                         f"not on {device}")
    return compute_dtype


def resolve_dtype(compute_dtype: str, device) -> torch.dtype:
    """Model-level policy string -> torch dtype for tensors on ``device``.
    "auto" = bfloat16 on a CUDA device, float32 on the CPU (the JAX
    package's: bfloat16 on the TPU, float32 elsewhere)."""
    check_compute_dtype(compute_dtype, device)
    if compute_dtype == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" \
            else torch.float32
    return getattr(torch, compute_dtype)


def layer_dtype(compute_dtype: Optional[str], x: torch.Tensor,
                param: torch.Tensor) -> torch.dtype:
    """The dtype a layer with params like ``param`` computes in on ``x``:
    without a policy, the promotion of the two dtypes (Flax's
    ``dtype=None``); with one, its resolved dtype, where float32 means the
    params' own dtype."""
    if compute_dtype is None:
        return torch.promote_types(x.dtype, param.dtype)
    dt = resolve_dtype(compute_dtype, x.device)
    return param.dtype if dt == torch.float32 else dt


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


class Dense(nn.Linear):
    """``nn.Linear`` as ``flax.linen.Dense`` computes: in ``compute_dtype``
    (a policy string), or, with None, in the input's dtype promoted with the
    params'."""

    def __init__(self, d_in: int, d_out: int,
                 compute_dtype: Optional[str] = None):
        super().__init__(d_in, d_out)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = layer_dtype(self.compute_dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` as ``flax.linen.Conv`` computes (see ``Dense``)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 padding: int, bias: bool, compute_dtype: Optional[str]):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = layer_dtype(self.compute_dtype, x, self.weight)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def dense(d_in: int, d_out: int, gen: torch.Generator,
          kernel_init=lecun_normal_,
          compute_dtype: Optional[str] = None) -> Dense:
    """``Dense`` initialised like ``flax.linen.Dense``."""
    lin = Dense(d_in, d_out, compute_dtype)
    with torch.no_grad():
        if kernel_init is None:
            lin.weight.zero_()
        else:
            kernel_init(lin.weight, gen)
        lin.bias.zero_()
    return lin


def conv(c_in: int, c_out: int, k: int, gen: torch.Generator,
         stride: int = 1, padding: int = 0, bias: bool = True,
         compute_dtype: Optional[str] = None) -> Conv:
    """``Conv`` initialised like ``flax.linen.Conv``."""
    c = Conv(c_in, c_out, k, stride, padding, bias, compute_dtype)
    with torch.no_grad():
        lecun_normal_(c.weight, gen)
        if bias:
            c.bias.zero_()
    return c


class Embed(nn.Module):
    """A lookup table whose parameter is named like ``flax.linen.Embed``'s
    (``embedding``, (num_embeddings, features)), drawn as Flax's default
    embedding init draws it: truncated normal with variance 1 / features."""

    def __init__(self, num_embeddings: int, features: int,
                 gen: torch.Generator):
        super().__init__()
        std = math.sqrt(1.0 / features) / _TRUNC_STD
        self.embedding = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(num_embeddings, features), 0.0, std, -2 * std,
            2 * std, generator=gen))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding[idx]


class GroupNorm(nn.GroupNorm):
    """``flax.linen.GroupNorm`` (dtype None): the input is promoted with the
    params, so a bfloat16 activation is normalised and returned in
    float32."""

    def forward(self, x):
        return super().forward(
            x.to(torch.promote_types(x.dtype, self.weight.dtype)))


def group_norm(channels: int) -> GroupNorm:
    return GroupNorm(32, channels, eps=1e-5)


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
                 num_layers: int, gen: torch.Generator,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        dims = [d_in] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            dense(a, b, gen, compute_dtype=compute_dtype)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class FrozenBatchNorm(nn.Module):
    """BatchNorm with all four tensors frozen (reference backbone.py:28-65),
    NCHW.  The tensors are buffers, so no optimizer sees them.  Scale and
    shift are folded in the buffers' dtype, then cast to the activation's,
    so a bfloat16 backbone stays bfloat16 (JAX package layers.py:73-77)."""

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
        return (x * w.to(x.dtype)[:, None, None]
                + b.to(x.dtype)[:, None, None])


class Dropout(nn.Module):
    """Inverted dropout in training mode (``flax.linen.Dropout``: keep with
    probability 1 - p and scale by 1 / (1 - p)); the identity in eval mode.

    The mask is drawn from ``generator``, which ``MonoDETR.forward`` sets
    on every dropout of the model, or, when it is None, from the default
    generator of the tensor's device (seeded by ``torch.manual_seed``).
    With ``batch_shard`` (rank, n), also set by ``MonoDETR.forward``, x is
    rank's slice of a batch n times as long on its first axis (images
    first, as every dropout of the model sees them): the whole batch's mask
    is drawn and the slice kept, so n data-parallel ranks draw what one
    process does."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None
        self.batch_shard: Optional[Tuple[int, int]] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        shape = tuple(x.shape)
        if self.batch_shard is not None:
            rank, n = self.batch_shard
            shape = (n * shape[0],) + shape[1:]
        # the uniforms in float32 at the least: a bfloat16 activation gets
        # the mask a float32 one would
        keep = torch.rand(shape, generator=self.generator, device=x.device,
                          dtype=torch.promote_types(x.dtype, torch.float32)
                          ) >= self.p
        if self.batch_shard is not None:
            keep = keep[rank * x.shape[0]:(rank + 1) * x.shape[0]]
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    """Dot-product MHA, batch-first: (B, Lq, D) x (B, Lk, D), with dropout
    on the attention weights in training mode.

    Separate q/k/v/out projections and the softmax written out, one-to-one
    with the JAX package's module (not ``nn.MultiheadAttention``, whose
    packed in-projection has other weights).  The projections compute in
    ``compute_dtype``; the logits and the softmax in float32 at the least
    (JAX's ``preferred_element_type``), the weights then cast to v's
    dtype."""

    def __init__(self, d_model: int, num_heads: int, gen: torch.Generator,
                 dropout: float = 0.0, compute_dtype: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = dense(d_model, d_model, gen, compute_dtype=compute_dtype)
        self.k_proj = dense(d_model, d_model, gen, compute_dtype=compute_dtype)
        self.v_proj = dense(d_model, d_model, gen, compute_dtype=compute_dtype)
        self.out_proj = dense(d_model, d_model, gen,
                              compute_dtype=compute_dtype)
        self.attn_dropout = Dropout(dropout)

    def forward(self, query, key, value,
                attn_mask: Optional[torch.Tensor] = None):
        """``attn_mask`` (Lq, Lk) bool, True = blocked (the DN-DETR block
        structure): those logits are set to -1e9 before the softmax."""
        d = query.shape[-1]
        dh = d // self.num_heads

        def split(x):
            return x.reshape(x.shape[:-1] + (self.num_heads, dh))

        q = split(self.q_proj(query))
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        acc = torch.promote_types(q.dtype, torch.float32)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) \
            / math.sqrt(dh)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, -1e9)
        attn = self.attn_dropout(torch.softmax(logits, dim=-1).to(v.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out_proj(out.reshape(query.shape[:-1] + (d,)))
