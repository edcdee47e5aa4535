"""Building blocks shared by the model zoo's networks (``swin.py``,
``mask2former.py``, ``dinov2.py``, ``depth_anything.py``).

The JAX package writes each network as a function over a param tree with
NHWC images.  The port keeps NHWC at every public function (so the tests
compare like with like) and names its submodules after the tree's keys, so
``convert.load_zoo_params`` / ``zoo_params`` map the two by path alone:
a ``Linear``'s ``kernel`` is its transposed weight, a ``Conv2d``'s HWIO
``kernel`` its OIHW weight, a norm's ``scale`` its weight, and a raw
parameter keeps its name and layout.

Random weights (no checkpoint can be fetched) are drawn on the host from an
explicit ``torch.Generator``: normal with std 0.02 for dense and
convolution kernels and raw tables, zero biases, unit norm scales (the
Hugging Face initialisers' distribution).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

STD = 0.02


def _normal_(t: torch.Tensor, gen: torch.Generator, std: float = STD):
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)
    return t


def linear(n_in: int, n_out: int, gen: torch.Generator,
           bias: bool = True) -> nn.Linear:
    m = nn.utils.skip_init(nn.Linear, n_in, n_out, bias=bias)
    _normal_(m.weight, gen)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def conv(c_in: int, c_out: int, k: int, gen: torch.Generator,
         stride: int = 1, padding: int = 0, bias: bool = True) -> nn.Conv2d:
    m = nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride=stride,
                           padding=padding, bias=bias)
    _normal_(m.weight, gen)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def conv_transpose(c_in: int, c_out: int, k: int, gen: torch.Generator
                   ) -> nn.ConvTranspose2d:
    """ConvTranspose2d(kernel=k, stride=k, padding=0), as DPT's reassemble
    upsamples."""
    m = nn.utils.skip_init(nn.ConvTranspose2d, c_in, c_out, k, stride=k)
    _normal_(m.weight, gen)
    nn.init.zeros_(m.bias)
    return m


def param(shape, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(_normal_(torch.empty(shape), gen))


def conv_nhwc(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A convolution of an NHWC tensor (an NCHW view with channels-last
    strides in and out: no copy)."""
    return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def group_norm_nhwc(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x.permute(0, 3, 1, 2), m.num_groups, m.weight,
                        m.bias, m.eps).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=256)
def constant(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``fn(*args)``, a numpy table of the shapes (the JAX package's
    compile-time constants: position embeddings, reference points, window
    masks), as a tensor on ``device``, built and copied once."""
    return torch.from_numpy(fn(*args)).to(device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over (B, N, heads, d) projections, the softmax in
    float32 (float64 for float64 inputs): ``bias`` is added to the (B, heads, Q, K) logits and ``mask``
    (True = disallowed) sets them to -inf.  -> (B, Q, heads * d).  The
    scale 1 / sqrt(d) multiplies q rather than the logits (Q x d values,
    not Q x K; exactly the same where d is a power of 4, as DINOv2's 64)."""
    b, nq, heads, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q * (1.0 / math.sqrt(d)), k)
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.promote_types(
        logits.dtype, torch.float32)), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, nq,
                                                             heads * d)
