"""Depth-aware transformer: visual encoder + depth-aware decoder (torch).

Behavioral contract (MonoDETR/lib/models/monodetr/depthaware_transformer.py):

* ``MSDeformAttnModule`` = ops/modules/ms_deform_attn.py:70-163: learned
  sampling offsets (zero weight, ring-pattern bias init :106-121), attention
  weights softmaxed over levels x points, value/output projections; 2-dof
  reference points offset by offsets/(W,H), 6-dof (cx,cy,l,r,t,b) boxes
  offset by offsets/n_points * (l+r, t+b)/2 (:144-152).
* ``VisualEncoderLayer``/``VisualEncoder`` = :315-384 — deformable self-attn
  over the flattened 4-level feature pyramid, reference points at pixel
  centers.
* ``DepthAwareDecoderLayer`` = :387-516 — depth cross-attention,
  group-wise self-attention (Group-DETR: in training each group of queries
  attends only within itself, by folding the groups into the batch axis,
  :480-498; with DN-DETR queries, under a block mask instead),
  deformable cross-attention, FFN.  Like the JAX package it
  reproduces the reference's effective computation: q/k go through the
  sa_* projections and then the attention's own projections; the value is
  the raw target (:409).

All sequences are batch-first; padding masks are dropped because the
reference runs fixed 1280x384 inputs where masks are always all-valid.
Dropout (``layers.Dropout``) acts in training mode only.

Mixed precision as in the JAX package (transformer.py:64-140, :151-164,
:192-290): ``value_proj``, ``output_proj``, the FFNs and the decoder's self-
and cross-attention compute in ``compute_dtype``; the sampling offsets and
attention weights are float32 dense layers on the float32 query, so the
locations keep their mantissa; MSDA returns float32 (it reads bfloat16 value
rows and sums in float32), which ``output_proj`` casts back; the residual
sums and LayerNorms stay float32.

The explicit MSDA backends ``mxu``, ``pallas`` and ``onehot`` read bfloat16
value rows whatever the compute dtype, as the JAX package's do (K1's bf16
quad rows, ``ops/msda_mxu.py:235``; K4's ``value.astype(bfloat16)``,
``ops/msda_pallas.py:98``; the one-hot gathers' bf16 operands,
``ops/msda.py:157-205``): value is rounded to bfloat16 before the MSDA, so
on the card they run the kernels' bf16 forms.  ``auto`` and ``xla`` read
value in the compute dtype (the JAX ``auto`` is ``xla`` off the TPU).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from monosowa_tpu_torch.models.layers import (Dropout, MultiHeadAttention,
                                              dense, xavier_uniform_)
from monosowa_tpu_torch.ops.msda import ms_deform_attn

# MSDA backend names of the JAX package; on the card every one of them is
# the CUDA kernel, on the CPU the plain version (ops.msda.ms_deform_attn)
MSDA_BACKENDS = ("auto", "mxu", "pallas", "onehot", "xla")
# the backends whose JAX counterparts read bfloat16 value rows
BF16_ROW_BACKENDS = ("mxu", "pallas", "onehot")


def bf16_rows(value: torch.Tensor) -> torch.Tensor:
    """value rounded to bfloat16, the rows the bf16-row backends read; a
    float64 value (on the CPU) keeps its dtype, so that its float64 sums
    read the same rounded rows."""
    rows = value.to(torch.bfloat16)
    return rows.to(torch.float64) if value.dtype == torch.float64 else rows


def ring_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Sampling-offset bias: head h points along angle 2*pi*h/M, point i at
    ring radius i + 1 (ms_deform_attn.py:106-121)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttnModule(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int = 256,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 backend: str = "auto", compute_dtype: Optional[str] = None):
        super().__init__()
        if backend not in MSDA_BACKENDS:
            raise ValueError(f"msda_backend {backend!r}: want one of "
                             f"{MSDA_BACKENDS}")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, \
            n_points
        self.backend = backend
        self.value_proj = dense(d_model, d_model, gen, xavier_uniform_,
                                compute_dtype)
        self.sampling_offsets = dense(d_model, n_heads * n_levels * n_points
                                      * 2, gen, kernel_init=None)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                ring_bias(n_heads, n_levels, n_points)))
        self.attention_weights = dense(d_model, n_heads * n_levels * n_points,
                                       gen, kernel_init=None)
        self.output_proj = dense(d_model, d_model, gen, xavier_uniform_,
                                 compute_dtype)
        # the MSDA function this module calls
        self.msda = ms_deform_attn

    def forward(self, query, reference_points, src_flat,
                spatial_shapes: Sequence[Tuple[int, int]]):
        """query (B, Q, D); reference_points (B, Q, L, 2|6) in [0,1];
        src_flat (B, sum HW, D)."""
        b, lq, d = query.shape
        m, l, p = self.n_heads, self.n_levels, self.n_points

        value = self.value_proj(src_flat).reshape(b, -1, m, d // m)
        if self.backend in BF16_ROW_BACKENDS:
            value = bf16_rows(value)
        offsets = self.sampling_offsets(query).reshape(b, lq, m, l, p, 2)
        weights = torch.softmax(
            self.attention_weights(query).reshape(b, lq, m, l * p), dim=-1)
        weights = weights.reshape(b, lq, m, l, p)

        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                      dtype=torch.float32,
                                      device=query.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        else:
            wh = (reference_points[:, :, None, :, None, 2::2]
                  + reference_points[:, :, None, :, None, 3::2])
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / p * wh * 0.5)
        out = self.msda(value, spatial_shapes, loc, weights)
        return self.output_proj(out)


class VisualEncoderLayer(nn.Module):
    """``linear1``/``linear2`` are Flax's ``Dense_0``/``Dense_1``."""

    def __init__(self, gen: torch.Generator, d_model: int = 256,
                 d_ffn: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, msda_backend: str = "auto",
                 dropout: float = 0.1, compute_dtype: Optional[str] = None):
        super().__init__()
        self.self_attn = MSDeformAttnModule(gen, d_model, n_levels, n_heads,
                                            n_points, msda_backend,
                                            compute_dtype)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense(d_model, d_ffn, gen,
                             compute_dtype=compute_dtype)
        self.dropout2 = Dropout(dropout)
        self.linear2 = dense(d_ffn, d_model, gen,
                             compute_dtype=compute_dtype)
        self.dropout3 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes):
        attn = self.self_attn(src + pos, reference_points, src,
                              spatial_shapes)
        src = self.norm1(src + self.dropout1(attn))
        ff = self.linear2(self.dropout2(torch.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(ff))


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]]
                             ) -> np.ndarray:
    """(sum HW, L, 2) pixel-center reference points in [0, 1]
    (depthaware_transformer.py:366-378 with valid_ratios == 1)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, 0)
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))


class VisualEncoder(nn.Module):
    def __init__(self, gen: torch.Generator, num_layers: int = 3,
                 d_model: int = 256, d_ffn: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4,
                 msda_backend: str = "auto", dropout: float = 0.1,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layer{i}", VisualEncoderLayer(
                gen, d_model, d_ffn, n_levels, n_heads, n_points,
                msda_backend, dropout, compute_dtype))
        self.num_layers = num_layers

    def forward(self, src, pos, spatial_shapes):
        ref = torch.from_numpy(encoder_reference_points(spatial_shapes)).to(
            src.device)
        ref = ref[None].expand(src.shape[0], -1, -1, -1)
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, pos, ref, spatial_shapes)
        return src


class DepthAwareDecoderLayer(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int = 256,
                 d_ffn: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, msda_backend: str = "auto",
                 dropout: float = 0.1, group_num: int = 11,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        cd = compute_dtype
        self.group_num = group_num
        self.cross_attn_depth = MultiHeadAttention(d_model, n_heads, gen,
                                                   dropout, cd)
        self.dropout_depth = Dropout(dropout)
        self.norm_depth = nn.LayerNorm(d_model, eps=1e-5)
        self.sa_qcontent_proj = dense(d_model, d_model, gen, compute_dtype=cd)
        self.sa_qpos_proj = dense(d_model, d_model, gen, compute_dtype=cd)
        self.sa_kcontent_proj = dense(d_model, d_model, gen, compute_dtype=cd)
        self.sa_kpos_proj = dense(d_model, d_model, gen, compute_dtype=cd)
        self.self_attn = MultiHeadAttention(d_model, n_heads, gen, dropout,
                                            cd)
        self.dropout_sa = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttnModule(gen, d_model, n_levels, n_heads,
                                             n_points, msda_backend, cd)
        self.dropout_ca = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense(d_model, d_ffn, gen, compute_dtype=cd)
        self.dropout_ffn = Dropout(dropout)
        self.linear2 = dense(d_ffn, d_model, gen, compute_dtype=cd)
        self.dropout_out = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def group_self_attn(self, q_in, k_in, v_in, attn_mask=None):
        """Self-attention over the queries.  With ``attn_mask`` (the
        DN-DETR path) every query of the image attends under the mask,
        which encodes both the denoising groups' and the Group-DETR groups'
        isolation (JAX package transformer.py:242-248).  Otherwise, in
        training with several groups, (B, g * nq, d) is folded to
        (B * g, nq, d) so each group attends only within itself
        (:249-264)."""
        if attn_mask is not None:
            return self.self_attn(q_in, k_in, v_in, attn_mask=attn_mask)
        if not (self.training and self.group_num > 1):
            return self.self_attn(q_in, k_in, v_in)
        b, gq, d = q_in.shape
        g = self.group_num

        def fold(x):
            return x.reshape(b * g, gq // g, d)

        return self.self_attn(fold(q_in), fold(k_in), fold(v_in)).reshape(
            b, gq, d)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                depth_embed_seq, self_attn_mask=None):
        # depth cross-attention
        tgt = self.norm_depth(tgt + self.dropout_depth(self.cross_attn_depth(
            tgt, depth_embed_seq, depth_embed_seq)))

        # group-wise self-attention over the queries
        qk = tgt + query_pos
        q_in = self.sa_qcontent_proj(qk) + self.sa_qpos_proj(qk)
        k_in = self.sa_kcontent_proj(qk) + self.sa_kpos_proj(qk)
        tgt = self.norm2(tgt + self.dropout_sa(
            self.group_self_attn(q_in, k_in, tgt, self_attn_mask)))

        # deformable cross-attention
        tgt = self.norm1(tgt + self.dropout_ca(self.cross_attn(
            tgt + query_pos, reference_points, src, spatial_shapes)))

        # FFN
        ff = self.linear2(self.dropout_ffn(torch.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout_out(ff))
