"""Foreground depth predictor + depth encoder (torch).

Behavioral contract (MonoDETR depth_predictor/depth_predictor.py:7-104):
LID depth bins (num_bins+1 values, quadratic spacing, depth_predictor.py:21-24);
fuse the stride 8/16/32 projected features to the stride-16 grid; conv head;
(bins+1)-way logits; softmax-weighted expected depth map; one transformer
encoder layer over the depth features; learned per-meter depth positional
embedding sampled by linear interpolation at the predicted depth
(interpolate_depth_embed, :93-104).

Convolutions run NCHW; the outputs keep the JAX package's NHWC layout.
Mixed precision as in the JAX package (depth_predictor.py:53-125): the
encoder layer and the convolutions compute in ``compute_dtype``, the
GroupNorms promote to float32, the classifier and its softmax are float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from monosowa_tpu_torch.models.layers import (Dropout, MultiHeadAttention,
                                              conv, dense, group_norm)


def lid_bin_values(num_bins: int, depth_min: float, depth_max: float) -> np.ndarray:
    """(num_bins + 1,) LID bin centers + the depth_max sentinel."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    indice = np.arange(num_bins, dtype=np.float32)
    value = (indice + 0.5) ** 2 * bin_size / 2 - bin_size / 8 + depth_min
    return np.concatenate([value, [depth_max]]).astype(np.float32)


# the depth encoder's own dropout, not the detector's ``dropout`` (JAX
# package depth_predictor.py:52, the reference's fixed 0.1)
DEPTH_ENCODER_DROPOUT = 0.1


class DepthEncoderLayer(nn.Module):
    """One post-norm transformer encoder layer (depth_predictor/transformer.py).
    ``linear1``/``linear2`` are Flax's ``Dense_0``/``Dense_1``."""

    def __init__(self, d_model: int, gen: torch.Generator, nhead: int = 8,
                 dim_feedforward: int = 256,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        dropout = DEPTH_ENCODER_DROPOUT
        self.self_attn = MultiHeadAttention(d_model, nhead, gen, dropout,
                                            compute_dtype)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense(d_model, dim_feedforward, gen,
                             compute_dtype=compute_dtype)
        self.dropout2 = Dropout(dropout)
        self.linear2 = dense(dim_feedforward, d_model, gen,
                             compute_dtype=compute_dtype)
        self.dropout3 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos):
        q = k = src + pos
        src = self.norm1(src + self.dropout1(self.self_attn(q, k, src)))
        ff = self.linear2(self.dropout2(torch.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(ff))


class DepthPredictor(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int = 256,
                 num_depth_bins: int = 80, depth_min: float = 1e-3,
                 depth_max: float = 60.0,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.depth_max = depth_max
        cd = compute_dtype
        self.proj = conv(d_model, d_model, 1, gen, compute_dtype=cd)
        self.upsample = conv(d_model, d_model, 1, gen, compute_dtype=cd)
        self.downsample = conv(d_model, d_model, 3, gen, stride=2, padding=1,
                               compute_dtype=cd)
        # Flax's GroupNorm_0..4, in call order
        self.proj_norm = group_norm(d_model)
        self.upsample_norm = group_norm(d_model)
        self.downsample_norm = group_norm(d_model)
        self.head1 = conv(d_model, d_model, 3, gen, padding=1,
                          compute_dtype=cd)
        self.head1_norm = group_norm(d_model)
        self.head2 = conv(d_model, d_model, 3, gen, padding=1,
                          compute_dtype=cd)
        self.head2_norm = group_norm(d_model)
        self.classifier = conv(d_model, num_depth_bins + 1, 1, gen)
        self.register_buffer("bin_values", torch.from_numpy(
            lid_bin_values(num_depth_bins, depth_min, depth_max)),
            persistent=False)
        self.encoder = DepthEncoderLayer(d_model, gen, compute_dtype=cd)
        self.depth_pos_embed = nn.Parameter(torch.empty(
            int(depth_max) + 1, d_model).normal_(0.0, 1.0, generator=gen))

    def forward(self, features, pos_16):
        """features: [stride8, stride16, stride32] NCHW (d_model each, after
        input_proj); pos_16: (H16, W16, d_model) sine embedding.

        Returns (depth_logits, depth_embed, weighted_depth (B,H,W),
        depth_pos_embed_ip), NHWC, all on the stride-16 grid."""
        f8, f16, f32 = features
        b, d, h16, w16 = f16.shape

        src16 = self.proj_norm(self.proj(f16))
        # 2x bilinear upsample, half-pixel centres with edge clamping
        # (= jax.image.resize "bilinear" for an upsample)
        f32u = F.interpolate(f32, size=(h16, w16), mode="bilinear",
                             align_corners=False)
        src32 = self.upsample_norm(self.upsample(f32u))
        src8 = self.downsample_norm(self.downsample(f8))
        src = (src8 + src16 + src32) / 3.0

        y = torch.relu(self.head1_norm(self.head1(src)))
        y = torch.relu(self.head2_norm(self.head2(y)))

        depth_logits = self.classifier(y).permute(0, 2, 3, 1)   # NHWC
        probs = torch.softmax(depth_logits, dim=-1)
        weighted_depth = (probs * self.bin_values).sum(-1)      # (B, H, W)

        seq = y.flatten(2).transpose(1, 2)                      # (B, HW, D)
        pos_seq = pos_16.reshape(1, h16 * w16, d)
        depth_embed = self.encoder(seq, pos_seq).reshape(b, h16, w16, d)

        table = self.depth_pos_embed
        dd = weighted_depth.clamp(0.0, self.depth_max)
        lo = torch.floor(dd)
        delta = (dd - lo)[..., None]
        lo_i = lo.long()
        hi_i = (lo_i + 1).clamp(max=table.shape[0] - 1)
        ip = table[lo_i] * (1 - delta) + table[hi_i] * delta    # (B,H,W,D)
        return depth_logits, depth_embed + ip, weighted_depth, ip
