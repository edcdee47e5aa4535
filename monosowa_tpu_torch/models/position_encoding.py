"""2D positional embeddings: sine (default, numpy on the host) and learned
(flag-selectable, torch).

Behavioral contract: MonoDETR position_encoding.py:20-99.  Sine =
PositionEmbeddingSine with normalize=True, scale=2pi, N_steps =
hidden_dim / 2; the reference's padding masks are always all-valid at fixed
1280x384 resolution, so the cumsum over the mask reduces to row/column
indices.  Learned = PositionEmbeddingLearned (:62-99): 50-entry row/col
embedding tables linearly interpolated at coords scaled into [0, 49],
concatenated [x_emb, y_emb] (the JAX package's ``LearnedPositionEmbedding``,
models/position_encoding.py:43-70).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from monosowa_tpu_torch.models.layers import Embed


def sine_position_encoding(h: int, w: int, num_pos_feats: int = 128,
                           temperature: float = 10000.0) -> np.ndarray:
    """(H, W, 2*num_pos_feats) sine/cosine embedding, precomputed on host.

    y_embed/x_embed run 1..H, 1..W then are normalized by (max + eps) * 2pi —
    identical to the reference with an all-valid mask."""
    eps = 1e-6
    scale = 2 * np.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2)


class LearnedPositionEmbedding(nn.Module):
    """PositionEmbeddingLearned: 50-entry row/col tables, linear
    interpolation at coord * 49 / extent, channel order [x_emb, y_emb]
    (the reference keeps this swapped vs sine).  ``forward(h, w)`` returns
    (H, W, 2 * num_pos_feats) float32 on the tables' device."""

    def __init__(self, gen: torch.Generator, num_pos_feats: int = 128,
                 table_size: int = 50):
        super().__init__()
        self.num_pos_feats, self.table_size = num_pos_feats, table_size
        self.row_embed = Embed(table_size, num_pos_feats, gen)
        self.col_embed = Embed(table_size, num_pos_feats, gen)

    def _interp(self, n: int, emb: Embed) -> torch.Tensor:
        dev = emb.embedding.device
        coord = torch.arange(n, dtype=torch.float32, device=dev) / n \
            * (self.table_size - 1)
        f = torch.floor(coord)
        delta = (coord - f)[:, None]
        fi = f.long()
        ci = (fi + 1).clamp(0, self.table_size - 1)
        return emb(fi) * (1 - delta) + emb(ci) * delta

    def forward(self, h: int, w: int) -> torch.Tensor:
        x_emb = self._interp(w, self.col_embed)             # (w, N)
        y_emb = self._interp(h, self.row_embed)             # (h, N)
        n = self.num_pos_feats
        return torch.cat([x_emb[None].expand(h, w, n),
                          y_emb[:, None].expand(h, w, n)], -1)
