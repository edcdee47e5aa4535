"""Mask2Former instance segmentation on a Swin trunk (the model zoo's mask
network).

Counterpart of the JAX package's ``models/mask2former.py`` (Hugging Face
``Mask2FormerForUniversalSegmentation`` layout), in float32 as the JAX
zoo serves a float32 checkpoint:

* the Swin trunk (``models/swin.py``);
* the pixel decoder: input projections with GroupNorm(32), six
  deformable-attention encoder layers over the three coarsest levels, whose
  multi-scale deformable attention is the port's ``ops.msda.
  ms_deform_attn`` (the hand-written K1 kernel for CUDA tensors, the plain
  version for CPU tensors), and the FPN tail to the 1/4 mask features;
* the masked-attention decoder: one class / mask prediction from the
  learned queries, then nine layers of masked cross-attention, self-
  attention and FFN (post-norm), each followed by a prediction whose
  binarised attention mask (``sigmoid < 0.5`` of the mask logits resized to
  the next level, a fully masked row unmasked) feeds the next layer.

Sine position embeddings and reference points are numpy constants of the
shapes.  Submodules are named after the JAX param tree, so
``convert.load_zoo_params`` fills them by path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.models import zoo_layers as zl
from monosowa_tpu_torch.models.swin import SwinBackbone, SwinConfig
from monosowa_tpu_torch.ops.msda import ms_deform_attn
from monosowa_tpu_torch.ops.resize import resize_bilinear_torch


@dataclasses.dataclass(frozen=True)
class Mask2FormerConfig:
    backbone: SwinConfig
    feature_size: int = 256
    mask_feature_size: int = 256
    hidden_dim: int = 256
    encoder_layers: int = 6
    decoder_layers: int = 10          # 1 + 9 masked layers (torch counts +1)
    num_attention_heads: int = 8
    encoder_feedforward_dim: int = 1024
    dim_feedforward: int = 2048
    num_queries: int = 100
    num_labels: int = 80
    pre_norm: bool = False
    common_stride: int = 4
    feature_strides: Sequence[int] = (4, 8, 16, 32)
    deform_points: int = 4
    num_feature_levels: int = 3

    def n_fpn(self) -> int:
        """Backbone levels the FPN tail fuses in below the encoder's."""
        nl = self.num_feature_levels
        return int(np.log2(min(self.feature_strides[-nl:]))
                   - np.log2(self.common_stride))


@functools.lru_cache(maxsize=64)
def _sine_pos(h: int, w: int, num_feats: int) -> np.ndarray:
    """Mask2FormerSinePositionEmbedding(normalize=True) -> (h, w, 2F) with
    channel order [y-features, x-features]."""
    scale = 2.0 * np.pi
    eps = 1e-6
    y = (np.arange(1, h + 1, dtype=np.float32)[:, None]
         * np.ones((1, w), np.float32))
    x = (np.ones((h, 1), np.float32)
         * np.arange(1, w + 1, dtype=np.float32)[None])
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = 10000.0 ** (2 * (np.arange(num_feats) // 2) / num_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])],
                  -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])],
                  -1).reshape(h, w, -1)
    return np.concatenate([py, px], -1).astype(np.float32)


def _level_norm(shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """(L, 2) float32 (W, H) of each level: sampling offsets in pixels over
    it give offsets in [0, 1] units."""
    return np.asarray([[w, h] for h, w in shapes], np.float32)


def _reference_points(shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """(sum(HW), L, 2) normalised (x, y) grid centres, valid_ratios == 1."""
    pts = []
    for h, w in shapes:
        ry = (np.arange(h, dtype=np.float32) + 0.5) / h
        rx = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ry, rx, indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2))
    ref = np.concatenate(pts, 0)
    return np.broadcast_to(ref[:, None], (ref.shape[0], len(shapes), 2)
                           ).astype(np.float32)


class PixelDecoderEncoderLayer(nn.Module):
    """Mask2FormerPixelDecoderEncoderLayer (eval: no dropout)."""

    def __init__(self, cfg: Mask2FormerConfig, gen: torch.Generator):
        super().__init__()
        c, m = cfg.feature_size, cfg.num_attention_heads
        l, p = cfg.num_feature_levels, cfg.deform_points
        self.heads, self.levels, self.points = m, l, p
        self.sampling_offsets = zl.linear(c, m * l * p * 2, gen)
        self.attention_weights = zl.linear(c, m * l * p, gen)
        self.value_proj = zl.linear(c, c, gen)
        self.output_proj = zl.linear(c, c, gen)
        self.self_attn_layer_norm = nn.LayerNorm(c, eps=1e-5)
        self.fc1 = zl.linear(c, cfg.encoder_feedforward_dim, gen)
        self.fc2 = zl.linear(cfg.encoder_feedforward_dim, c, gen)
        self.final_layer_norm = nn.LayerNorm(c, eps=1e-5)
        # MSDA: the kernel for CUDA tensors (the smoke swaps in the plain
        # version by name to compare the two)
        self.msda = ms_deform_attn

    def forward(self, hidden, pos, ref, shapes):
        b, n, c = hidden.shape
        m, l, p = self.heads, self.levels, self.points
        q = hidden + pos
        offsets = self.sampling_offsets(q).reshape(b, n, m, l, p, 2)
        weights = torch.softmax(self.attention_weights(q).reshape(
            b, n, m, l * p).float(), -1).reshape(b, n, m, l, p)
        value = self.value_proj(hidden).reshape(b, n, m, c // m)
        norm = zl.constant(_level_norm, (shapes,), hidden.device)
        loc = ref[None, :, None, :, None, :] \
            + offsets / norm[None, None, None, :, None, :]
        out = self.output_proj(self.msda(value, shapes, loc, weights))
        hidden = self.self_attn_layer_norm(hidden + out)
        y = self.fc2(torch.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class PixelDecoder(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        nl, fd = cfg.num_feature_levels, cfg.feature_size
        bb = cfg.backbone
        dims = [bb.stage_dim(i - 1) for i in bb.out_indices]
        self.level_embed = zl.param((nl, fd), gen)
        # levels high stride first: the last nl backbone maps, reversed
        self.input_projections = nn.ModuleList(
            [zl.conv(c, fd, 1, gen) for c in dims[::-1][:nl]])
        self.input_projections_gn = nn.ModuleList(
            [nn.GroupNorm(32, fd, eps=1e-5) for _ in range(nl)])
        self.encoder_layers = nn.ModuleList(
            [PixelDecoderEncoderLayer(cfg, gen)
             for _ in range(cfg.encoder_layers)])
        self.mask_projection = zl.conv(fd, cfg.mask_feature_size, 1, gen)
        fpn_dims = dims[:cfg.n_fpn()][::-1]
        self.lateral_convs = nn.ModuleList(
            [zl.conv(c, fd, 1, gen, bias=False) for c in fpn_dims])
        self.lateral_convs_gn = nn.ModuleList(
            [nn.GroupNorm(32, fd, eps=1e-5) for _ in fpn_dims])
        self.output_convs = nn.ModuleList(
            [zl.conv(fd, fd, 3, gen, padding=1, bias=False)
             for _ in fpn_dims])
        self.output_convs_gn = nn.ModuleList(
            [nn.GroupNorm(32, fd, eps=1e-5) for _ in fpn_dims])

    def forward(self, features: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """features: NHWC backbone maps, low stride first.  Returns
        (mask_features (B, H/4, W/4, mask_dim), multi_scale [1/32, 1/16,
        1/8])."""
        cfg = self.cfg
        nl, fd = cfg.num_feature_levels, cfg.feature_size
        dev = features[0].device
        levels = features[::-1][:nl]
        embeds = [zl.group_norm_nhwc(gn, zl.conv_nhwc(proj, f))
                  for f, proj, gn in zip(levels, self.input_projections,
                                         self.input_projections_gn)]
        shapes = tuple((e.shape[1], e.shape[2]) for e in embeds)
        b = embeds[0].shape[0]
        hidden = torch.cat([e.reshape(b, -1, fd) for e in embeds], 1)
        pos = torch.cat(
            [(zl.constant(_sine_pos, (h, w, fd // 2), dev)
              + self.level_embed[i]).reshape(1, -1, fd)
             for i, (h, w) in enumerate(shapes)], 1)
        ref = zl.constant(_reference_points, (shapes,), dev)
        for layer in self.encoder_layers:
            hidden = layer(hidden, pos, ref, shapes)

        outs, start = [], 0
        for (h, w) in shapes:
            outs.append(hidden[:, start:start + h * w].reshape(b, h, w, fd))
            start += h * w
        # FPN tail: the lowest-stride backbone maps fused in
        for i, f in enumerate(features[:cfg.n_fpn()][::-1]):
            lat = zl.group_norm_nhwc(self.lateral_convs_gn[i],
                                     zl.conv_nhwc(self.lateral_convs[i], f))
            y = lat + resize_bilinear_torch(outs[-1], lat.shape[1:3])
            y = torch.relu(zl.group_norm_nhwc(
                self.output_convs_gn[i], zl.conv_nhwc(self.output_convs[i],
                                                      y)))
            outs.append(y)
        return zl.conv_nhwc(self.mask_projection, outs[-1]), outs[:nl]


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` semantics, batch first, q / k / v /
    out projections as separate layers (the JAX tree's)."""

    def __init__(self, dim: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.heads = heads
        self.q = zl.linear(dim, dim, gen)
        self.k = zl.linear(dim, dim, gen)
        self.v = zl.linear(dim, dim, gen)
        self.out = zl.linear(dim, dim, gen)

    def forward(self, q, k, v, mask=None):
        """mask: (B*heads, Q, S) bool, True = disallowed."""
        b, nq, c = q.shape
        h = self.heads
        qp = self.q(q).reshape(b, nq, h, c // h)
        kp = self.k(k).reshape(b, -1, h, c // h)
        vp = self.v(v).reshape(b, -1, h, c // h)
        if mask is not None:
            mask = mask.reshape(b, h, nq, -1)
        return self.out(zl.attention(qp, kp, vp, mask=mask))


class DecoderLayer(nn.Module):
    """One masked-attention decoder layer (post-norm order)."""

    def __init__(self, cfg: Mask2FormerConfig, gen: torch.Generator):
        super().__init__()
        hd, heads = cfg.hidden_dim, cfg.num_attention_heads
        self.cross_attn = MultiheadAttention(hd, heads, gen)
        self.cross_attn_layer_norm = nn.LayerNorm(hd, eps=1e-5)
        self.self_attn = MultiheadAttention(hd, heads, gen)
        self.self_attn_layer_norm = nn.LayerNorm(hd, eps=1e-5)
        self.fc1 = zl.linear(hd, cfg.dim_feedforward, gen)
        self.fc2 = zl.linear(cfg.dim_feedforward, hd, gen)
        self.final_layer_norm = nn.LayerNorm(hd, eps=1e-5)

    def forward(self, hidden, qpe, enc, pos, att):
        """att: (B*heads, Q, S) bool attention mask of the previous
        prediction; a fully masked row is unmasked (else the softmax gives
        NaN), as in torch."""
        att = att & ~att.all(-1, keepdim=True)
        y = self.cross_attn(hidden + qpe, enc + pos, enc, mask=att)
        hidden = self.cross_attn_layer_norm(hidden + y)
        q = hidden + qpe
        y = self.self_attn(q, q, hidden)
        hidden = self.self_attn_layer_norm(hidden + y)
        y = self.fc2(torch.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class MaskPredictor(nn.Module):
    def __init__(self, hd: int, mask_dim: int, gen: torch.Generator):
        super().__init__()
        self.mask_embedder = nn.ModuleList(
            [zl.linear(hd, hd, gen), zl.linear(hd, hd, gen),
             zl.linear(hd, mask_dim, gen)])

    def forward(self, hidden, pixel_emb, target_hw, heads: int):
        """-> (mask logits (B, Q, H4, W4), attention mask (B*heads, Q,
        th*tw): True where sigmoid of the logits resized to target_hw is
        under 0.5)."""
        emb = hidden
        for i, layer in enumerate(self.mask_embedder):
            emb = layer(emb)
            if i < len(self.mask_embedder) - 1:
                emb = torch.relu(emb)
        masks = torch.einsum("bqc,bhwc->bqhw", emb, pixel_emb)
        att = resize_bilinear_torch(masks.permute(0, 2, 3, 1), target_hw)
        att = torch.sigmoid(att.permute(0, 3, 1, 2).flatten(2)) < 0.5
        b, q, s = att.shape
        return masks, att[:, None].expand(b, heads, q, s).reshape(-1, q, s)


class TransformerModule(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_dim
        self.level_embed = zl.param((cfg.num_feature_levels, hd), gen)
        self.queries_embedder = zl.param((cfg.num_queries, hd), gen)
        self.queries_features = zl.param((cfg.num_queries, hd), gen)
        self.decoder_layers = nn.ModuleList(
            [DecoderLayer(cfg, gen) for _ in range(cfg.decoder_layers - 1)])
        self.decoder_norm = nn.LayerNorm(hd, eps=1e-5)
        self.mask_predictor = MaskPredictor(hd, cfg.mask_feature_size, gen)
        self.class_predictor = zl.linear(hd, cfg.num_labels + 1, gen)

    def predict(self, hidden, mask_features, target_hw):
        """-> (class logits, mask logits, attention mask) of the decoder
        state ``hidden``."""
        inter = self.decoder_norm(hidden)
        masks, att = self.mask_predictor(inter, mask_features, target_hw,
                                         self.cfg.num_attention_heads)
        return self.class_predictor(inter), masks, att

    def forward(self, multi_scale: List[torch.Tensor],
                mask_features: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """-> (per-layer class logits, per-layer mask logits); the last
        entries are the final predictions."""
        cfg = self.cfg
        b = mask_features.shape[0]
        hd, nl = cfg.hidden_dim, cfg.num_feature_levels
        dev = mask_features.device
        size_list = [(f.shape[1], f.shape[2]) for f in multi_scale]
        pos = [zl.constant(_sine_pos, (h, w, hd // 2), dev).reshape(1, -1, hd)
               for h, w in size_list]
        enc = [f.reshape(b, -1, hd) + self.level_embed[i]
               for i, f in enumerate(multi_scale)]
        qpe = self.queries_embedder[None].expand(b, -1, -1)
        hidden = self.queries_features[None].expand(b, -1, -1)
        cls, masks, att = self.predict(hidden, mask_features, size_list[0])
        classes, masks_out = [cls], [masks]
        for idx, layer in enumerate(self.decoder_layers):
            li = idx % nl
            hidden = layer(hidden, qpe, enc[li], pos[li], att)
            cls, masks, att = self.predict(hidden, mask_features,
                                           size_list[(idx + 1) % nl])
            classes.append(cls)
            masks_out.append(masks)
        return classes, masks_out


class Mask2Former(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """Weights are drawn on the host from a ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default ``cuda``)."""
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.backbone = SwinBackbone(cfg.backbone, gen)
        self.pixel_decoder = PixelDecoder(cfg, gen)
        self.transformer = TransformerModule(cfg, gen)
        self.to(dev)
        self.eval()

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels (B, H, W, 3) normalised NHWC -> (class logits (B, Q,
        num_labels + 1), mask logits (B, Q, H/4, W/4))."""
        feats = self.backbone(pixels)
        mask_features, multi_scale = self.pixel_decoder(feats)
        classes, masks = self.transformer(multi_scale, mask_features)
        return classes[-1], masks[-1]
