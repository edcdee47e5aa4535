"""Segment Anything (SAM): the box-prompted mask refinement of the model zoo.

Counterpart of the JAX package's ``models/sam.py`` (Hugging Face
``SamModel`` layout): the reference optionally refines each detector car
mask with a box-prompted SAM ViT-H pass (filtering.py:112-148
``run_SAM_batch``, loader.py:97-103).  Three parts:

* the image encoder: a ViT with windowed and global attention, the
  decomposed relative-position bias built from the unscaled q (the logits
  take q / sqrt(d)), windows zero-padded after ``norm1`` (64 -> 70 at
  window 14; the padded tokens attend unmasked and are cropped off), the
  qkv projection's output laid out (tokens, 3, heads, d), exact GELU, and
  the neck's two convolutions with channel LayerNorms (eps 1e-6);
* the prompt encoder: box corners ``(box + 0.5) / image_size`` through the
  Fourier table plus ``point_embed[2]`` / ``[3]``, the image PE in (x, y)
  order, ``no_mask_embed`` as the dense embedding;
* the two-way mask decoder: tokens [iou, mask tokens, box corners]; the
  first block's self-attention replaces the queries (no residual, no PE);
  cross-attention widths come from the weights (``attention_downsample_
  rate`` 2 halves them); ReLU MLPs; the stride-2 transposed convolutions,
  the hypernetwork heads and the IoU head; ``multimask_output=False``
  keeps mask token 0.

Everything is plain torch (the JAX package computes SAM with XLA einsums,
no Pallas kernel): float32 matrix products (TF32 off, ``device.py``) and a
softmax in float32 or wider.  Submodules are named after the JAX param
tree (``vision.layer_3.attn.qkv``, ``decoder.block_0.self_attn.q_proj``,
``decoder.hyper_mlps.2.layers.0``), so ``convert.load_zoo_params`` fills
them by path.  Public functions take NHWC images.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.models import zoo_layers as zl


@dataclasses.dataclass(frozen=True)
class SamVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    global_attn_indexes: Sequence[int] = (2, 5, 8, 11)
    output_channels: int = 256
    mlp_dim: int = 3072
    layer_norm_eps: float = 1e-6
    use_abs_pos: bool = True
    use_rel_pos: bool = True

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class SamDecoderConfig:
    hidden_size: int = 256
    num_attention_heads: int = 8
    num_hidden_layers: int = 2
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SamConfig:
    vision: SamVisionConfig = SamVisionConfig()
    decoder: SamDecoderConfig = SamDecoderConfig()
    prompt_image_size: int = 1024      # prompt_encoder_config.image_size
    # prompt_encoder_config.image_embedding_size
    embedding_size: int = 64


def vit_h() -> SamConfig:
    """SAM ViT-H (``facebook/sam-vit-huge``): hidden 1280, 32 layers, 16
    heads, global attention at layers 7, 15, 23 and 31, window 14, MLP
    5120, image 1024, patch 16, 256 output channels, the default
    decoder."""
    return SamConfig(vision=SamVisionConfig(
        hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
        global_attn_indexes=(7, 15, 23, 31), mlp_dim=5120))


# ---------------------------------------------------------------- vision


@functools.lru_cache(maxsize=64)
def _rel_index(size: int) -> np.ndarray:
    """(size, size) row of the (2 size - 1)-row table for each (query,
    key) coordinate pair."""
    return (np.arange(size)[:, None] - np.arange(size)[None, :]) + (size - 1)


def _interp_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """The table resized to 2 size - 1 rows with torch's linear rule
    (get_rel_pos's ``F.interpolate(mode='linear')``), as it is where it
    has that many already."""
    max_rel = 2 * size - 1
    if rel_pos.shape[0] == max_rel:
        return rel_pos
    return F.interpolate(rel_pos.t()[None], size=max_rel,
                         mode="linear")[0].t()


def _rel_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
              h: int, w: int) -> torch.Tensor:
    """Decomposed relative-position bias (get_decomposed_rel_pos, query
    size = key size) from the UNSCALED q (B, h*w, heads, d) -> (B, heads,
    h*w, h*w)."""
    b, _, heads, d = q.shape
    rh = _interp_rel_pos(rel_h, h)[zl.constant(_rel_index, (h,), q.device)]
    rw = _interp_rel_pos(rel_w, w)[zl.constant(_rel_index, (w,), q.device)]
    qg = q.reshape(b, h, w, heads, d)
    bh = torch.einsum("bhwnc,hkc->bnhwk", qg, rh)
    bw = torch.einsum("bhwnc,wkc->bnhwk", qg, rw)
    return (bh[..., :, None] + bw[..., None, :]).reshape(b, heads, h * w,
                                                        h * w)


class VisionAttention(nn.Module):
    def __init__(self, cfg: SamVisionConfig, size: int, gen: torch.Generator):
        """``size``: the side of the grid it attends over (the window, or
        the whole grid for a global layer): its tables' 2 size - 1 rows."""
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.use_rel_pos = cfg.use_rel_pos
        self.qkv = zl.linear(c, 3 * c, gen)
        self.proj = zl.linear(c, c, gen)
        if cfg.use_rel_pos:
            d = c // self.heads
            self.rel_pos_h = zl.param((2 * size - 1, d), gen)
            self.rel_pos_w = zl.param((2 * size - 1, d), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B', h, w, C), windows or the whole grid."""
        b, h, w, c = x.shape
        heads = self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, c // heads)
        q, k, v = qkv.unbind(2)
        bias = (_rel_bias(q, self.rel_pos_h, self.rel_pos_w, h, w)
                if self.use_rel_pos else None)
        return self.proj(zl.attention(q, k, v, bias=bias).reshape(b, h, w,
                                                                  c))


def _window_partition(x: torch.Tensor, ws: int):
    """(B, h, w, C) -> (B * windows, ws, ws, C), zero-padded at the bottom
    and right to whole windows; and the padded (h, w)."""
    b, h, w, c = x.shape
    ph, pw = -h % ws, -w % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hh, ww = h + ph, w + pw
    x = x.reshape(b, hh // ws, ws, ww // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hh, ww)


def _window_unpartition(wins: torch.Tensor, ws: int, padded, orig):
    hh, ww = padded
    h, w = orig
    b = wins.shape[0] // (hh * ww // ws // ws)
    x = wins.reshape(b, hh // ws, ww // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, -1)
    return x[:, :h, :w]


class MLPBlock(nn.Module):
    def __init__(self, c: int, hidden: int, gen: torch.Generator,
                 act: str = "gelu"):
        super().__init__()
        self.act = act
        self.lin1 = zl.linear(c, hidden, gen)
        self.lin2 = zl.linear(hidden, c, gen)

    def forward(self, x):
        y = self.lin1(x)
        # the vision MLP's GELU is the exact one; SamMaskDecoderConfig's
        # hidden_act defaults to relu
        y = F.relu(y) if self.act == "relu" else F.gelu(y)
        return self.lin2(y)


class VisionLayer(nn.Module):
    def __init__(self, cfg: SamVisionConfig, window: int,
                 gen: torch.Generator):
        super().__init__()
        c, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.window = window
        self.norm1 = nn.LayerNorm(c, eps=eps)
        self.attn = VisionAttention(cfg, window or cfg.grid, gen)
        self.norm2 = nn.LayerNorm(c, eps=eps)
        self.mlp = MLPBlock(c, cfg.mlp_dim, gen)

    def forward(self, x):
        y = self.norm1(x)
        if self.window:
            h, w = y.shape[1], y.shape[2]
            y, padded = _window_partition(y, self.window)
            y = _window_unpartition(self.attn(y), self.window, padded, (h, w))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class Neck(nn.Module):
    def __init__(self, cfg: SamVisionConfig, gen: torch.Generator):
        super().__init__()
        c, out = cfg.hidden_size, cfg.output_channels
        self.conv1 = zl.conv(c, out, 1, gen, bias=False)
        self.layer_norm1 = nn.LayerNorm(out, eps=1e-6)
        self.conv2 = zl.conv(out, out, 3, gen, padding=1, bias=False)
        self.layer_norm2 = nn.LayerNorm(out, eps=1e-6)

    def forward(self, x):
        x = self.layer_norm1(zl.conv_nhwc(self.conv1, x))
        return self.layer_norm2(zl.conv_nhwc(self.conv2, x))


class SamVision(nn.Module):
    def __init__(self, cfg: SamVisionConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.patch_proj = zl.conv(3, c, cfg.patch_size, gen,
                                  stride=cfg.patch_size)
        if cfg.use_abs_pos:
            self.pos_embed = zl.param((1, cfg.grid, cfg.grid, c), gen)
        for i in range(cfg.num_hidden_layers):
            window = 0 if i in tuple(cfg.global_attn_indexes) \
                else cfg.window_size
            self.add_module(f"layer_{i}", VisionLayer(cfg, window, gen))
        self.neck = Neck(cfg, gen)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = zl.conv_nhwc(self.patch_proj, pixels)
        if self.cfg.use_abs_pos:
            x = x + self.pos_embed
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.neck(x)


# ---------------------------------------------------------------- prompts


def _fourier_embed(coords01: torch.Tensor, table: torch.Tensor
                   ) -> torch.Tensor:
    """SamPositionalEmbedding: coords in [0, 1]^2 (..., 2) -> (..., 2F)."""
    c = (2.0 * coords01 - 1.0) @ table * (2.0 * np.pi)
    return torch.cat([torch.sin(c), torch.cos(c)], -1)


class SamPrompt(nn.Module):
    """The prompt encoder's tables (raw parameters of the JAX tree)."""

    def __init__(self, cfg: SamConfig, gen: torch.Generator):
        super().__init__()
        c = cfg.decoder.hidden_size
        self.shared_embedding = zl.param((2, c // 2), gen)
        self.point_embed = zl.param((4, c), gen)
        self.no_mask_embed = zl.param((c,), gen)


# ---------------------------------------------------------------- decoder


class DecoderAttention(nn.Module):
    """SamAttention over (B, P, N, C) token stacks; its inner width is
    ``hidden / downsample`` (read from the weights at each call)."""

    def __init__(self, c: int, heads: int, downsample: int,
                 gen: torch.Generator):
        super().__init__()
        inner = c // downsample
        self.heads = heads
        self.q_proj = zl.linear(c, inner, gen)
        self.k_proj = zl.linear(c, inner, gen)
        self.v_proj = zl.linear(c, inner, gen)
        self.out_proj = zl.linear(inner, c, gen)

    def forward(self, q, k, v):
        b, pb, nq, _ = q.shape
        nk = k.shape[2]
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        heads = self.heads
        d = qp.shape[-1] // heads
        qp = qp.reshape(b, pb, nq, heads, d)
        kp = kp.reshape(b, pb, nk, heads, d)
        vp = vp.reshape(b, pb, nk, heads, d)
        logits = torch.einsum("bpqhd,bpkhd->bphqk", qp, kp) / math.sqrt(d)
        probs = torch.softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), -1).to(q.dtype)
        y = torch.einsum("bphqk,bpkhd->bpqhd", probs, vp).reshape(b, pb, nq,
                                                                  -1)
        return self.out_proj(y)


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, gen: torch.Generator):
        super().__init__()
        c, heads, ds = (cfg.hidden_size, cfg.num_attention_heads,
                        cfg.attention_downsample_rate)
        self.self_attn = DecoderAttention(c, heads, 1, gen)
        self.cross_attn_token_to_image = DecoderAttention(c, heads, ds, gen)
        self.cross_attn_image_to_token = DecoderAttention(c, heads, ds, gen)
        for j in range(1, 5):
            self.add_module(f"layer_norm{j}",
                            nn.LayerNorm(c, eps=cfg.layer_norm_eps))
        self.mlp = MLPBlock(c, cfg.mlp_dim, gen, act="relu")

    def forward(self, queries, keys, qpe, kpe, skip_first: bool):
        if skip_first:
            # the first block's self-attention REPLACES the queries (no
            # residual, no PE added)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + qpe, keys + kpe
        queries = self.layer_norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))
        q, k = queries + qpe, keys + kpe
        keys = self.layer_norm4(
            keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class FeedForward(nn.Module):
    """SamFeedForward: ReLU after every layer but the last."""

    def __init__(self, n_in: int, hidden: int, n_out: int, depth: int,
                 gen: torch.Generator):
        super().__init__()
        self.proj_in = zl.linear(n_in, hidden, gen)
        self.layers = nn.ModuleList(zl.linear(hidden, hidden, gen)
                                    for _ in range(depth - 2))
        self.proj_out = zl.linear(hidden, n_out, gen)

    def forward(self, x):
        y = F.relu(self.proj_in(x))
        for layer in self.layers:
            y = F.relu(layer(y))
        return self.proj_out(y)


class SamMaskDecoder(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        n_mask = cfg.num_multimask_outputs + 1
        self.iou_token = zl.param((1, c), gen)
        self.mask_tokens = zl.param((n_mask, c), gen)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"block_{i}", TwoWayBlock(cfg, gen))
        self.final_attn = DecoderAttention(c, cfg.num_attention_heads,
                                           cfg.attention_downsample_rate, gen)
        self.final_norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.upscale_conv1 = zl.conv_transpose(c, c // 4, 2, gen)
        self.upscale_layer_norm = nn.LayerNorm(c // 4, eps=1e-6)
        self.upscale_conv2 = zl.conv_transpose(c // 4, c // 8, 2, gen)
        self.hyper_mlps = nn.ModuleList(
            FeedForward(c, c, c // 8, 3, gen) for _ in range(n_mask))
        self.iou_head = FeedForward(c, cfg.iou_head_hidden_dim, n_mask,
                                    cfg.iou_head_depth, gen)

    def forward(self, image_embeddings, image_pe, sparse, dense,
                multimask_output: bool = False):
        cfg = self.cfg
        b, g, _, c = image_embeddings.shape
        pb = sparse.shape[1]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], 0)
        n_mask = self.mask_tokens.shape[0]
        tokens = torch.cat([out_tokens.expand(b, pb, -1, -1), sparse], 2)
        img = (image_embeddings + dense)[:, None].expand(
            b, pb, g, g, c).reshape(b, pb, g * g, c)
        kpe = image_pe[:, None].expand(b, pb, g, g, c).reshape(b, pb, g * g,
                                                               c)
        queries, keys = tokens, img
        for i in range(cfg.num_hidden_layers):
            queries, keys = getattr(self, f"block_{i}")(
                queries, keys, tokens, kpe, skip_first=(i == 0))
        q, k = queries + tokens, keys + kpe
        queries = self.final_norm(queries + self.final_attn(q, k, keys))
        iou_out = queries[:, :, 0]
        mask_out = queries[:, :, 1:1 + n_mask]

        up = keys.reshape(b * pb, g, g, c)
        up = zl.conv_nhwc(self.upscale_conv1, up)
        up = F.gelu(self.upscale_layer_norm(up))
        up = F.gelu(zl.conv_nhwc(self.upscale_conv2, up))
        gh, gw, cu = up.shape[1], up.shape[2], up.shape[3]
        up = up.reshape(b, pb, gh * gw, cu)
        hyper = torch.stack([mlp(mask_out[:, :, i])
                             for i, mlp in enumerate(self.hyper_mlps)], 2)
        masks = torch.einsum("bpmc,bpnc->bpmn", hyper, up).reshape(
            b, pb, n_mask, gh, gw)
        iou_pred = self.iou_head(iou_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou_pred[:, :, sl]


class Sam(nn.Module):
    """The whole network; methods named after the JAX functions."""

    def __init__(self, cfg: SamConfig,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """Weights are drawn on the host from a ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default ``cuda``)."""
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.vision = SamVision(cfg.vision, gen)
        self.prompt = SamPrompt(cfg, gen)
        self.decoder = SamMaskDecoder(cfg.decoder, gen)
        self.to(dev)
        self.eval()

    def vision_forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``sam_vision_forward``: pixels (B, S, S, 3) normalised NHWC ->
        image embeddings (B, grid, grid, output_channels)."""
        return self.vision(pixels)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """``sam_embed_boxes``: boxes (B, nb, 4) xyxy in input pixels ->
        (B, nb, 2, C) (SamPromptEncoder._embed_boxes)."""
        table = self.prompt.shared_embedding
        s = self.cfg.prompt_image_size
        coords = (boxes.to(table.dtype) + 0.5).reshape(
            *boxes.shape[:2], 2, 2) / s
        pe = self.prompt.point_embed
        return _fourier_embed(coords, table) + torch.stack([pe[2], pe[3]])

    def image_pe(self) -> torch.Tensor:
        """``sam_image_pe`` (get_image_wide_positional_embeddings) ->
        (1, g, g, C), the grid's (x, y) through the Fourier table."""
        table = self.prompt.shared_embedding
        g = self.cfg.embedding_size
        r = (torch.arange(g, dtype=table.dtype, device=table.device)
             + 0.5) / g
        yx = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
        return _fourier_embed(yx.flip(-1), table)[None]

    def mask_decoder(self, image_embeddings: torch.Tensor,
                     image_pe: torch.Tensor, sparse: torch.Tensor,
                     dense: torch.Tensor, multimask_output: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sam_mask_decoder``: image_embeddings (B, g, g, C); image_pe
        (1, g, g, C); sparse (B, P, n, C); dense (B, g, g, C) -> (masks
        (B, P, M, 4g, 4g), iou (B, P, M))."""
        return self.decoder(image_embeddings, image_pe, sparse, dense,
                            multimask_output)

    def decode_boxes(self, image_embeddings: torch.Tensor,
                     boxes: torch.Tensor, multimask_output: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prompt encoder and the mask decoder on image embeddings
        already computed: ``sam_predict_boxes`` after its encoder, with
        ``no_mask_embed`` as the dense embedding."""
        dense = self.prompt.no_mask_embed.expand_as(image_embeddings)
        return self.mask_decoder(image_embeddings, self.image_pe(),
                                 self.embed_boxes(boxes), dense,
                                 multimask_output)

    def predict_boxes(self, pixels: torch.Tensor, boxes: torch.Tensor,
                      multimask_output: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sam_predict_boxes`` (SamModel.forward with input_boxes):
        pixels (B, S, S, 3) normalised; boxes (B, nb, 4) in input pixels
        -> (low-res masks (B, nb, M, 4g, 4g), iou (B, nb, M))."""
        return self.decode_boxes(self.vision_forward(pixels), boxes,
                                 multimask_output)
