"""EfficientLoFTR, the detector-free matcher of the Waymo stitching path.

Counterpart of the JAX package's ``models/efficientloftr.py`` (the
CVPR'24 successor of the kornia LoFTR that the reference's stitching
loads, stitching.py:29-151), as an ``nn.Module`` whose submodules carry the
names of the JAX param tree, so ``convert.load_zoo_params`` fills it from a
``loftr`` zoo checkpoint and ``zoo_params`` writes one:

* ``backbone.<stage>.<block>``: one biased 3 x 3 convolution a RepVGG block
  (the three branches and their BatchNorms folded at import,
  ``import_hf_efficientloftr``);
* ``transformer.<layer>.{self,cross}_attention``: the aggregated attention
  (a depthwise 4 x 4 stride-4 query convolution, a 4 x 4 max-pool of the
  keys and values, a shared LayerNorm, projections ``attn.{q,k,v,o}_proj``
  and the MLP ``mlp.fc1`` / ``fc2`` as raw (in, out) matrices, 2D RoPE in
  self-attention, the output upsampled by ``F.interpolate``'s bilinear);
* ``fine_fusion``: the 1 x 1 ``out_conv`` and the out-conv blocks (raw HWIO
  kernels ``out_conv1`` / ``out_conv3``, a biased ``out_conv2`` with its
  BatchNorm folded); a 1 x 1 kernel is one product over the channels.

The matching follows the JAX module, whose fine stage departs from stock
transformers 4.57.6 on purpose (its docstring): the first-stage delta is
gathered over the window axis and its dual-softmax runs over the two
windows.  Images and features are NHWC at every function that the JAX
module has, so the tests compare like with like.

Random weights (no checkpoint can be fetched) are drawn on the host from an
explicit ``torch.Generator``: He-normal convolution kernels (std
sqrt(2 / fan in), so 21 ReLU blocks keep their scale), normal projections
of std 1 / sqrt(fan in), zero biases, unit norm scales.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from monosowa_tpu_torch.models.zoo_layers import (_normal_, constant, hf_array,
                                                  hf_norm)
from monosowa_tpu_torch.ops.resize import resize_bilinear_torch


@dataclasses.dataclass(frozen=True)
class EfficientLoFTRConfig:
    stage_num_blocks: Sequence[int] = (1, 2, 4, 14)
    out_features: Sequence[int] = (64, 64, 128, 256)
    stage_stride: Sequence[int] = (2, 1, 2, 2)
    hidden_size: int = 256
    q_aggregation_kernel_size: int = 4
    q_aggregation_stride: int = 4
    kv_aggregation_kernel_size: int = 4
    kv_aggregation_stride: int = 4
    num_attention_layers: int = 4
    num_attention_heads: int = 8
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 4.0
    coarse_matching_threshold: float = 0.2
    coarse_matching_temperature: float = 0.1
    coarse_matching_border_removal: int = 2
    coarse_matching_skip_softmax: bool = False
    fine_kernel_size: int = 8
    fine_matching_slice_dim: int = 8
    fine_matching_regress_temperature: float = 10.0

    @property
    def intermediate_size(self) -> int:
        return self.hidden_size * 2

    @property
    def fine_fusion_dims(self) -> Tuple[int, ...]:
        return tuple(reversed(self.out_features))[:-1]


def config_from_hf_efficientloftr(hf_cfg: Any) -> EfficientLoFTRConfig:
    return EfficientLoFTRConfig(
        stage_num_blocks=tuple(hf_cfg.stage_num_blocks),
        out_features=tuple(hf_cfg.out_features),
        stage_stride=tuple(hf_cfg.stage_stride),
        hidden_size=hf_cfg.hidden_size,
        q_aggregation_kernel_size=hf_cfg.q_aggregation_kernel_size,
        q_aggregation_stride=hf_cfg.q_aggregation_stride,
        kv_aggregation_kernel_size=hf_cfg.kv_aggregation_kernel_size,
        kv_aggregation_stride=hf_cfg.kv_aggregation_stride,
        num_attention_layers=hf_cfg.num_attention_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        rope_theta=hf_cfg.rope_theta,
        partial_rotary_factor=hf_cfg.partial_rotary_factor,
        coarse_matching_threshold=hf_cfg.coarse_matching_threshold,
        coarse_matching_temperature=hf_cfg.coarse_matching_temperature,
        coarse_matching_border_removal=hf_cfg.coarse_matching_border_removal,
        coarse_matching_skip_softmax=hf_cfg.coarse_matching_skip_softmax,
        fine_kernel_size=hf_cfg.fine_kernel_size,
        fine_matching_slice_dim=hf_cfg.fine_matching_slice_dim,
        fine_matching_regress_temperature=(
            hf_cfg.fine_matching_regress_temperature),
    )


# ------------------------------------------------------------- parameters


def _he_conv(c_in, c_out, k, gen, stride=1, padding=0, groups=1,
             bias=True) -> nn.Conv2d:
    m = nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride=stride,
                           padding=padding, groups=groups, bias=bias)
    _normal_(m.weight, gen, math.sqrt(2.0 / (k * k * c_in // groups)))
    if bias:
        nn.init.zeros_(m.bias)
    return m


def _raw(shape, gen, std) -> nn.Parameter:
    return nn.Parameter(_normal_(torch.empty(shape), gen, std))


def _ln(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=1e-5)


# (c_in, c_out) of the fine fusion's raw-kernel 3 x 3 convolutions that run
# outside cuDNN: for 256 -> 128 at 120 x 160 (the 480 x 640 input; float32,
# TF32 off) cuDNN takes an FFT engine of thousands of small GEMM launches,
# whatever the layout or ``cudnn.benchmark``, and most of a forward's time;
# for 128 -> 64 at 240 x 320 cuDNN is the faster
# (``tools/profile_torch_waymo.py`` times both routes of each)
_CUDNN_BYPASS = frozenset({(256, 128)})


def _conv3x3_hwio(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A stride-1, padding-1 convolution of an NHWC tensor by a 3 x 3 HWIO
    kernel; the shapes of ``_CUDNN_BYPASS`` take PyTorch's own convolution
    (im2col and one GEMM an image), the same sums."""
    on = (kernel.shape[2], kernel.shape[3]) not in _CUDNN_BYPASS
    with torch.backends.cudnn.flags(enabled=on, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     kernel.permute(3, 2, 0, 1).contiguous(), padding=1)
    return y.permute(0, 2, 3, 1)


class _Projections(nn.Module):
    def __init__(self, c: int, gen: torch.Generator):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, _raw((c, c), gen, 1.0 / math.sqrt(c)))


class _Mlp(nn.Module):
    def __init__(self, c: int, inter: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = _raw((2 * c, inter), gen, 1.0 / math.sqrt(2 * c))
        self.fc2 = _raw((inter, c), gen, 1.0 / math.sqrt(inter))
        self.layer_norm = _ln(c)


class AggregatedAttention(nn.Module):
    """EfficientLoFTRAggregatedAttention (JAX ``_agg_attention``)."""

    def __init__(self, cfg: EfficientLoFTRConfig, gen: torch.Generator):
        super().__init__()
        c = cfg.hidden_size
        self.cfg = cfg
        self.q_aggregation = _he_conv(
            c, c, cfg.q_aggregation_kernel_size, gen,
            stride=cfg.q_aggregation_stride, groups=c, bias=False)
        self.norm = _ln(c)
        self.attn = _Projections(c, gen)
        self.mlp = _Mlp(c, cfg.intermediate_size, gen)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, rope=None
                ) -> torch.Tensor:
        """x, kv (B, h, w, C) -> (B, h, w, C); ``rope`` = (cos, sin) of the
        aggregated grid, or None for cross-attention."""
        cfg = self.cfg
        b, h, w, c = x.shape
        ks = cfg.q_aggregation_kernel_size
        q = self.q_aggregation(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ah, aw = q.shape[1], q.shape[2]
        kv_a = F.max_pool2d(kv.permute(0, 3, 1, 2),
                            cfg.kv_aggregation_kernel_size,
                            cfg.kv_aggregation_stride).permute(0, 2, 3, 1)
        q = self.norm(q).reshape(b, ah * aw, c)
        kv_a = self.norm(kv_a).reshape(b, -1, c)
        nh = cfg.num_attention_heads
        d = c // nh
        p = self.attn
        qs = torch.matmul(q, p.q_proj)
        kx = torch.matmul(kv_a, p.k_proj)
        vs = torch.matmul(kv_a, p.v_proj)
        if rope is not None:
            cos, sin = rope
            qs = qs * cos + _rotate_half(qs) * sin
            kx = kx * cos + _rotate_half(kx) * sin
        qs = qs.reshape(b, -1, nh, d)
        kx = kx.reshape(b, -1, nh, d)
        vs = vs.reshape(b, -1, nh, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", qs, kx) / math.sqrt(d)
        probs = torch.softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), -1).to(x.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", probs, vs).reshape(b, -1, c)
        y = torch.matmul(y, p.o_proj).reshape(b, ah, aw, c)
        y = resize_bilinear_torch(y, (ah * ks, aw * ks))[:, :h, :w]
        z = torch.cat([x, y], -1)
        z = torch.matmul(F.leaky_relu(torch.matmul(z, self.mlp.fc1), 0.01),
                         self.mlp.fc2)
        return x + self.mlp.layer_norm(z)


class _TransformerLayer(nn.Module):
    def __init__(self, cfg, gen):
        super().__init__()
        self.self_attention = AggregatedAttention(cfg, gen)
        self.cross_attention = AggregatedAttention(cfg, gen)


class _OutConvBlock(nn.Module):
    """hidden (c_mid channels) + the residual (c_out) -> c_out channels at
    twice the resolution."""

    def __init__(self, c_out: int, c_mid: int, gen: torch.Generator):
        super().__init__()
        self.out_conv1 = _raw((1, 1, c_out, c_mid), gen,
                              math.sqrt(2.0 / c_out))
        self.out_conv2 = _he_conv(c_mid, c_mid, 3, gen, padding=1)
        self.out_conv3 = _raw((3, 3, c_mid, c_out), gen,
                              math.sqrt(2.0 / (9 * c_mid)))

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor
                ) -> torch.Tensor:
        r = torch.matmul(residual, self.out_conv1[0, 0]) + hidden
        r = self.out_conv2(r.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        r = F.leaky_relu(r, 0.01)
        r = _conv3x3_hwio(r, self.out_conv3)
        return resize_bilinear_torch(r, (r.shape[1] * 2, r.shape[2] * 2))


class _FineFusion(nn.Module):
    def __init__(self, cfg: EfficientLoFTRConfig, gen: torch.Generator):
        super().__init__()
        dims = cfg.fine_fusion_dims
        self.out_conv = _raw((1, 1, cfg.hidden_size, dims[0]), gen,
                             math.sqrt(2.0 / cfg.hidden_size))
        self.out_conv_layers = nn.ModuleList(
            _OutConvBlock(dims[i], dims[i - 1], gen)
            for i in range(1, len(dims)))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], -1).reshape(x.shape)


def rope_tables(cfg: EfficientLoFTRConfig, h: int, w: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """compute_embeddings + repeat_interleave(2): (h*w, hidden) float32
    cos / sin (indices from 1, as the reference's cumsum of ones)."""
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    dim = int(head_dim * cfg.partial_rotary_factor)
    inv_freq = 1.0 / cfg.rope_theta ** (np.arange(0, dim, 2,
                                                  dtype=np.float64) / dim)
    i_idx = np.arange(1, h + 1, dtype=np.float64)[:, None, None]
    j_idx = np.arange(1, w + 1, dtype=np.float64)[None, :, None]
    emb = np.zeros((h, w, cfg.hidden_size // 2), np.float64)
    emb[..., 0::2] = i_idx * inv_freq
    emb[..., 1::2] = j_idx * inv_freq
    cos = np.repeat(np.cos(emb), 2, axis=-1).reshape(h * w, -1)
    sin = np.repeat(np.sin(emb), 2, axis=-1).reshape(h * w, -1)
    return cos.astype(np.float32), sin.astype(np.float32)


def _rope_cos(cfg, h, w):
    return rope_tables(cfg, h, w)[0]


def _rope_sin(cfg, h, w):
    return rope_tables(cfg, h, w)[1]


def border_mask(h: int, w: int, margin: int) -> np.ndarray:
    m = np.zeros((h, w), bool)
    if margin > 0:
        m[:margin] = True
        m[-margin:] = True
        m[:, :margin] = True
        m[:, -margin:] = True
    return m


def _fine_grid(k: int) -> np.ndarray:
    gx, gy = np.meshgrid(np.arange(k), np.arange(k))
    return np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32) \
        - (k // 2) + 0.5


class EfficientLoFTR(nn.Module):
    """EfficientLoFTRForKeypointMatching's forward (JAX ``match_pair``)."""

    def __init__(self, cfg: EfficientLoFTRConfig = EfficientLoFTRConfig(),
                 device=None, seed: int = 0):
        """Weights are drawn on the host from a ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default: the CPU; the
        backends pass theirs)."""
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        in_ch = [1] + list(cfg.out_features[:-1])
        self.backbone = nn.ModuleList()
        for si, nblocks in enumerate(cfg.stage_num_blocks):
            cout = cfg.out_features[si]
            self.backbone.append(nn.ModuleList(
                _he_conv(in_ch[si] if bi == 0 else cout, cout, 3, gen,
                         stride=cfg.stage_stride[si] if bi == 0 else 1,
                         padding=1)
                for bi in range(nblocks)))
        self.transformer = nn.ModuleList(
            _TransformerLayer(cfg, gen)
            for _ in range(cfg.num_attention_layers))
        self.fine_fusion = _FineFusion(cfg, gen)
        if device is not None:
            self.to(device)
        self.eval()

    # ------------------------------------------------------------ stages

    def repvgg_forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 1) -> [stage2, stage3, stage4] NHWC features (stage 1
        is dropped, as in EfficientLoFTRepVGG.forward)."""
        y = x.permute(0, 3, 1, 2)
        outs = []
        for stage in self.backbone:
            for conv in stage:
                y = F.relu(conv(y))
            outs.append(y.permute(0, 2, 3, 1))
        return outs[1:]

    def rope(self, ah: int, aw: int, dev):
        return (constant(_rope_cos, (self.cfg, ah, aw), dev),
                constant(_rope_sin, (self.cfg, ah, aw), dev))

    def local_feature_transformer(self, feats: torch.Tensor, rope
                                  ) -> torch.Tensor:
        """feats (B, 2, h, w, C): each layer's self-attention, then the
        reference's sequential cross-attention (features_1 attends to the
        UPDATED features_0)."""
        b, _, h, w, c = feats.shape
        for layer in self.transformer:
            x = layer.self_attention(feats.reshape(b * 2, h, w, c),
                                     feats.reshape(b * 2, h, w, c), rope)
            x = x.reshape(b, 2, h, w, c)
            f0, f1 = x[:, 0], x[:, 1]
            f0 = layer.cross_attention(f0, f1)
            f1 = layer.cross_attention(f1, f0)
            feats = torch.stack([f0, f1], 1)
        return feats

    def fine_fusion_forward(self, coarse: torch.Tensor,
                            residuals: Sequence[torch.Tensor]):
        """coarse (B2, h, w, C) + residuals [stage3, stage2] -> unfolded
        windows (feat0 (B, L, k*k, D), feat1 (B, L, (k+2)^2, D))."""
        ff = self.fine_fusion
        x = torch.matmul(coarse, ff.out_conv[0, 0])
        x = resize_bilinear_torch(x, (x.shape[1] * 2, x.shape[2] * 2))
        for block, r in zip(ff.out_conv_layers, residuals):
            x = block(x, r)
        b2, fh, fw, d = x.shape
        k = self.cfg.fine_kernel_size
        x = x.reshape(b2 // 2, 2, fh, fw, d)
        f0, f1 = x[:, 0], x[:, 1]
        stride = fh // coarse.shape[1]
        b = f0.shape[0]
        f0 = f0.reshape(b, fh // k, k, fw // k, k, d)
        f0 = f0.permute(0, 1, 3, 5, 2, 4).reshape(b, -1, d, k * k)
        f0 = f0.transpose(2, 3)                             # (B, L, k*k, D)
        patches = F.unfold(f1.permute(0, 3, 1, 2), (k + 2, k + 2),
                           padding=1, stride=stride)    # (B, D*(k+2)^2, L)
        n = patches.shape[-1]
        f1 = patches.reshape(b, d, (k + 2) ** 2, n).permute(0, 3, 2, 1)
        return f0, f1

    # ---------------------------------------------------------- matching

    def coarse_scores(self, feats: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, _, h, w, c = feats.shape
        f = feats.reshape(b, 2, h * w, c) / math.sqrt(c)
        sim = torch.einsum("bld,bmd->blm", f[:, 0], f[:, 1])
        sim = sim / cfg.coarse_matching_temperature
        if cfg.coarse_matching_skip_softmax:
            return sim
        s = sim.to(torch.promote_types(sim.dtype, torch.float32))
        return (torch.softmax(s, 1) * torch.softmax(s, 2)).to(feats.dtype)

    def get_matches(self, scores: torch.Tensor, h: int, w: int):
        """(B, L0, L1) scores -> indices (B, 2, L), scores (B, 2, L), -1 /
        0 for unmatched slots (mutual nearest above the threshold, off the
        border)."""
        cfg = self.cfg
        mask = scores > cfg.coarse_matching_threshold
        bm = torch.from_numpy(border_mask(
            h, w, cfg.coarse_matching_border_removal).reshape(-1)).to(
                scores.device)
        mask = mask & ~bm[None, :, None] & ~bm[None, None, :]
        max0 = scores.max(2, keepdim=True).values
        max1 = scores.max(1, keepdim=True).values
        mask = mask & (scores == max0) & (scores == max1)
        masked = scores * mask
        sc0, idx0 = masked.max(1).values, masked.argmax(1)
        sc1, idx1 = masked.max(2).values, masked.argmax(2)
        indices = torch.stack([idx0, idx1], 1)
        sc = torch.stack([sc0, sc1], 1)
        return torch.where(sc > 0, indices, torch.full_like(indices, -1)), sc

    def fine_matching(self, f0, f1, coarse_kp, fine_scale: float):
        """f0 (B, L, k*k, D), f1 (B, L, (k+2)^2, D), coarse_kp (B, 2, L, 2)
        -> fine keypoints (B, 2, L, 2): both fine stages."""
        cfg = self.cfg
        b, n, win, d = f0.shape
        k = cfg.fine_kernel_size
        sd = cfg.fine_matching_slice_dim
        a0, s0 = f0[..., :d - sd], f0[..., d - sd:]
        a1, s1 = f1[..., :d - sd], f1[..., d - sd:]
        a0 = a0 / math.sqrt(d - sd)
        a1 = a1 / math.sqrt(d - sd)
        conf = torch.einsum("blpc,blqc->blpq", a0, a1)
        conf = torch.softmax(conf, 2) * torch.softmax(conf, 3)
        conf = conf.reshape(b, n, win, k + 2, k + 2)[..., 1:-1, 1:-1]
        conf = conf.reshape(b, n, win * win)
        idx = conf.argmax(-1)
        i0, i1 = idx // win, idx % win
        grid = constant(_fine_grid, (k,), f0.device).to(f0.dtype)
        m0 = coarse_kp[:, 0] + grid[i0] * fine_scale
        m1 = coarse_kp[:, 1] + grid[i1] * fine_scale

        # second stage: the 3x3 neighbourhood of i1 in the uncropped
        # window, with the reference's negative-index wrap
        i1i, i1j = i1 // k, i1 % k
        s1 = s1 / math.sqrt(sd)
        conf2 = torch.einsum("blpc,blqc->blpq", s0, s1)
        conf2 = conf2.reshape(b, n, win, k + 2, k + 2)
        conf2 = torch.gather(conf2, 2, i0[:, :, None, None, None].expand(
            b, n, 1, k + 2, k + 2))[:, :, 0]              # (B, L, k+2, k+2)
        dk = torch.arange(-1, 2, device=f0.device)
        ii = (i1i[..., None] + dk) % (k + 2)                 # (B, L, 3)
        jj = (i1j[..., None] + dk) % (k + 2)
        rows = torch.gather(conf2, 2, ii[..., :, None].expand(
            b, n, 3, k + 2))                                 # (B, L, 3, K)
        neigh = torch.gather(rows, 3, jj[..., None, :].expand(b, n, 3, 3))
        heat = torch.softmax(
            (neigh / cfg.fine_matching_regress_temperature).reshape(
                b, n, 9), -1).reshape(b, n, 3, 3)
        lin = torch.tensor([-1.0, 0.0, 1.0], dtype=heat.dtype,
                           device=heat.device)
        delta = torch.stack([(heat.sum(-2) * lin).sum(-1),
                             (heat.sum(-1) * lin).sum(-1)], -1)
        m1 = m1 + delta * (3 // 2) * fine_scale
        return torch.stack([m0, m1], 1)

    def coarse_features(self, pixels: torch.Tensor):
        """pixels (B, 2, H, W) -> (the backbone's [stage2, stage3, stage4],
        the transformer's coarse features (B, 2, h, w, C))."""
        cfg = self.cfg
        b, _, hh, ww = pixels.shape
        feats = self.repvgg_forward(pixels.reshape(b * 2, hh, ww, 1))
        coarse = feats[-1]
        ch, cw, c = coarse.shape[1], coarse.shape[2], coarse.shape[3]
        ah = (ch - cfg.q_aggregation_kernel_size) \
            // cfg.q_aggregation_stride + 1
        aw = (cw - cfg.q_aggregation_kernel_size) \
            // cfg.q_aggregation_stride + 1
        rope = self.rope(ah, aw, pixels.device)
        return feats, self.local_feature_transformer(
            coarse.reshape(b, 2, ch, cw, c), rope)

    def forward(self, pixels: torch.Tensor):
        """pixels (B, 2, H, W) grey in [0, 1] -> (keypoints (B, 2, L, 2)
        normalised to [0, 1], matching scores (B, 2, L), matches (B, 2, L)
        with -1 unmatched), L the coarse cells (JAX ``match_pair``)."""
        cfg = self.cfg
        b, _, hh, ww = pixels.shape
        feats, coarse = self.coarse_features(pixels)
        ch, cw, c = coarse.shape[2], coarse.shape[3], coarse.shape[4]
        scores = self.coarse_scores(coarse)
        idx, sc = self.get_matches(scores, ch, cw)
        coarse_scale = hh / ch
        kp = torch.stack([idx % cw, idx // cw], -1).to(pixels.dtype) \
            * coarse_scale
        coarse_n = (coarse / math.sqrt(cfg.hidden_size)).reshape(
            b * 2, ch, cw, c)
        f0, f1 = self.fine_fusion_forward(coarse_n, [feats[1], feats[0]])
        n = f0.shape[1]
        # unmatched slots are -1: torch's negative indexing wraps to the
        # last cell, as the JAX module's % n (callers discard them)
        g0 = torch.gather(f0, 1, (idx[:, 0] % n)[:, :, None, None].expand(
            -1, -1, f0.shape[2], f0.shape[3]))
        g1 = torch.gather(f1, 1, (idx[:, 1] % n)[:, :, None, None].expand(
            -1, -1, f1.shape[2], f1.shape[3]))
        fine_scale = hh / int(ch * coarse_scale)
        fine_kp = self.fine_matching(g0, g1, kp, fine_scale)
        fine_kp = fine_kp / torch.tensor([ww, hh], dtype=fine_kp.dtype,
                                         device=fine_kp.device)
        return fine_kp, sc, idx


# ---------------------------------------------------------------- import


def _fuse_conv_bn(w: np.ndarray, state, bn_prefix: str, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the bias-free convolution before
    it (w OIHW numpy), in float32 and in the JAX package's order."""
    gamma = hf_array(state, bn_prefix + ".weight")
    beta = hf_array(state, bn_prefix + ".bias")
    mean = hf_array(state, bn_prefix + ".running_mean")
    var = hf_array(state, bn_prefix + ".running_var")
    scale = gamma / np.sqrt(var + eps)
    return w * scale[:, None, None, None], beta - mean * scale


def import_hf_efficientloftr(state: Dict[str, Any],
                             cfg: EfficientLoFTRConfig,
                             prefix: str = "efficientloftr."
                             ) -> Dict[str, Any]:
    """``EfficientLoFTRForKeypointMatching.state_dict()`` -> the zoo's
    param tree (the JAX package's ``import_hf_efficientloftr`` tree, leaf
    for leaf): each RepVGG block's three branches and their BatchNorms
    fused into one biased 3 x 3 convolution (the architecture's deploy-time
    reparameterisation), the fine fusion's BatchNorm folded into its
    convolution."""
    def hwio(name):
        return hf_array(state, name).transpose(2, 3, 1, 0)

    backbone: List[List[Dict[str, Any]]] = []
    in_ch = [1] + list(cfg.out_features[:-1])
    for si, nblocks in enumerate(cfg.stage_num_blocks):
        stage = []
        for bi in range(nblocks):
            base = f"{prefix}backbone.stages.{si}.blocks.{bi}."
            cin = in_ch[si] if bi == 0 else cfg.out_features[si]
            cout = cfg.out_features[si]
            stride = cfg.stage_stride[si] if bi == 0 else 1
            w3, b3 = _fuse_conv_bn(hf_array(state, base + "conv1.conv.weight"),
                                   state, base + "conv1.norm")
            w1, b1 = _fuse_conv_bn(hf_array(state, base + "conv2.conv.weight"),
                                   state, base + "conv2.norm")
            w = w3.copy()
            w[:, :, 1:2, 1:2] += w1
            bias = b3 + b1
            if cin == cout and stride == 1:
                ident = np.zeros_like(w3)
                ident[np.arange(cout), np.arange(cout), 1, 1] = 1.0
                wi, bi_ = _fuse_conv_bn(ident, state, base + "identity")
                w += wi
                bias += bi_
            stage.append({"kernel": w.transpose(2, 3, 1, 0), "bias": bias})
        backbone.append(stage)

    def agg(base):
        return {
            "q_aggregation": {"kernel": hwio(
                base + "aggregation.q_aggregation.weight")},
            "norm": hf_norm(state, base + "aggregation.norm"),
            "attn": {k: hf_array(state, base + f"attention.{k}.weight").T
                     for k in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"fc1": hf_array(state, base + "mlp.fc1.weight").T,
                    "fc2": hf_array(state, base + "mlp.fc2.weight").T,
                    "layer_norm": hf_norm(state, base + "mlp.layer_norm")},
        }

    transformer = []
    for i in range(cfg.num_attention_layers):
        base = f"{prefix}local_feature_transformer.layers.{i}."
        transformer.append({
            "self_attention": agg(base + "self_attention."),
            "cross_attention": agg(base + "cross_attention.")})

    out_layers = []
    for i in range(1, len(cfg.fine_fusion_dims)):
        base = f"refinement_layer.out_conv_layers.{i - 1}."
        w2, b2 = _fuse_conv_bn(hf_array(state, base + "out_conv2.weight"),
                               state, base + "batch_norm")
        out_layers.append({
            "out_conv1": hwio(base + "out_conv1.weight"),
            "out_conv2": {"kernel": w2.transpose(2, 3, 1, 0), "bias": b2},
            "out_conv3": hwio(base + "out_conv3.weight")})
    fine = {"out_conv": hwio("refinement_layer.out_conv.weight"),
            "out_conv_layers": out_layers}
    return {"backbone": backbone, "transformer": transformer,
            "fine_fusion": fine}
