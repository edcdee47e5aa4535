"""Plain reference of the ``mask2former-swinb`` configuration: the mask
stage of the labeller with Mask2Former on a Swin-B trunk (Cheng et al.
2022; Hugging Face ``Mask2FormerForUniversalSegmentation``, the layout of
facebook/mask2former-swin-base-coco-instance) in plain PyTorch and NumPy,
float32 with TF32 off.

It imports nothing of the system it checks.  For a uint8 frame it resizes
the frame to the network's input as OpenCV's ``INTER_LINEAR`` does on
uint8 (11-bit fixed point, in NumPy), normalises it, runs the network
(Swin with shifted windows, the pixel decoder's six deformable encoder
layers by ``grid_sample``, the FPN tail, the ten predictions of the masked
decoder), and keeps, for each label group, the queries whose largest
class probability over the group clears the score threshold, their mask
logits resized to the frame (OpenCV's float ``INTER_LINEAR``) and
thresholded at 0.  Module names follow the system's state dict so that one
set of seeded tensors fills both.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# OpenCV's INTER_LINEAR
# ---------------------------------------------------------------------------

def _taps(dst: int, src: int, coord64: bool, clamp: bool):
    """(dst, 2) source indices and weights of one axis."""
    scale = src / dst
    d = np.arange(dst)
    if coord64:
        x = (d + 0.5) * scale - 0.5
        i = np.floor(x).astype(np.int64)
        f = (x - i).astype(np.float32)
    else:
        x = ((d + 0.5) * scale - 0.5).astype(np.float32)
        i = np.floor(x).astype(np.int64)
        f = (x - i.astype(np.float32)).astype(np.float32)
    if clamp:
        lo, hi = i < 0, i >= src - 1
        i = np.where(lo, 0, np.where(hi, src - 1, i))
        f = np.where(lo | hi, np.float32(0), f).astype(np.float32)
    idx = np.clip(np.stack([i, i + 1], 1), 0, src - 1)
    return idx, np.stack([np.float32(1) - f, f], 1).astype(np.float32)


def resize_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """``cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)`` of an
    (H, W, C) uint8 image: 11-bit weights, a horizontal pass in int32, the
    vertical pass as OpenCV's vector code rounds it."""
    h, w = img.shape[:2]
    ix, ax = _taps(ow, w, False, True)
    iy, ay = _taps(oh, h, False, False)
    ax = np.round(ax * 2048).astype(np.int32)
    ay = np.round(ay * 2048).astype(np.int32)
    s = img.astype(np.int32)
    rows = s[:, ix[:, 0]] * ax[None, :, 0, None] \
        + s[:, ix[:, 1]] * ax[None, :, 1, None]
    r0, r1 = rows[iy[:, 0]], rows[iy[:, 1]]
    v = (((r0 >> 4) * ay[:, 0, None, None]) >> 16) \
        + (((r1 >> 4) * ay[:, 1, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def resize_float(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``cv2.resize`` (INTER_LINEAR) of an (H, W, C) float32 tensor."""
    h, w = x.shape[:2]
    dev = x.device
    ix, ax = (torch.from_numpy(a).to(dev) for a in _taps(ow, w, True, True))
    iy, ay = (torch.from_numpy(a).to(dev) for a in _taps(oh, h, True, False))
    rows = x[:, ix[:, 0]] * ax[None, :, 0, None] \
        + x[:, ix[:, 1]] * ax[None, :, 1, None]
    return rows[iy[:, 0]] * ay[:, 0, None, None] \
        + rows[iy[:, 1]] * ay[:, 1, None, None]


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def attention(q, k, v, bias=None, mask=None):
    b, nq, heads, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q * (1.0 / math.sqrt(d)), k)
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(mask, float("-inf"))
    probs = torch.softmax(logits, -1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, nq,
                                                             heads * d)


def rel_index(win: int) -> torch.Tensor:
    c = np.stack(np.meshgrid(np.arange(win), np.arange(win),
                             indexing="ij")).reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return torch.from_numpy(rel.sum(-1))


def shift_mask(hp: int, wp: int, win: int, shift: int) -> torch.Tensor:
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(hp // win, win, wp // win, win).transpose(
        0, 2, 1, 3).reshape(-1, win * win)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0)
                            .astype(np.float32))


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, win):
        super().__init__()
        self.heads, self.win = heads, win
        self.query, self.key = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.value, self.proj = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * win - 1) ** 2,
                                                       heads))

    def forward(self, x, mask):
        b, n, c = x.shape
        h = self.heads
        q = self.query(x).reshape(b, n, h, c // h)
        k = self.key(x).reshape(b, n, h, c // h)
        v = self.value(x).reshape(b, n, h, c // h)
        idx = rel_index(self.win).to(x.device)
        bias = self.rel_bias_table[idx.reshape(-1)].reshape(n, n, h) \
            .permute(2, 0, 1)
        if mask is not None:
            m = mask.shape[0]
            bias = (bias[None, None] + mask[None, :, None]).expand(
                b // m, m, h, n, n).reshape(b, h, n, n)
        else:
            bias = bias[None]
        return self.proj(attention(q, k, v, bias=bias))


class SwinLayer(nn.Module):
    def __init__(self, dim, heads, win, mlp, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, heads, win)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, int(dim * mlp))
        self.fc2 = nn.Linear(int(dim * mlp), dim)

    def forward(self, x, hw, win, shift):
        h, w = hw
        b, _, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        ph, pw = -h % win, -w % win
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(hp, wp, win, shift).to(x.device)
        y = y.reshape(b, hp // win, win, wp // win, win, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        y = self.attn(y, mask)
        y = y.reshape(b, hp // win, wp // win, win, win, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, h * w, c)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class PatchMerge(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Parameter(torch.zeros(4 * dim, 2 * dim))

    def forward(self, x, hw):
        h, w = hw
        b, _, c = x.shape
        y = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                       y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
        return self.norm(y.reshape(b, -1, 4 * c)) @ self.reduction


class SwinStage(nn.Module):
    def __init__(self, si, bb):
        super().__init__()
        dim = bb["embed_dim"] * 2 ** si
        eps = bb["layer_norm_eps"]
        self.depth = bb["depths"][si]
        for bi in range(self.depth):
            self.add_module(f"block_{bi}", SwinLayer(
                dim, bb["num_heads"][si], bb["window_size"], bb["mlp_ratio"],
                eps))
        if si < len(bb["depths"]) - 1:
            self.downsample = PatchMerge(dim, eps)


class Swin(nn.Module):
    def __init__(self, bb):
        super().__init__()
        self.bb = bb
        e, eps = bb["embed_dim"], bb["layer_norm_eps"]
        self.patch_proj = nn.Conv2d(3, e, bb["patch_size"],
                                    stride=bb["patch_size"])
        self.embed_norm = nn.LayerNorm(e, eps=eps)
        for i in bb["out_indices"]:
            self.add_module(f"out_norm_{i}",
                            nn.LayerNorm(e * 2 ** (i - 1), eps=eps))
        for si in range(len(bb["depths"])):
            self.add_module(f"stage_{si}", SwinStage(si, bb))

    def forward(self, px):
        bb = self.bb
        b = px.shape[0]
        x = self.patch_proj(px.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h, w = x.shape[1], x.shape[2]
        x = self.embed_norm(x.reshape(b, h * w, -1))
        out = []
        for si in range(len(bb["depths"])):
            st = getattr(self, f"stage_{si}")
            for bi in range(st.depth):
                shift = 0 if bi % 2 == 0 else bb["window_size"] // 2
                x = getattr(st, f"block_{bi}")(x, (h, w), bb["window_size"],
                                               shift)
            if (si + 1) in bb["out_indices"]:
                f = getattr(self, f"out_norm_{si + 1}")(x)
                out.append(f.reshape(b, h, w, -1))
            if hasattr(st, "downsample"):
                x = st.downsample(x, (h, w))
                h, w = (h + 1) // 2, (w + 1) // 2
        return out


def sine_pos(h, w, f):
    scale, eps = 2 * np.pi, 1e-6
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones(
        (1, w), np.float32)
    x = np.ones((h, 1), np.float32) * np.arange(1, w + 1,
                                                dtype=np.float32)[None]
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = 10000.0 ** (2 * (np.arange(f) // 2) / f)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])],
                  -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])],
                  -1).reshape(h, w, -1)
    return torch.from_numpy(np.concatenate([py, px], -1).astype(np.float32))


def msda(value, shapes, loc, aw):
    """``grid_sample`` MSDA: value (B, S, M, D), loc (B, Q, M, L, P, 2),
    aw (B, Q, M, L, P) -> (B, Q, M * D)."""
    b, _, m, d = value.shape
    q, lv, p = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = 2 * loc - 1
    sampled, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2) \
            .reshape(b * m, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
        start += h * w
    w8 = aw.transpose(1, 2).reshape(b * m, 1, q, lv * p)
    out = (torch.stack(sampled, -2).flatten(-2) * w8).sum(-1)
    return out.view(b, m * d, q).transpose(1, 2)


def nhwc(m, x):
    return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def interp(x, hw):
    """F.interpolate bilinear (half-pixel) of (B, H, W, C)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="bilinear", align_corners=False
                         ).permute(0, 2, 3, 1)


class PixelEncoderLayer(nn.Module):
    def __init__(self, c, heads, levels, points, ffn):
        super().__init__()
        self.m, self.l, self.p = heads, levels, points
        self.sampling_offsets = nn.Linear(c, heads * levels * points * 2)
        self.attention_weights = nn.Linear(c, heads * levels * points)
        self.value_proj, self.output_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.self_attn_layer_norm = nn.LayerNorm(c)
        self.fc1, self.fc2 = nn.Linear(c, ffn), nn.Linear(ffn, c)
        self.final_layer_norm = nn.LayerNorm(c)

    def forward(self, hidden, pos, ref, shapes):
        b, n, c = hidden.shape
        m, lv, p = self.m, self.l, self.p
        q = hidden + pos
        off = self.sampling_offsets(q).reshape(b, n, m, lv, p, 2)
        aw = torch.softmax(self.attention_weights(q).reshape(b, n, m, lv * p),
                           -1).reshape(b, n, m, lv, p)
        value = self.value_proj(hidden).reshape(b, n, m, c // m)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=hidden.device)
        loc = ref[None, :, None, :, None, :] \
            + off / norm[None, None, None, :, None, :]
        hidden = self.self_attn_layer_norm(
            hidden + self.output_proj(msda(value, shapes, loc, aw)))
        return self.final_layer_norm(
            hidden + self.fc2(torch.relu(self.fc1(hidden))))


class PixelDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg["backbone"]
        nl, fd = cfg["num_feature_levels"], cfg["feature_size"]
        dims = [bb["embed_dim"] * 2 ** (i - 1) for i in bb["out_indices"]]
        self.level_embed = nn.Parameter(torch.zeros(nl, fd))
        self.input_projections = nn.ModuleList(
            nn.Conv2d(c, fd, 1) for c in dims[::-1][:nl])
        self.input_projections_gn = nn.ModuleList(
            nn.GroupNorm(32, fd) for _ in range(nl))
        self.encoder_layers = nn.ModuleList(
            PixelEncoderLayer(fd, cfg["num_attention_heads"], nl,
                              cfg["deform_points"],
                              cfg["encoder_feedforward_dim"])
            for _ in range(cfg["encoder_layers"]))
        self.mask_projection = nn.Conv2d(fd, cfg["mask_feature_size"], 1)
        self.n_fpn = int(np.log2(min(cfg["feature_strides"][-nl:]))
                         - np.log2(cfg["common_stride"]))
        fpn = dims[:self.n_fpn][::-1]
        self.lateral_convs = nn.ModuleList(
            nn.Conv2d(c, fd, 1, bias=False) for c in fpn)
        self.lateral_convs_gn = nn.ModuleList(nn.GroupNorm(32, fd)
                                              for _ in fpn)
        self.output_convs = nn.ModuleList(
            nn.Conv2d(fd, fd, 3, padding=1, bias=False) for _ in fpn)
        self.output_convs_gn = nn.ModuleList(nn.GroupNorm(32, fd)
                                             for _ in fpn)

    def forward(self, feats):
        nl, fd = self.cfg["num_feature_levels"], self.cfg["feature_size"]
        dev = feats[0].device
        embeds = [nhwc(gn, nhwc(pr, f)) for f, pr, gn in zip(
            feats[::-1][:nl], self.input_projections,
            self.input_projections_gn)]
        shapes = [(e.shape[1], e.shape[2]) for e in embeds]
        b = embeds[0].shape[0]
        hidden = torch.cat([e.reshape(b, -1, fd) for e in embeds], 1)
        pos = torch.cat([(sine_pos(h, w, fd // 2).to(dev)
                          + self.level_embed[i]).reshape(1, -1, fd)
                         for i, (h, w) in enumerate(shapes)], 1)
        pts = []
        for h, w in shapes:
            ry = (torch.arange(h, dtype=torch.float32) + 0.5) / h
            rx = (torch.arange(w, dtype=torch.float32) + 0.5) / w
            gy, gx = torch.meshgrid(ry, rx, indexing="ij")
            pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        ref = torch.cat(pts)[:, None].expand(-1, nl, 2).to(dev)
        for layer in self.encoder_layers:
            hidden = layer(hidden, pos, ref, shapes)
        outs, start = [], 0
        for h, w in shapes:
            outs.append(hidden[:, start:start + h * w].reshape(b, h, w, fd))
            start += h * w
        for i, f in enumerate(feats[:self.n_fpn][::-1]):
            lat = nhwc(self.lateral_convs_gn[i], nhwc(self.lateral_convs[i],
                                                      f))
            y = lat + interp(outs[-1], lat.shape[1:3])
            outs.append(torch.relu(nhwc(self.output_convs_gn[i],
                                        nhwc(self.output_convs[i], y))))
        return nhwc(self.mask_projection, outs[-1]), outs[:nl]


class MHA(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q, self.k = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v, self.out = nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, q, k, v, mask=None):
        b, nq, c = q.shape
        h = self.heads
        qp = self.q(q).reshape(b, nq, h, c // h)
        kp = self.k(k).reshape(b, -1, h, c // h)
        vp = self.v(v).reshape(b, -1, h, c // h)
        if mask is not None:
            mask = mask.reshape(b, h, nq, -1)
        return self.out(attention(qp, kp, vp, mask=mask))


class DecoderLayer(nn.Module):
    def __init__(self, hd, heads, ffn):
        super().__init__()
        self.cross_attn = MHA(hd, heads)
        self.cross_attn_layer_norm = nn.LayerNorm(hd)
        self.self_attn = MHA(hd, heads)
        self.self_attn_layer_norm = nn.LayerNorm(hd)
        self.fc1, self.fc2 = nn.Linear(hd, ffn), nn.Linear(ffn, hd)
        self.final_layer_norm = nn.LayerNorm(hd)

    def forward(self, hidden, qpe, enc, pos, att):
        att = att & ~att.all(-1, keepdim=True)
        hidden = self.cross_attn_layer_norm(
            hidden + self.cross_attn(hidden + qpe, enc + pos, enc, mask=att))
        q = hidden + qpe
        hidden = self.self_attn_layer_norm(hidden + self.self_attn(q, q,
                                                                   hidden))
        return self.final_layer_norm(
            hidden + self.fc2(torch.relu(self.fc1(hidden))))


class MaskPredictor(nn.Module):
    def __init__(self, hd, mask_dim):
        super().__init__()
        self.mask_embedder = nn.ModuleList(
            [nn.Linear(hd, hd), nn.Linear(hd, hd), nn.Linear(hd, mask_dim)])

    def forward(self, hidden, pix, target_hw, heads):
        emb = hidden
        for i, layer in enumerate(self.mask_embedder):
            emb = layer(emb)
            if i < 2:
                emb = torch.relu(emb)
        masks = torch.einsum("bqc,bhwc->bqhw", emb, pix)
        logit = interp(masks.permute(0, 2, 3, 1), target_hw)
        logit = logit.permute(0, 3, 1, 2).flatten(2)
        att = torch.sigmoid(logit) < 0.5
        b, q, s = att.shape
        return (masks, att[:, None].expand(b, heads, q, s).reshape(-1, q, s),
                logit)


class Transformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        hd = cfg["hidden_dim"]
        self.level_embed = nn.Parameter(torch.zeros(
            cfg["num_feature_levels"], hd))
        self.queries_embedder = nn.Parameter(torch.zeros(cfg["num_queries"],
                                                         hd))
        self.queries_features = nn.Parameter(torch.zeros(cfg["num_queries"],
                                                         hd))
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(hd, cfg["num_attention_heads"],
                         cfg["dim_feedforward"])
            for _ in range(cfg["decoder_layers"] - 1))
        self.decoder_norm = nn.LayerNorm(hd)
        self.mask_predictor = MaskPredictor(hd, cfg["mask_feature_size"])
        self.class_predictor = nn.Linear(hd, cfg["num_labels"] + 1)

    def predict(self, hidden, pix, hw):
        inter = self.decoder_norm(hidden)
        masks, att, logit = self.mask_predictor(
            inter, pix, hw, self.cfg["num_attention_heads"])
        return self.class_predictor(inter), masks, att, logit

    def forward(self, ms, pix, forced=None):
        """-> (class logits, mask logits, the attention masks each layer
        used, those this decoder made, and the resized mask logits it made
        them from, (B, Q, S) a layer).  ``forced``: the attention masks to
        use in place of this decoder's own (another forward's decisions,
        each layer's computed from the same inputs as here)."""
        cfg = self.cfg
        b, hd, nl = pix.shape[0], cfg["hidden_dim"], cfg["num_feature_levels"]
        sizes = [(f.shape[1], f.shape[2]) for f in ms]
        pos = [sine_pos(h, w, hd // 2).to(pix.device).reshape(1, -1, hd)
               for h, w in sizes]
        enc = [f.reshape(b, -1, hd) + self.level_embed[i]
               for i, f in enumerate(ms)]
        qpe = self.queries_embedder[None].expand(b, -1, -1)
        hidden = self.queries_features[None].expand(b, -1, -1)
        cls, masks, att, logit = self.predict(hidden, pix, sizes[0])
        used, own, logits = [], [], []
        for idx, layer in enumerate(self.decoder_layers):
            li = idx % nl
            own.append(att)
            logits.append(logit)
            if forced is not None:
                att = forced[idx].to(att.device)
            used.append(att)
            hidden = layer(hidden, qpe, enc[li], pos[li], att)
            cls, masks, att, logit = self.predict(hidden, pix,
                                                  sizes[(idx + 1) % nl])
        return cls, masks, used, own, logits


class Mask2Former(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.backbone = Swin(cfg["backbone"])
        self.pixel_decoder = PixelDecoder(cfg)
        self.transformer = Transformer(cfg)

    def forward(self, px, forced=None):
        pix, ms = self.pixel_decoder(self.backbone(px))
        return self.transformer(ms, pix, forced)


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

def build(config: Dict[str, Any], shapes, weight_seed: int, car_bias: float,
          device) -> Mask2Former:
    import bench_weights

    model = Mask2Former(config).to(device).eval()
    bench_weights.load_into(model, bench_weights.seeded_state(
        shapes, weight_seed, device, config.get("table_std")))
    with torch.no_grad():
        model.transformer.class_predictor.bias[
            list(config["car_label_ids"])] += car_bias
    return model


def encode(config: Dict[str, Any], image: np.ndarray, dev) -> torch.Tensor:
    """The network's (H, W, 3) input of one uint8 frame."""
    ih, iw = (int(v) // 32 * 32 for v in config["input_hw"])
    x = torch.from_numpy(resize_u8(image, ih, iw)).to(dev).float() / 255.0
    return (x - torch.tensor(MEAN, device=dev)) / torch.tensor(STD,
                                                                device=dev)


@torch.no_grad()
def frame_masks(model: Mask2Former, config: Dict[str, Any],
                image: np.ndarray, groups: Sequence[Sequence[int]],
                margin: float = 1e-3, forced=None):
    """(class logits, mask logits, per group (kept masks, scores), per
    group the bounds of the kept masks' pixel counts, the attention masks
    the decoder used, those it made and their logits) of one uint8 frame;
    ``forced`` as in ``Transformer.forward``.
    The bounds are the count maps (how many kept masks cover each pixel)
    of the queries kept by more than ``margin`` in the logit of their
    score, and of those kept or within ``margin`` of the threshold: a
    query that close to it may fall either way in float32."""
    dev = next(model.parameters()).device
    cls, masks, used, own, logits = model(encode(config, image, dev)[None],
                                          forced)
    cls, masks = cls[0], masks[0]
    probs = torch.softmax(cls, -1)[:, :-1]
    h, w = image.shape[:2]
    thr = float(config["score_threshold"])
    out, bounds = [], []
    for ids in groups:
        sel = torch.zeros(cls.shape[1], dtype=torch.bool, device=dev)
        sel[list(ids)] = True
        z = torch.logsumexp(cls[:, sel], -1) - torch.logsumexp(
            cls[:, ~sel], -1) - math.log(thr / (1 - thr))
        near = torch.nonzero(z > -margin)[:, 0]
        full = resize_float(masks[near].permute(1, 2, 0).contiguous(),
                            h, w) > 0 if len(near) else None
        strict = np.zeros((h, w), np.int32)
        loose = np.zeros((h, w), np.int32)
        for j, q in enumerate(near.tolist()):
            m = full[..., j].cpu().numpy()
            loose += m
            if z[q] > margin:
                strict += m
        bounds.append((strict, loose))
        prob = probs[:, list(ids)].max(-1).values
        keep = torch.nonzero(prob > float(config["score_threshold"]))[:, 0]
        kept, scores = [], []
        if len(keep):
            full = resize_float(masks[keep].permute(1, 2, 0).contiguous(),
                                h, w) > 0
            for m, s in zip(full.permute(2, 0, 1).cpu().numpy(),
                            prob[keep].cpu().numpy()):
                if m.any():
                    kept.append(m)
                    scores.append(float(s))
        out.append((kept, scores))
    return cls, masks, out, bounds, used, own, logits


def mask_reference(config: Dict[str, Any], shapes, weight_seed: int,
                   car_bias: float, device, frames: List[np.ndarray], groups,
                   tf32: bool = False, forced=None) -> List[Dict[str, Any]]:
    """The reference's class logits, mask logits and kept masks of each
    frame, with the seed's weights and the car label's bias raised by
    ``car_bias``; ``forced`` (one entry a frame, or None) the decoder's
    attention masks to take from the forward judged; ``tf32`` runs the
    products in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = build(config, shapes, weight_seed, car_bias, device)
        res = []
        for k, img in enumerate(frames):
            cls, masks, out, bounds, used, own, logits = frame_masks(
                model, config, img, groups, float(config["kept_margin"]),
                None if forced is None else forced[k])
            res.append({"classes": cls, "masks": masks, "out": out,
                        "bounds": bounds, "att": used, "own_att": own,
                        "own_att_logit": logits})
        return res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def class_logits(config: Dict[str, Any], shapes, weight_seed: int, device,
                 frames: List[np.ndarray], tf32: bool = False, forced=None
                 ) -> List[Dict[str, Any]]:
    """Each frame's (Q, labels + 1) class logits with the seed's weights as
    drawn (no car bias), which the car bias is picked from, with the
    attention masks the decoder used and the resized mask logits it made
    its own from; ``forced`` as in ``mask_reference``."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = build(config, shapes, weight_seed, 0.0, device)
        out = []
        for k, img in enumerate(frames):
            cls, _, used, _, logits = model(
                encode(config, img, device)[None],
                None if forced is None else forced[k])
            out.append({"classes": cls[0], "att": used,
                        "own_att_logit": logits})
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
