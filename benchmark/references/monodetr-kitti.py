"""Plain reference of the ``monodetr-kitti`` configuration: MonoDETR's
training step (MonoDETR, Zhang et al. 2023; github.com/ZrrSkywalker/
MonoDETR, ``lib/models/monodetr``, ``lib/datasets/kitti``,
``lib/helpers``) in plain PyTorch and NumPy, float32 with TF32 off.

It imports nothing of the system it checks.  From a KITTI split on disk it
rebuilds each sample (PIL's affine warp, ImageNet normalisation, the
targets of every Car row with the Canonical Object Space depth), runs the
detector (ResNet-50 with frozen batch norm, four levels, the depth
predictor, three deformable encoder and three depth-aware decoder layers
with 50 x 11 Group-DETR queries, box refinement, the per-layer heads),
matches each group of queries with SciPy's Hungarian solver over the
image's targets, takes the SetCriterion's losses over the final and the
auxiliary layers and the DDN depth-map loss, and steps torch's AdamW.

Departures from the published code, each one the system's as well:
multi-scale deformable attention is ``grid_sample`` (Deformable DETR's
``ms_deform_attn_core_pytorch``); the value of the decoder's
self-attention is the raw target; dropout draws its masks from one
generator in call order.  Module names follow the system's state dict so
that one set of seeded tensors fills both.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
CLS2ID = {"Pedestrian": 0, "Car": 1, "Cyclist": 2}
HEADING_BINS = 12


# ---------------------------------------------------------------------------
# data: one sample from the files
# ---------------------------------------------------------------------------

def _affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2 x 3 affine taking three src points to three dst points."""
    a = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        a[2 * i, :2], a[2 * i, 2] = src[i], 1
        a[2 * i + 1, 3:5], a[2 * i + 1, 5] = src[i], 1
        b[2 * i], b[2 * i + 1] = dst[i]
    return np.linalg.solve(a, b).reshape(2, 3)


def center_affine(img_w: float, img_h: float, out_w: int, out_h: int):
    """(trans, trans_inv) of the centred, uncropped resize to the network
    resolution (CenterNet's ``get_affine_transform`` at rotation 0)."""
    c = np.array([img_w / 2, img_h / 2], np.float32)
    src = np.array([c, c + [0, -0.5 * img_w], [0, 0]], np.float32)
    src[2] = src[1] + np.array([-(src[0] - src[1])[1],
                                (src[0] - src[1])[0]], np.float32)
    d0 = np.array([out_w * 0.5, out_h * 0.5], np.float32)
    dst = np.array([d0, d0 + [0, -0.5 * out_w], [0, 0]], np.float32)
    dst[2] = dst[1] + np.array([-(dst[0] - dst[1])[1],
                                (dst[0] - dst[1])[0]], np.float32)
    return _affine(src, dst), _affine(dst, src)


def read_p2(path: str) -> np.ndarray:
    with open(path) as f:
        for line in f:
            if line.startswith("P2:"):
                return np.array(line.split()[1:], np.float64).reshape(3, 4)
    raise ValueError(f"no P2 in {path}")


def read_rows(path: str) -> List[List[str]]:
    with open(path) as f:
        return [ln.split() for ln in f if ln.strip()]


def encode_sample(root: str, idx: str, flip: bool, ds: Dict[str, Any],
                  max_objs: int = 50) -> Dict[str, np.ndarray]:
    """One training sample of the split under ``root``: the image warped
    and normalised, and the padded targets of its cars."""
    from PIL import Image

    out_w, out_h = (int(v) for v in ds.get("resolution", [1280, 384]))
    train = os.path.join(root, "training")
    img = Image.open(os.path.join(train, "image_2", idx + ".png")
                     ).convert("RGB")
    img_w, img_h = img.size
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    trans, trans_inv = center_affine(img_w, img_h, out_w, out_h)
    img = img.transform((out_w, out_h), Image.AFFINE,
                        data=tuple(trans_inv.reshape(-1).tolist()),
                        resample=Image.BILINEAR)
    image = (np.asarray(img).astype(np.float32) / 255.0 - MEAN) / STD
    p2 = read_p2(os.path.join(train, "calib", idx + ".txt"))
    fu, cu = p2[0, 0], p2[0, 2]
    # the Canonical Object Space: the focal length at the network's scale
    fu_adj = fu * out_w / img_w
    canon = float(ds.get("canonical_focal_length", 500.0)) / fu_adj \
        if ds.get("use_canonical_module", False) else 1.0
    m = max_objs
    t = {"labels": np.zeros(m, np.int64), "boxes": np.zeros((m, 4)),
         "boxes_3d": np.zeros((m, 6)), "depth": np.zeros(m),
         "size_3d": np.zeros((m, 3)), "heading_bin": np.zeros(m, np.int64),
         "heading_res": np.zeros(m), "valid": np.zeros(m, bool)}
    res = np.array([out_w, out_h], np.float64)
    for i, f in enumerate(read_rows(os.path.join(train, "label_2",
                                                 idx + ".txt"))[:m]):
        if f[0] not in ds.get("writelist", ["Car"]):
            continue
        trunc, occ = float(f[1]), float(f[2])
        box = np.array(f[4:8], np.float32).astype(np.float64)
        h, w, l = (float(v) for v in f[8:11])
        pos = np.array(f[11:14], np.float32).astype(np.float64)
        ry = float(f[14])
        height = box[3] - box[1] + 1
        if trunc == -1 or not (height >= 25 and trunc <= 0.5 and occ <= 2):
            continue             # DontCare / unknown difficulty
        if pos[2] < 2 or pos[2] > 65:
            continue
        if flip:
            box[0], box[2] = img_w - box[2], img_w - box[0]
            ry = np.pi - ry
            ry = ry - 2 * np.pi if ry > np.pi else (
                ry + 2 * np.pi if ry < -np.pi else ry)
        b2 = np.concatenate([trans @ [box[0], box[1], 1],
                             trans @ [box[2], box[3], 1]])
        c3 = pos + [0, -h / 2, 0]
        uvw = p2 @ np.append(c3, 1.0)
        u, v = uvw[0] / c3[2], uvw[1] / c3[2]
        if flip:
            u = img_w - u
        c3i = trans @ [u, v, 1]
        if not (0 <= c3i[0] < out_w and 0 <= c3i[1] < out_h):
            continue
        c3n = c3i / res
        corner = b2 / np.concatenate([res, res])
        lrtb = [c3n[0] - corner[0], corner[2] - c3n[0],
                c3n[1] - corner[1], corner[3] - c3n[1]]
        if min(lrtb) < 0:
            continue
        bw, bh = b2[2] - b2[0], b2[3] - b2[1]
        # heading: the alpha of the (unflipped-box) centre column
        alpha = ry - np.arctan2((box[0] + box[2]) / 2 - cu, fu)
        alpha = alpha - 2 * np.pi if alpha > np.pi else (
            alpha + 2 * np.pi if alpha < -np.pi else alpha)
        per = 2 * np.pi / HEADING_BINS
        shifted = (alpha % (2 * np.pi) + per / 2) % (2 * np.pi)
        hb = int(shifted / per)
        t["labels"][i] = CLS2ID[f[0]]
        t["boxes"][i] = [(b2[0] + b2[2]) / 2 / out_w,
                         (b2[1] + b2[3]) / 2 / out_h, bw / out_w, bh / out_h]
        t["boxes_3d"][i] = [c3n[0], c3n[1], *lrtb]
        t["depth"][i] = pos[2] * canon
        t["size_3d"][i] = [h, w, l]
        t["heading_bin"][i] = hb
        t["heading_res"][i] = shifted - (hb * per + per / 2)
        t["valid"][i] = True
    return {"image": image, "calib": p2.astype(np.float32),
            "img_size": np.array([img_w, img_h], np.float32), **t}


def make_batch(root: str, ids: Sequence, flips: Sequence,
               ds: Dict[str, Any]) -> Dict[str, np.ndarray]:
    samples = [encode_sample(root, f"{int(i):06d}", bool(f), ds)
               for i, f in zip(ids, flips)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p, self.generator = p, None

    def forward(self, x):
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device, dtype=torch.float32) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class FrozenBN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        for name, v in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                        ("var", 1.0)):
            self.register_buffer(name, torch.full((c,), v))

    def forward(self, x):
        w = self.scale * torch.rsqrt(self.var + 1e-5)
        b = self.bias - self.mean * w
        return x * w[:, None, None] + b[:, None, None]


def conv(cin, cout, k, stride=1, padding=0, bias=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride, down):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, width, 1, bias=False), FrozenBN(width)
        self.conv2 = conv(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(width)
        self.conv3 = conv(width, 4 * width, 1, bias=False)
        self.bn3 = FrozenBN(4 * width)
        self.down = down
        if down:
            self.down_conv = conv(cin, 4 * width, 1, stride, bias=False)
            self.down_bn = FrozenBN(4 * width)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = self.down_bn(self.down_conv(x)) if self.down else x
        return torch.relu(y + idt)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 7, 2, 3, bias=False), FrozenBN(64)
        self.pool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for s, (n, w) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            for b in range(n):
                self.add_module(f"layer{s + 1}_{b}", Bottleneck(
                    cin, w, 2 if (s > 0 and b == 0) else 1, b == 0))
                cin = 4 * w

    def forward(self, x):
        y = self.pool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for s, n in enumerate((3, 4, 6, 3)):
            for b in range(n):
                y = getattr(self, f"layer{s + 1}_{b}")(y)
            if s >= 1:
                outs.append(y)
        return outs


class MHA(nn.Module):
    def __init__(self, d, heads, p):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.attn_dropout = Dropout(p)

    def forward(self, q, k, v):
        d = q.shape[-1]
        dh = d // self.heads

        def split(x):
            return x.reshape(x.shape[:-1] + (self.heads, dh))

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), \
            split(self.v_proj(v))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
        attn = self.attn_dropout(torch.softmax(logits, -1))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.out_proj(out.reshape(q.shape[:-1] + (d,)))


def msda(value, shapes, loc, aw):
    """Multi-scale deformable attention by ``grid_sample``: value (B, S,
    M, D), loc (B, Q, M, L, P, 2) in [0, 1], aw (B, Q, M, L, P) -> (B, Q,
    M * D)."""
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


def ring_bias(heads, levels, points):
    th = np.arange(heads, dtype=np.float32) * (2 * np.pi / heads)
    g = np.stack([np.cos(th), np.sin(th)], -1)
    g = g / np.abs(g).max(-1, keepdims=True)
    g = np.tile(g[:, None, None], (1, levels, points, 1))
    for i in range(points):
        g[:, :, i] *= i + 1
    return g.reshape(-1)


class MSDeformAttn(nn.Module):
    def __init__(self, d, levels, heads, points):
        super().__init__()
        self.m, self.l, self.p = heads, levels, points
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref, src, shapes):
        b, q, d = query.shape
        m, lv, p = self.m, self.l, self.p
        value = self.value_proj(src).reshape(b, -1, m, d // m)
        off = self.sampling_offsets(query).reshape(b, q, m, lv, p, 2)
        aw = torch.softmax(self.attention_weights(query).reshape(
            b, q, m, lv * p), -1).reshape(b, q, m, lv, p)
        if ref.shape[-1] == 2:
            norm = torch.tensor([[w, h] for h, w in shapes],
                                dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None, :] \
                + off / norm[None, None, None, :, None, :]
        else:
            box = ref[:, :, None, :, None]
            wh = box[..., 2::2] + box[..., 3::2]
            loc = ref[:, :, None, :, None, :2] + off / p * wh * 0.5
        return self.output_proj(msda(value, shapes, loc, aw))


class EncoderLayer(nn.Module):
    def __init__(self, d, ffn, levels, heads, points, p):
        super().__init__()
        self.self_attn = MSDeformAttn(d, levels, heads, points)
        self.dropout1, self.norm1 = Dropout(p), nn.LayerNorm(d)
        self.linear1, self.dropout2 = nn.Linear(d, ffn), Dropout(p)
        self.linear2, self.dropout3 = nn.Linear(ffn, d), Dropout(p)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src, pos, ref, shapes):
        src = self.norm1(src + self.dropout1(
            self.self_attn(src + pos, ref, src, shapes)))
        ff = self.linear2(self.dropout2(torch.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(ff))


class Encoder(nn.Module):
    def __init__(self, n, *args):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"layer{i}", EncoderLayer(*args))

    def forward(self, src, pos, shapes):
        pts = []
        for h, w in shapes:
            ys = (torch.arange(h, dtype=torch.float32) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32) + 0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        ref = torch.cat(pts).to(src.device)[None, :, None, :].expand(
            src.shape[0], -1, len(shapes), -1)
        for i in range(self.n):
            src = getattr(self, f"layer{i}")(src, pos, ref, shapes)
        return src


class DecoderLayer(nn.Module):
    def __init__(self, d, ffn, levels, heads, points, p, groups):
        super().__init__()
        self.groups = groups
        self.cross_attn_depth = MHA(d, heads, p)
        self.dropout_depth, self.norm_depth = Dropout(p), nn.LayerNorm(d)
        for n in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                  "sa_kpos_proj"):
            self.add_module(n, nn.Linear(d, d))
        self.self_attn = MHA(d, heads, p)
        self.dropout_sa, self.norm2 = Dropout(p), nn.LayerNorm(d)
        self.cross_attn = MSDeformAttn(d, levels, heads, points)
        self.dropout_ca, self.norm1 = Dropout(p), nn.LayerNorm(d)
        self.linear1, self.dropout_ffn = nn.Linear(d, ffn), Dropout(p)
        self.linear2, self.dropout_out = nn.Linear(ffn, d), Dropout(p)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, tgt, qpos, ref, src, shapes, depth_seq):
        tgt = self.norm_depth(tgt + self.dropout_depth(
            self.cross_attn_depth(tgt, depth_seq, depth_seq)))
        qk = tgt + qpos
        q_in = self.sa_qcontent_proj(qk) + self.sa_qpos_proj(qk)
        k_in = self.sa_kcontent_proj(qk) + self.sa_kpos_proj(qk)
        b, gq, d = q_in.shape
        g = self.groups

        def fold(x):
            return x.reshape(b * g, gq // g, d)

        sa = self.self_attn(fold(q_in), fold(k_in), fold(tgt)).reshape(
            b, gq, d)
        tgt = self.norm2(tgt + self.dropout_sa(sa))
        tgt = self.norm1(tgt + self.dropout_ca(self.cross_attn(
            tgt + qpos, ref, src, shapes)))
        ff = self.linear2(self.dropout_ffn(torch.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout_out(ff))


class DepthEncoderLayer(nn.Module):
    def __init__(self, d, heads=8, ffn=256, p=0.1):
        super().__init__()
        self.self_attn = MHA(d, heads, p)
        self.dropout1, self.norm1 = Dropout(p), nn.LayerNorm(d)
        self.linear1, self.dropout2 = nn.Linear(d, ffn), Dropout(p)
        self.linear2, self.dropout3 = nn.Linear(ffn, d), Dropout(p)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src, pos):
        q = src + pos
        src = self.norm1(src + self.dropout1(self.self_attn(q, q, src)))
        ff = self.linear2(self.dropout2(torch.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(ff))


def lid_bins(n, dmin, dmax):
    size = 2 * (dmax - dmin) / (n * (1 + n))
    v = (np.arange(n, dtype=np.float32) + 0.5) ** 2 * size / 2 - size / 8 \
        + dmin
    return np.concatenate([v, [dmax]]).astype(np.float32)


class DepthPredictor(nn.Module):
    def __init__(self, d, bins, dmin, dmax):
        super().__init__()
        self.dmax = dmax
        self.proj, self.upsample = conv(d, d, 1), conv(d, d, 1)
        self.downsample = conv(d, d, 3, 2, 1)
        for n in ("proj_norm", "upsample_norm", "downsample_norm",
                  "head1_norm", "head2_norm"):
            self.add_module(n, nn.GroupNorm(32, d))
        self.head1, self.head2 = conv(d, d, 3, 1, 1), conv(d, d, 3, 1, 1)
        self.classifier = conv(d, bins + 1, 1)
        self.register_buffer("bin_values", torch.from_numpy(
            lid_bins(bins, dmin, dmax)), persistent=False)
        self.encoder = DepthEncoderLayer(d)
        self.depth_pos_embed = nn.Parameter(torch.zeros(int(dmax) + 1, d))

    def forward(self, feats, pos16):
        f8, f16, f32 = feats
        b, d, h, w = f16.shape
        s16 = self.proj_norm(self.proj(f16))
        s32 = self.upsample_norm(self.upsample(F.interpolate(
            f32, size=(h, w), mode="bilinear", align_corners=False)))
        s8 = self.downsample_norm(self.downsample(f8))
        y = (s8 + s16 + s32) / 3.0
        y = torch.relu(self.head1_norm(self.head1(y)))
        y = torch.relu(self.head2_norm(self.head2(y)))
        logits = self.classifier(y).permute(0, 2, 3, 1)
        wdepth = (torch.softmax(logits, -1) * self.bin_values).sum(-1)
        emb = self.encoder(y.flatten(2).transpose(1, 2),
                           pos16.reshape(1, h * w, d)).reshape(b, h, w, d)
        tab = self.depth_pos_embed
        dd = wdepth.clamp(0.0, self.dmax)
        lo = torch.floor(dd)
        frac = (dd - lo)[..., None]
        lo_i = lo.long()
        hi_i = (lo_i + 1).clamp(max=tab.shape[0] - 1)
        ip = tab[lo_i] * (1 - frac) + tab[hi_i] * frac
        return logits, emb + ip, wdepth


def sine_pos(h, w, f=128, temp=10000.0):
    eps, scale = 1e-6, 2 * np.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = temp ** (2 * (np.arange(f, dtype=np.float32) // 2) / f)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])],
                  3).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])],
                  3).reshape(h, w, -1)
    return torch.from_numpy(np.concatenate([py, px], 2))


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps)) - torch.log((1 - x).clamp(min=eps))


class MLP(nn.Module):
    def __init__(self, din, hid, dout, n):
        super().__init__()
        dims = [din] + [hid] * (n - 1) + [dout]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def sample_depth_map(dmap, centers):
    b, h, w = dmap.shape
    x, y = centers[..., 0] * (w - 1), centers[..., 1] * (h - 1)
    x0, y0 = torch.floor(x).clamp(0, w - 1), torch.floor(y).clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
    dx, dy = (x - x0).clamp(0, 1), (y - y0).clamp(0, 1)
    flat = dmap.reshape(b, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).long())

    return (at(y0, x0) * (1 - dx) * (1 - dy) + at(y0, x1) * dx * (1 - dy)
            + at(y1, x0) * (1 - dx) * dy + at(y1, x1) * dx * dy)


class MonoDETR(nn.Module):
    def __init__(self, m: Dict[str, Any]):
        super().__init__()
        d, ffn, heads = m["hidden_dim"], m["dim_feedforward"], m["nheads"]
        lv, p = m["num_feature_levels"], float(m["dropout"])
        self.d, self.nq, self.g = d, m["num_queries"], 11
        self.n_dec, self.levels = m["dec_layers"], lv
        self.backbone = ResNet50()
        for i, c in enumerate((512, 1024, 2048)):
            self.add_module(f"input_proj{i}", conv(c, d, 1))
        self.input_proj3 = conv(2048, d, 3, 2, 1)
        for i in range(lv):
            self.add_module(f"input_norm{i}", nn.GroupNorm(32, d))
        self.level_embed = nn.Parameter(torch.zeros(lv, d))
        self.depth_predictor = DepthPredictor(d, m["num_depth_bins"],
                                              float(m["depth_min"]),
                                              float(m["depth_max"]))
        self.encoder = Encoder(m["enc_layers"], d, ffn, lv, heads,
                               m["enc_n_points"], p)
        self.query_embed = nn.Parameter(torch.zeros(self.nq * self.g, 2 * d))
        self.reference_points = nn.Linear(d, 2)
        nc = m["num_classes"]
        for i in range(self.n_dec):
            self.add_module(f"decoder_layer{i}", DecoderLayer(
                d, ffn, lv, heads, m["dec_n_points"], p, self.g))
            self.add_module(f"class_embed{i}", nn.Linear(d, nc))
            self.add_module(f"bbox_embed{i}", MLP(d, d, 6, 3))
            self.add_module(f"dim_embed{i}", MLP(d, d, 3, 2))
            self.add_module(f"angle_embed{i}", MLP(d, d, 24, 2))
            self.add_module(f"depth_embed{i}", MLP(d, d, 2, 2))

    def forward(self, images, calibs, img_sizes, generator=None):
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator
        b, d = images.shape[0], self.d
        dev = images.device
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))
        srcs = [getattr(self, f"input_norm{i}")(
            getattr(self, f"input_proj{i}")(f))
            for i, f in enumerate((c3, c4, c5))]
        srcs.append(self.input_norm3(self.input_proj3(c5)))
        shapes = [(s.shape[2], s.shape[3]) for s in srcs]
        pos = [sine_pos(h, w, d // 2).to(dev) for h, w in shapes]
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos_flat = torch.cat([pp.reshape(1, -1, d) + self.level_embed[i]
                              for i, pp in enumerate(pos)], 1).expand(
            b, -1, -1)
        dlogits, dembed, wdepth = self.depth_predictor(srcs[:3], pos[1])
        h16, w16 = shapes[1]
        dseq = dembed.reshape(b, h16 * w16, d)
        memory = self.encoder(src, pos_flat, shapes)
        qe = self.query_embed
        qpos = qe[None, :, :d].expand(b, -1, -1)
        tgt = qe[None, :, d:].expand(b, -1, -1)
        ref = torch.sigmoid(self.reference_points(qpos))
        out, refs, hs = tgt, [], []
        for i in range(self.n_dec):
            out = getattr(self, f"decoder_layer{i}")(
                out, qpos, ref[:, :, None, :].expand(-1, -1, self.levels, -1),
                memory, shapes, dseq)
            refs.append(ref)
            hs.append(out)
            tmp = getattr(self, f"bbox_embed{i}")(out)
            if ref.shape[-1] == 6:
                ref = torch.sigmoid(tmp + inverse_sigmoid(ref))
            else:
                ref = torch.sigmoid(torch.cat(
                    [tmp[..., :2] + inverse_sigmoid(ref), tmp[..., 2:]], -1))
            ref = ref.detach()
        layers = []
        for i in range(self.n_dec):
            r = inverse_sigmoid(refs[i])
            tmp = getattr(self, f"bbox_embed{i}")(hs[i])
            tmp = tmp + r if r.shape[-1] == 6 else torch.cat(
                [tmp[..., :2] + r, tmp[..., 2:]], -1)
            coord = torch.sigmoid(tmp)
            size3d = getattr(self, f"dim_embed{i}")(hs[i])
            dreg = getattr(self, f"depth_embed{i}")(hs[i])
            box_h = ((coord[..., 4] + coord[..., 5])
                     * img_sizes[:, 1:2]).clamp(min=1.0)
            dgeo = size3d[..., 0] / box_h * calibs[:, 0, 0][:, None]
            dmap = sample_depth_map(wdepth, coord[..., :2].detach())
            dval = ((1.0 / (torch.sigmoid(dreg[..., 0:1]) + 1e-6) - 1.0)
                    + dgeo[..., None] + dmap[..., None]) / 3.0
            layers.append({
                "pred_logits": getattr(self, f"class_embed{i}")(hs[i]),
                "pred_boxes": coord, "pred_3d_dim": size3d,
                "pred_angle": getattr(self, f"angle_embed{i}")(hs[i]),
                "pred_depth": torch.cat([dval, dreg[..., 1:2]], -1)})
        return layers, dlogits


# ---------------------------------------------------------------------------
# matching and the losses
# ---------------------------------------------------------------------------

WEIGHTS = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0,
           "loss_center": 10.0, "loss_dim": 1.0, "loss_angle": 1.0,
           "loss_depth": 1.0, "loss_depth_map": 1.0}
MATCH = {"class": 2.0, "center": 10.0, "bbox": 5.0, "giou": 2.0}


def to_xyxy(b):
    return torch.stack([b[..., 0] - b[..., 2], b[..., 1] - b[..., 4],
                        b[..., 0] + b[..., 3], b[..., 1] + b[..., 5]], -1)


def giou(a, b):
    """Pairwise GIoU of xyxy boxes (N, 4) x (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / union.clamp(min=1e-9)
    hull = (torch.maximum(a[:, None, 2:], b[None, :, 2:])
            - torch.minimum(a[:, None, :2], b[None, :, :2])).clamp(min=0)
    hull = hull[..., 0] * hull[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


@torch.no_grad()
def match(logits, boxes, tgt, nq: int, forced=None):
    """Per image and group of ``nq`` queries, the Hungarian assignment of
    queries to the image's targets: a list over images of (query index,
    target index) arrays, and the worst gap by which an assignment falls
    short of the optimum.  With ``forced`` ((B, G * nq) target slot a
    query, -1 unmatched: the judged run's decisions) those assignments are
    taken, and the gap is their cost under this side's cost matrix above
    the optimal cost, over its size plus the number of targets (1.0 for an
    assignment that is no matching of every target)."""
    from scipy.optimize import linear_sum_assignment

    out, gap = [], 0.0
    prob = torch.sigmoid(logits)
    a, g = 0.25, 2.0
    neg = (1 - a) * prob ** g * (-torch.log(1 - prob + 1e-8))
    pos = a * (1 - prob) ** g * (-torch.log(prob + 1e-8))
    for i in range(logits.shape[0]):
        lab, tb = tgt["labels"][i], tgt["boxes_3d"][i]
        n = len(lab)
        if n == 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
            continue
        cost = (MATCH["class"] * (pos[i][:, lab] - neg[i][:, lab])
                + MATCH["center"] * torch.cdist(boxes[i][:, :2], tb[:, :2],
                                                p=1)
                + MATCH["bbox"] * torch.cdist(boxes[i][:, 2:], tb[:, 2:], p=1)
                - MATCH["giou"] * giou(to_xyxy(boxes[i]), to_xyxy(tb)))
        cost = cost.double().cpu().numpy()
        qs, ts = [], []
        for g0 in range(0, cost.shape[0], nq):
            r, c = linear_sum_assignment(cost[g0:g0 + nq])
            if forced is not None and i >= len(forced):
                gap = 1.0              # an image the judged run left out
            elif forced is not None:
                slots = tgt["slots"][i]
                row = np.asarray(forced[i][g0:g0 + nq])
                fq = np.nonzero(row >= 0)[0]
                ft = np.searchsorted(slots, row[fq])
                whole = (len(fq) == n and np.all(ft < n)
                         and len(np.unique(ft)) == n
                         and np.array_equal(slots[np.minimum(ft, n - 1)],
                                            row[fq]))
                if not whole:
                    gap = 1.0
                else:
                    best = cost[g0:g0 + nq][r, c].sum()
                    mine = cost[g0:g0 + nq][fq, ft].sum()
                    gap = max(gap, (mine - best) / (abs(best) + n))
                    r, c = fq, ft
            qs.append(r + g0)
            ts.append(c)
        out.append((np.concatenate(qs), np.concatenate(ts)))
    return out, gap


def own_matches(idx, valid: np.ndarray, gq: int) -> np.ndarray:
    """A side's assignments as (B, G * Q) target slots, -1 unmatched."""
    rows = np.full((len(idx), gq), -1, np.int64)
    for i, (q, t) in enumerate(idx):
        rows[i, q] = np.nonzero(valid[i])[0][t]
    return rows


def layer_losses(o, tgt, idx, num_boxes):
    logits = o["pred_logits"]
    onehot = torch.zeros_like(logits)
    qb, qq, tt = [], [], []
    for i, (q, t) in enumerate(idx):
        qb += [i] * len(q)
        qq += list(q)
        tt.append(t)
        onehot[i, q, tgt["labels"][i][t]] = 1.0
    p = torch.sigmoid(logits)
    ce = -(onehot * torch.log(p + 1e-8)
           + (1 - onehot) * torch.log(1 - p + 1e-8))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = 0.25 * onehot + 0.75 * (1 - onehot)
    losses = {"loss_ce": (a_t * (1 - p_t) ** 2 * ce).sum() / num_boxes}

    def gather(key):
        return torch.cat([tgt[key][i][t] for i, (_, t) in enumerate(idx)])

    sel = (torch.tensor(qb, device=logits.device),
           torch.tensor(qq, device=logits.device))
    boxes = o["pred_boxes"][sel]
    tb = gather("boxes_3d")
    losses["loss_center"] = (boxes[:, :2] - tb[:, :2]).abs().sum() \
        / num_boxes
    losses["loss_bbox"] = (boxes[:, 2:] - tb[:, 2:]).abs().sum() / num_boxes
    losses["loss_giou"] = (1 - torch.diag(giou(to_xyxy(boxes),
                                               to_xyxy(tb)))).sum() \
        / num_boxes
    dep = o["pred_depth"][sel]
    lap = 1.4142 * torch.exp(-dep[:, 1]) * (dep[:, 0] - gather("depth")) \
        .abs() + dep[:, 1]
    losses["loss_depth"] = lap.sum() / num_boxes
    dims, td = o["pred_3d_dim"][sel], gather("size_3d")
    l1 = (dims - td).abs() / td.abs().clamp(min=1e-6)
    n_el = max(float(l1.numel()), 1.0)
    comp = ((dims - td).abs().sum().detach() / n_el) / \
        (l1.sum().detach() / n_el).clamp(min=1e-9)
    losses["loss_dim"] = l1.sum() * comp / num_boxes
    ang = o["pred_angle"][sel]
    hb, hr = gather("heading_bin"), gather("heading_res")
    ce_a = F.cross_entropy(ang[:, :12], hb, reduction="none")
    res = ang[:, 12:24].gather(1, hb[:, None])[:, 0]
    losses["loss_angle"] = (ce_a + (res - hr).abs()).sum() / num_boxes
    return losses


def depth_map_loss(dlogits, batch_boxes, batch_depth, valid, bins, dmin,
                   dmax):
    """DDN: the ground-truth depth map painted from the 2D boxes (the
    nearest box wins), LID-binned, focal cross-entropy with foreground
    weight 13 and background 1, mean over pixels."""
    b, h, w, _ = dlogits.shape
    dev = dlogits.device
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    bx = batch_boxes * scale
    x1 = torch.floor(bx[..., 0] - bx[..., 2] / 2)
    y1 = torch.floor(bx[..., 1] - bx[..., 3] / 2)
    x2 = torch.ceil(bx[..., 0] + bx[..., 2] / 2)
    y2 = torch.ceil(bx[..., 1] + bx[..., 3] / 2)
    gt = torch.full((b, h, w), float("inf"), device=dev)
    for i in range(b):
        for j in torch.nonzero(valid[i])[:, 0].tolist():
            u1, v1 = int(x1[i, j]), int(y1[i, j])
            if u1 < 0 or v1 < 0:
                continue
            u2, v2 = int(x2[i, j]), int(y2[i, j])
            gt[i, v1:v2, u1:u2] = torch.minimum(gt[i, v1:v2, u1:u2],
                                                batch_depth[i, j])
    fg = torch.isfinite(gt)
    gt = torch.where(fg, gt, torch.zeros_like(gt))
    size = 2 * (dmax - dmin) / (bins * (1 + bins))
    idx = -0.5 + 0.5 * torch.sqrt((1 + 8 * (gt - dmin) / size).clamp(min=0))
    oob = (idx < 0) | (idx > bins) | ~torch.isfinite(idx)
    tbin = torch.where(oob, torch.full_like(idx, bins),
                       torch.floor(idx)).long()
    ce = -torch.log_softmax(dlogits, -1).gather(-1, tbin[..., None])[..., 0]
    focal = 0.25 * (1 - torch.exp(-ce)) ** 2 * ce
    wts = torch.where(fg, 13.0, 1.0)
    return (focal * wts).sum() / float(b * h * w)


def total_loss(layers, dlogits, batch, m: Dict[str, Any], forced=None):
    """(The weighted sum of every decoder layer's and the depth map's
    losses, the worst gap of a forced assignment (``match``), each layer's
    assignments as target slots).  ``forced``: layer -> (B, G * Q) target
    slots a query, the judged run's decisions."""
    dev = dlogits.device
    valid = torch.as_tensor(batch["valid"], device=dev)
    tgt = {k: [torch.as_tensor(batch[k][i], device=dev)[valid[i]]
               for i in range(valid.shape[0])]
           for k in ("labels", "boxes_3d", "depth", "size_3d",
                     "heading_bin", "heading_res")}
    tgt = {k: [t.float() if t.is_floating_point() else t for t in v]
           for k, v in tgt.items()}
    tgt["slots"] = [np.nonzero(v)[0] for v in np.asarray(batch["valid"])]
    num_boxes = max(float(valid.sum()) * 11, 1.0)
    nq = int(m["num_queries"])
    total, worst, rows = 0.0, 0.0, {}
    for li, o in enumerate(layers):
        idx, gap = match(o["pred_logits"], o["pred_boxes"], tgt, nq,
                         None if forced is None else forced[li])
        worst = max(worst, gap)
        rows[li] = own_matches(idx, np.asarray(batch["valid"]),
                               o["pred_logits"].shape[1])
        for k, v in layer_losses(o, tgt, idx, num_boxes).items():
            total = total + WEIGHTS[k] * v
    dmap = depth_map_loss(
        dlogits, torch.as_tensor(batch["boxes"], dtype=torch.float32,
                                 device=dev),
        torch.as_tensor(batch["depth"], dtype=torch.float32, device=dev),
        valid, int(m["num_depth_bins"]), float(m["depth_min"]),
        float(m["depth_max"]))
    return total + WEIGHTS["loss_depth_map"] * dmap, worst, rows


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def build(config: Dict[str, Any], device) -> MonoDETR:
    return MonoDETR(config["model"]).to(device).train()


def train_reference(config: Dict[str, Any], root: str,
                    first: List[Dict[str, Any]], shapes, weight_seed: int,
                    dropout_seed: int, device, steps: int = 3,
                    tf32: bool = False, keep_only: int = 0, forced=None
                    ) -> Dict[str, Any]:
    """The reference's ``steps`` training steps on the recorded batches'
    samples (``first``: each step's ``img_id`` and ``flip``) from the
    seed's weights: each step's loss, the first gradient's norm by leaf,
    the change of each parameter over the steps by leaf, the worst gap of
    a forced assignment, and each step's assignments by layer.
    ``forced[k]`` (layer -> (B, G * Q) target slots, or None) gives step
    k the judged run's assignments; ``tf32`` runs the products in TF32
    (the control); ``keep_only`` > 0 keeps that many images of each batch
    (a fault)."""
    import bench_weights

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = build(config, device)
        init = bench_weights.seeded_state(shapes, weight_seed, device)
        bench_weights.load_into(model, init)
        m = config["model"]
        decay = [p for n, p in model.named_parameters()
                 if n.endswith("weight") and p.dim() >= 2]
        rest = [p for n, p in model.named_parameters()
                if not (n.endswith("weight") and p.dim() >= 2)]
        opt = torch.optim.AdamW(
            [{"params": decay,
              "weight_decay": float(config["optimizer"]["weight_decay"])},
             {"params": rest, "weight_decay": 0.0}],
            lr=float(config["optimizer"]["lr"]), betas=(0.9, 0.999),
            eps=1e-8)
        gen = torch.Generator(device=device).manual_seed(dropout_seed)
        ds = config["dataset"]
        out: Dict[str, Any] = {"loss": [], "match_gap": 0.0, "matches": []}
        for k in range(steps):
            ids, flips = first[k]["img_id"], first[k]["flip"]
            if keep_only:
                ids, flips = ids[:keep_only], flips[:keep_only]
            batch = make_batch(root, ids, flips, ds)
            img = torch.as_tensor(batch["image"], device=device)
            calib = torch.as_tensor(batch["calib"], device=device)
            size = torch.as_tensor(batch["img_size"], device=device)
            layers, dlogits = model(img, calib, size, gen)
            loss, gap, rows = total_loss(
                layers, dlogits, batch, m,
                None if forced is None else forced[k])
            out["match_gap"] = max(out["match_gap"], gap)
            out["matches"].append(rows)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            out["loss"].append(float(loss.detach()))
            if k == 0:
                out["grad"] = {n: p.grad.norm().item()
                               for n, p in model.named_parameters()
                               if p.grad is not None}
            opt.step()
        out["change"] = {n: (p.detach() - init[n]).norm().item()
                         for n, p in model.named_parameters()}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
