"""Operations and bytes of the networks and kernels the benchmark measures,
counted from the shapes alone, so that a count reads the same work
whatever implements it.

``gemm`` counts are the multiply-adds (two operations each) of every
convolution, dense layer and attention product, as
``torch.utils.flop_counter.FlopCounterMode`` counts them; elementwise
work, norms, softmax and resizes are not counted.  MSDA's bilinear samples
are counted apart (``msda``): one multiply-add a channel and corner in the
forward, two in the backward (the value gradient, and the dot product that
gives the location and weight gradients).

A kernel's bound is the larger of its operations over the float32 peak and
its compulsory bytes over the memory's peak: each input byte read once and
each output byte written once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv(b: int, cin: int, cout: int, k: int, hout: int, wout: int) -> int:
    return 2 * b * cin * cout * k * k * hout * wout


def dense(tokens: int, din: int, dout: int) -> int:
    return 2 * tokens * din * dout


def attention(b: int, q: int, k: int, width: int) -> int:
    """The two products of softmax attention, all heads together
    (``width`` = heads x head size)."""
    return 2 * 2 * b * q * k * width


def msda_samples(b: int, q: int, heads: int, levels: int,
                 points: int) -> int:
    return b * q * heads * levels * points


def msda_fwd(b: int, q: int, s: int, heads: int, levels: int, points: int,
             d: int) -> Tuple[int, int]:
    """(operations, compulsory bytes) of one float32 MSDA forward: value
    (B, S, M, D), locations and weights in, (B, Q, M * D) out."""
    n = msda_samples(b, q, heads, levels, points)
    flops = 2 * 4 * n * d
    nbytes = 4 * (b * s * heads * d + 3 * n + b * q * heads * d)
    return flops, nbytes


def msda_bwd(b: int, q: int, s: int, heads: int, levels: int, points: int,
             d: int) -> Tuple[int, int]:
    """(operations, compulsory bytes) of one float32 MSDA backward (K2 and
    K3 in one launch): value, locations, weights and the output's gradient
    in; the gradients of value, locations and weights out."""
    n = msda_samples(b, q, heads, levels, points)
    flops = 2 * 2 * 4 * n * d
    nbytes = 4 * (2 * b * s * heads * d + 2 * 3 * n + b * q * heads * d)
    return flops, nbytes


def bound_seconds(flops: int, nbytes: int, peaks: Dict[str, float]) -> float:
    return max(flops / peaks["float32_flops"],
               nbytes / peaks["hbm_bytes_per_s"])


# ---------------------------------------------------------------------------
# MonoDETR (configs/monodetr-kitti.json)
# ---------------------------------------------------------------------------

def resnet50_convs(b: int, h: int, w: int) -> Tuple[List[int], List[Tuple]]:
    """The (flops of each convolution) of torchvision's ResNet-50 (stride
    on the 3 x 3) over (B, 3, H, W), and the (C, H, W) of C3, C4, C5."""
    flops = []
    h1, w1 = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    flops.append(conv(b, 3, 64, 7, h1, w1))
    hh, ww = conv_out(h1, 3, 2, 1), conv_out(w1, 3, 2, 1)
    c_in, outs = 64, []
    for stage, (blocks, width) in enumerate(zip((3, 4, 6, 3),
                                                (64, 128, 256, 512))):
        for blk in range(blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            ho, wo = conv_out(hh, 3, stride, 1), conv_out(ww, 3, stride, 1)
            flops.append(conv(b, c_in, width, 1, hh, ww))
            flops.append(conv(b, width, width, 3, ho, wo))
            flops.append(conv(b, width, 4 * width, 1, ho, wo))
            if blk == 0:
                flops.append(conv(b, c_in, 4 * width, 1, ho, wo))
            c_in, hh, ww = 4 * width, ho, wo
        if stage >= 1:
            outs.append((c_in, hh, ww))
    return flops, outs


def monodetr_shapes(h: int, w: int) -> List[Tuple[int, int]]:
    """The four levels' (H, W): C3, C4, C5 and the stride-64 level."""
    _, outs = resnet50_convs(1, h, w)
    shapes = [(oh, ow) for _, oh, ow in outs]
    h5, w5 = shapes[-1]
    shapes.append((conv_out(h5, 3, 2, 1), conv_out(w5, 3, 2, 1)))
    return shapes


def monodetr_step(model: Dict, b: int, h: int, w: int, queries: int
                  ) -> Dict[str, int]:
    """The forward's ``gemm`` and ``msda`` operations of the MonoDETR of a
    model config (``d`` hidden_dim, FFN dim_feedforward, nheads,
    enc_layers, dec_layers, points, depth bins) over B images of H x W
    with ``queries`` decoder queries (num_queries x groups in training),
    the first convolution's apart (``conv1``: its input gradient is never
    taken), and the MSDA launches' shapes."""
    d, ffn = int(model["hidden_dim"]), int(model["dim_feedforward"])
    heads = int(model["nheads"])
    lv = int(model["num_feature_levels"])
    pe, pd = int(model["enc_n_points"]), int(model["dec_n_points"])
    groups = int(model["group_num"])
    bb, outs = resnet50_convs(b, h, w)
    gemm = sum(bb[1:])
    shapes = monodetr_shapes(h, w)
    s = sum(a * c for a, c in shapes)
    # input projections, the fourth level a 3 x 3 stride-2 conv of C5
    for (c, oh, ow) in outs:
        gemm += conv(b, c, d, 1, oh, ow)
    gemm += conv(b, outs[-1][0], d, 3, *shapes[3])
    # depth predictor on the stride-16 grid
    h16, w16 = shapes[1]
    t16 = h16 * w16
    gemm += 2 * conv(b, d, d, 1, h16, w16)          # proj, upsample
    gemm += conv(b, d, d, 3, h16, w16)              # downsample of C3's
    gemm += 2 * conv(b, d, d, 3, h16, w16)          # head1, head2
    gemm += conv(b, d, int(model["num_depth_bins"]) + 1, 1, h16, w16)
    gemm += 4 * dense(b * t16, d, d) + attention(b, t16, t16, d)
    gemm += 2 * dense(b * t16, d, d)                # its FFN (256 wide)
    # encoder
    msda = []
    enc = int(model["enc_layers"])
    for _ in range(enc):
        gemm += 2 * dense(b * s, d, d)                  # value, output
        gemm += dense(b * s, d, heads * lv * pe * 2)     # offsets
        gemm += dense(b * s, d, heads * lv * pe)         # weights
        gemm += dense(b * s, d, ffn) + dense(b * s, ffn, d)
        msda.append((b, s, s, heads, lv, pe, d // heads))
    # queries' reference points
    gemm += dense(b * queries, d, 2)
    dec = int(model["dec_layers"])
    refine = 0
    for _ in range(dec):
        # depth cross-attention over the stride-16 tokens
        gemm += 2 * dense(b * queries, d, d) + 2 * dense(b * t16, d, d)
        gemm += attention(b, queries, t16, d)
        # group-wise self-attention: 4 sa projections and the MHA's 4
        gemm += 8 * dense(b * queries, d, d)
        gemm += attention(b * groups, queries // groups, queries // groups,
                          d)
        # deformable cross-attention: value over the memory
        gemm += dense(b * s, d, d) + dense(b * queries, d, d)
        gemm += dense(b * queries, d, heads * lv * pd * 2)
        gemm += dense(b * queries, d, heads * lv * pd)
        gemm += dense(b * queries, d, ffn) + dense(b * queries, ffn, d)
        msda.append((b, queries, s, heads, lv, pd, d // heads))
        # heads: the box MLP twice (the refinement between layers, whose
        # result is detached, and the output), class, dims, angle, depth
        box = 2 * dense(b * queries, d, d) + dense(b * queries, d, 6)
        refine += box
        gemm += 2 * box + dense(b * queries, d, int(model["num_classes"]))
        for out in (3, 24, 2):
            gemm += dense(b * queries, d, d) + dense(b * queries, d, out)
    ops = sum(msda_fwd(*m)[0] for m in msda)
    return {"gemm": gemm, "conv1": bb[0], "refine": refine, "msda": ops,
            "msda_calls": msda}


def monodetr_train_flops(model: Dict, b: int, h: int, w: int,
                         queries: int) -> int:
    """A training step's operations: the forward, and the backward as
    twice the forward of every layer a gradient reaches (the first
    convolution's weight gradient only; none for the box refinement
    between decoder layers) with MSDA's backward at two multiply-adds a
    channel and corner."""
    f = monodetr_step(model, b, h, w, queries)
    return (3 * f["gemm"] - 2 * f["refine"] + 2 * f["conv1"]
            + 3 * f["msda"])


# ---------------------------------------------------------------------------
# Mask2Former on Swin (configs/mask2former-swinb.json)
# ---------------------------------------------------------------------------

def swin(cfg: Dict, b: int, h: int, w: int) -> Tuple[int, List[Tuple]]:
    """Swin's operations over (B, H, W, 3) and each stage's (C, H, W)."""
    p, c = int(cfg["patch_size"]), int(cfg["embed_dim"])
    win = int(cfg["window_size"])
    mlp = float(cfg["mlp_ratio"])
    hh, ww = h // p, w // p
    gemm = conv(b, 3, c, p, hh, ww)
    stages = []
    n_st = len(cfg["depths"])
    for si, depth in enumerate(cfg["depths"]):
        dim = c * 2 ** si
        hp, wp = -(-hh // win) * win, -(-ww // win) * win
        for _ in range(depth):
            gemm += 4 * dense(b * hp * wp, dim, dim)      # q, k, v, proj
            gemm += attention(b * (hp // win) * (wp // win), win * win,
                              win * win, dim)
            hid = int(dim * mlp)
            gemm += dense(b * hh * ww, dim, hid) + dense(b * hh * ww, hid,
                                                         dim)
        stages.append((dim, hh, ww))
        if si < n_st - 1:
            h2, w2 = (hh + 1) // 2, (ww + 1) // 2
            gemm += dense(b * h2 * w2, 4 * dim, 2 * dim)
            hh, ww = h2, w2
    return gemm, stages


def mask2former_frame(cfg: Dict, h: int, w: int) -> Dict[str, int]:
    """A forward's ``gemm`` and ``msda`` operations over one (H, W) input
    and the MSDA launches' shapes."""
    b = 1
    gemm, stages = swin(cfg["backbone"], b, h, w)
    fd, hd = int(cfg["feature_size"]), int(cfg["hidden_dim"])
    heads, nl = int(cfg["num_attention_heads"]), int(cfg["num_feature_levels"])
    pts = int(cfg["deform_points"])
    levels = stages[::-1][:nl]
    for c, lh, lw in levels:
        gemm += conv(b, c, fd, 1, lh, lw)
    s = sum(lh * lw for _, lh, lw in levels)
    msda = []
    for _ in range(int(cfg["encoder_layers"])):
        gemm += dense(b * s, fd, heads * nl * pts * 2)
        gemm += dense(b * s, fd, heads * nl * pts)
        gemm += 2 * dense(b * s, fd, fd)
        ef = int(cfg["encoder_feedforward_dim"])
        gemm += dense(b * s, fd, ef) + dense(b * s, ef, fd)
        msda.append((b, s, s, heads, nl, pts, fd // heads))
    # the FPN tail on the stride-4 map, and the mask projection
    c1, h4, w4 = stages[0]
    gemm += conv(b, c1, fd, 1, h4, w4) + conv(b, fd, fd, 3, h4, w4)
    mfd = int(cfg["mask_feature_size"])
    gemm += conv(b, fd, mfd, 1, h4, w4)
    # the decoder: a prediction before the first layer and after each
    nq = int(cfg["num_queries"])
    ff = int(cfg["dim_feedforward"])
    n_labels = int(cfg["num_labels"])
    predict = (2 * dense(b * nq, hd, hd) + dense(b * nq, hd, mfd)
               + 2 * b * nq * mfd * h4 * w4 + dense(b * nq, hd, n_labels + 1))
    gemm += predict
    sizes = [lh * lw for _, lh, lw in levels]
    for idx in range(int(cfg["decoder_layers"]) - 1):
        sl = sizes[idx % nl]
        gemm += 2 * dense(b * nq, hd, hd) + 2 * dense(b * sl, hd, hd)
        gemm += attention(b, nq, sl, hd)
        gemm += 4 * dense(b * nq, hd, hd) + attention(b, nq, nq, hd)
        gemm += dense(b * nq, hd, ff) + dense(b * nq, ff, hd)
        gemm += predict
    ops = sum(msda_fwd(*m)[0] for m in msda)
    return {"gemm": gemm, "msda": ops, "msda_calls": msda}


def msda_bounds(calls: Sequence[Tuple], peaks: Dict[str, float],
                backward: bool = False) -> float:
    """Summed bound seconds of MSDA launches of the given shapes."""
    fn = msda_bwd if backward else msda_fwd
    return sum(bound_seconds(*fn(*c), peaks) for c in calls)
