"""MonoDETR-equivalent monocular 3D detector (torch).

Behavioral contract (MonoDETR/lib/models/monodetr/monodetr.py:34-299) at
the shipped flags (configs/monodetr_kitti.yaml: sine position embedding,
box refinement on; two_stage, use_dab, use_dn and use_depth off):

* input projections of C3/C4/C5 to hidden_dim + one extra stride-64 level
  (:84-105);
* 50 queries x 11 Group-DETR groups in training mode, the first group in
  eval mode (:200-216);
* initial 2-dof reference points from a linear over the query pos embedding
  (depthaware_transformer.py:123, :283-287);
* per-decoder-layer heads with iterative 6-dof box refinement (:219-274):
  class logits, (cx, cy, l, r, t, b) boxes, 3D dims, 24-channel angle
  (12-bin cls + res), (depth, log-sigma) regression;
* fused depth = average of regression depth 1/sigmoid(d)-1, geometric depth
  f*h3d/h2d, and the bilinearly-sampled weighted depth map (:246-263);
* aux outputs per intermediate decoder layer (:289-297).

``forward`` takes NHWC images like the JAX package and returns its output
dict with the same layouts.  ``compute_dtype`` is the JAX package's
mixed-precision policy (monodetr.py:93-95): "auto" (bfloat16 on a CUDA
device, float32 on the CPU), "float32", "bfloat16", or "float64" on the
CPU; images are cast to it at entry, the backbone, the input projections
and the transformer's dense layers compute in it, and the params, norms,
softmax logits and heads stay float32 (``models/layers.py``).  ``model.train()`` / ``model.eval()`` play the
JAX package's ``training`` flag: all groups of queries and dropout in
training mode, the first group and no dropout in eval mode.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.models.backbone import BACKBONE_CHANNELS, ResNet50
from monosowa_tpu_torch.models.depth_predictor import DepthPredictor
from monosowa_tpu_torch.models.layers import (MLP, Dropout,
                                              check_compute_dtype, conv,
                                              dense, group_norm,
                                              inverse_sigmoid, layer_dtype)
from monosowa_tpu_torch.models.position_encoding import sine_position_encoding
from monosowa_tpu_torch.models.transformer import (MSDA_BACKENDS,
                                                   DepthAwareDecoderLayer,
                                                   VisualEncoder)

FOCAL_BIAS = -math.log((1 - 0.01) / 0.01)


class BBoxEmbed(nn.Module):
    """3-layer MLP to 6-dof; first clone's final bias[2:] starts at -2
    (monodetr.py:136).  ``layers[i]`` is Flax's ``Dense_i``."""

    def __init__(self, d_model: int, gen: torch.Generator,
                 init_minus_two: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([dense(d_model, d_model, gen),
                                     dense(d_model, d_model, gen),
                                     dense(d_model, 6, gen)])
        if init_minus_two:
            with torch.no_grad():
                self.layers[2].bias[2:] = -2.0

    def forward(self, x):
        x = torch.relu(self.layers[0](x))
        x = torch.relu(self.layers[1](x))
        return self.layers[2](x)


def _normal(shape, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, 1.0, generator=gen))


class MonoDETR(nn.Module):
    def __init__(self, num_classes: int = 3, num_queries: int = 50,
                 group_num: int = 11, d_model: int = 256, d_ffn: int = 256,
                 nheads: int = 8, enc_layers: int = 3, dec_layers: int = 3,
                 num_feature_levels: int = 4, enc_n_points: int = 4,
                 dec_n_points: int = 4, num_depth_bins: int = 80,
                 depth_min: float = 1e-3, depth_max: float = 60.0,
                 msda_backend: str = "auto", dropout: float = 0.1,
                 two_stage: bool = False,
                 position_embedding: str = "sine", use_depth: bool = False,
                 use_dab: bool = False, compute_dtype: str = "auto",
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """Weights are drawn on the host from ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default ``cuda``).  A
        ``compute_dtype`` outside ``layers.COMPUTE_DTYPES``, or "float64"
        off the CPU, raises ``ValueError``."""
        super().__init__()
        for flag, on in (("two_stage", two_stage), ("use_dab", use_dab),
                         ("use_depth", use_depth),
                         ("position_embedding='learned'",
                          position_embedding != "sine")):
            if on:
                raise NotImplementedError(
                    f"{flag} is not in the port yet; it serves the shipped "
                    "flags of configs/monodetr_kitti.yaml")
        if num_feature_levels != 4:
            raise NotImplementedError("the port builds 4 feature levels")
        if msda_backend not in MSDA_BACKENDS:
            raise NotImplementedError(f"msda_backend {msda_backend!r}; the "
                                      f"port has {MSDA_BACKENDS}")
        dev = resolve_device(device)
        self.compute_dtype = cd = check_compute_dtype(compute_dtype, dev)
        gen = torch.Generator().manual_seed(seed)

        self.num_classes, self.num_queries = num_classes, num_queries
        self.group_num, self.d_model = group_num, d_model
        self.dec_layers = dec_layers
        self.num_feature_levels = num_feature_levels
        self._pos_cache: Dict[Tuple[int, int, str], torch.Tensor] = {}

        self.backbone = ResNet50(gen, compute_dtype=cd)
        for i, c in enumerate(BACKBONE_CHANNELS):
            self.add_module(f"input_proj{i}",
                            conv(c, d_model, 1, gen, compute_dtype=cd))
        self.input_proj3 = conv(BACKBONE_CHANNELS[-1], d_model, 3, gen,
                                stride=2, padding=1, compute_dtype=cd)
        # Flax's GroupNorm_0..3
        for i in range(num_feature_levels):
            self.add_module(f"input_norm{i}", group_norm(d_model))
        self.level_embed = _normal((num_feature_levels, d_model), gen)
        self.depth_predictor = DepthPredictor(gen, d_model, num_depth_bins,
                                              depth_min, depth_max, cd)
        self.encoder = VisualEncoder(gen, enc_layers, d_model, d_ffn,
                                     num_feature_levels, nheads, enc_n_points,
                                     msda_backend, dropout, cd)
        self.query_embed = _normal((num_queries * group_num, 2 * d_model),
                                   gen)
        self.reference_points = dense(d_model, 2, gen)
        for i in range(dec_layers):
            self.add_module(f"decoder_layer{i}", DepthAwareDecoderLayer(
                gen, d_model, d_ffn, num_feature_levels, nheads,
                dec_n_points, msda_backend, dropout, group_num, cd))
            cls = dense(d_model, num_classes, gen)
            with torch.no_grad():
                cls.bias.fill_(FOCAL_BIAS)
            self.add_module(f"class_embed{i}", cls)
            self.add_module(f"bbox_embed{i}",
                            BBoxEmbed(d_model, gen, init_minus_two=(i == 0)))
            self.add_module(f"dim_embed{i}", MLP(d_model, d_model, 3, 2, gen))
            self.add_module(f"angle_embed{i}",
                            MLP(d_model, d_model, 24, 2, gen))
            self.add_module(f"depth_embed{i}",
                            MLP(d_model, d_model, 2, 2, gen))
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.level_embed.device

    def _sine(self, h: int, w: int, dev: torch.device) -> torch.Tensor:
        """(H, W, d_model) sine embedding, made once per grid size."""
        key: Tuple[int, int, str] = (h, w, str(dev))
        if key not in self._pos_cache:
            self._pos_cache[key] = torch.from_numpy(
                sine_position_encoding(h, w, self.d_model // 2)).to(dev)
        return self._pos_cache[key]

    def forward(self, images: torch.Tensor, calibs: torch.Tensor,
                img_sizes: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """images (B, H, W, 3) normalized; calibs (B, 3, 4) P2; img_sizes
        (B, 2) as (width, height).  Returns the reference's output dict.
        In training mode every dropout draws from ``generator`` (on the
        model's device), or from the device's default generator if None."""
        b = images.shape[0]
        d = self.d_model
        dev = images.device
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator
        # images in the compute dtype (JAX package monodetr.py:108-109)
        images = images.to(layer_dtype(self.compute_dtype, images,
                                       self.level_embed))
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))

        srcs = [getattr(self, f"input_norm{i}")(
                    getattr(self, f"input_proj{i}")(f))
                for i, f in enumerate((c3, c4, c5))]
        srcs.append(self.input_norm3(self.input_proj3(c5)))

        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        pos = [self._sine(h, w, dev) for h, w in spatial_shapes]

        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos_flat = torch.cat(
            [p.reshape(1, -1, d) + self.level_embed[i][None, None, :]
             for i, p in enumerate(pos)], 1).expand(b, -1, -1)

        # ------- depth predictor (stride-16 grid) ----------------------
        depth_logits, depth_embed, weighted_depth, _ = self.depth_predictor(
            srcs[:3], pos[1])
        h16, w16 = spatial_shapes[1]
        depth_embed_seq = depth_embed.reshape(b, h16 * w16, d)

        # ------- encoder ----------------------------------------------
        memory = self.encoder(src_flat, pos_flat, spatial_shapes)

        # ------- queries: all groups in training, else the first -------
        nq = self.num_queries * (self.group_num if self.training else 1)
        qe = self.query_embed[:nq]
        query_pos = qe[None, :, :d].expand(b, -1, -1)
        tgt = qe[None, :, d:].expand(b, -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))   # (B, nq, 2)

        # ------- decoder with iterative refinement ---------------------
        output = tgt
        refs_before, hs = [], []
        for lid in range(self.dec_layers):
            ref_input = ref[:, :, None, :].expand(
                -1, -1, self.num_feature_levels, -1)
            output = getattr(self, f"decoder_layer{lid}")(
                output, query_pos, ref_input, memory, spatial_shapes,
                depth_embed_seq)
            refs_before.append(ref)
            hs.append(output)
            # in-decoder refinement, detached (depthaware_transformer.py:
            # 601-613): layer 0's reference keeps its gradient
            tmp = getattr(self, f"bbox_embed{lid}")(output)
            if ref.shape[-1] == 6:
                ref = torch.sigmoid(tmp + inverse_sigmoid(ref))
            else:
                ref = torch.sigmoid(torch.cat(
                    [tmp[..., :2] + inverse_sigmoid(ref), tmp[..., 2:]], -1))
            ref = ref.detach()

        # ------- per-layer heads (monodetr.py:219-274) ------------------
        outputs = []
        for lid in range(self.dec_layers):
            reference = inverse_sigmoid(refs_before[lid])
            tmp = getattr(self, f"bbox_embed{lid}")(hs[lid])
            if reference.shape[-1] == 6:
                tmp = tmp + reference
            else:
                tmp = torch.cat([tmp[..., :2] + reference, tmp[..., 2:]], -1)
            coord = torch.sigmoid(tmp)                        # (B, nq, 6)
            logits = getattr(self, f"class_embed{lid}")(hs[lid])
            size3d = getattr(self, f"dim_embed{lid}")(hs[lid])
            angle = getattr(self, f"angle_embed{lid}")(hs[lid])
            depth_reg = getattr(self, f"depth_embed{lid}")(hs[lid])

            box2d_h = ((coord[..., 4] + coord[..., 5])
                       * img_sizes[:, 1:2]).clamp(min=1.0)
            depth_geo = size3d[..., 0] / box2d_h * calibs[:, 0, 0][:, None]
            depth_map_s = _sample_depth_map(weighted_depth,
                                            coord[..., :2].detach())
            depth_val = ((1.0 / (torch.sigmoid(depth_reg[..., 0:1]) + 1e-6)
                          - 1.0) + depth_geo[..., None]
                         + depth_map_s[..., None]) / 3.0
            depth = torch.cat([depth_val, depth_reg[..., 1:2]], -1)
            outputs.append({"pred_logits": logits, "pred_boxes": coord,
                            "pred_3d_dim": size3d, "pred_angle": angle,
                            "pred_depth": depth})

        out = dict(outputs[-1])
        out["pred_depth_map_logits"] = depth_logits
        out["aux_outputs"] = outputs[:-1]
        out["weighted_depth"] = weighted_depth
        return out


def _sample_depth_map(depth_map: torch.Tensor, centers: torch.Tensor
                      ) -> torch.Tensor:
    """Bilinear sample (B, H, W) at normalized centers (B, Q, 2) in [0, 1]
    with grid_sample align_corners=True semantics and clamped indices
    (monodetr.py:251-257 uses grid (2c-1), align_corners=True)."""
    bsz, h, w = depth_map.shape
    x = centers[..., 0] * (w - 1)
    y = centers[..., 1] * (h - 1)
    x0 = torch.floor(x).clamp(0, w - 1)
    y0 = torch.floor(y).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    dx = (x - x0).clamp(0.0, 1.0)
    dy = (y - y0).clamp(0.0, 1.0)
    flat = depth_map.reshape(bsz, h * w)

    def take(yc, xc):
        return torch.gather(flat, 1, (yc * w + xc).long())

    v00 = take(y0, x0)
    v01 = take(y0, x1)
    v10 = take(y1, x0)
    v11 = take(y1, x1)
    return (v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy)
            + v10 * (1 - dx) * dy + v11 * dx * dy)


def build_monodetr(cfg: Dict[str, Any],
                   device: Union[str, torch.device, None] = None,
                   seed: int = 0) -> MonoDETR:
    """Construct from a reference-style model config dict
    (configs/monodetr_kitti.yaml model section).  Flags the port does not
    carry (``use_dn``, ``two_stage``, ``use_dab``, ``use_depth``, learned
    position embedding, no box refinement) raise ``NotImplementedError``."""
    for flag, shipped in (("use_dn", False), ("with_box_refine", True)):
        if bool(cfg.get(flag, shipped)) != shipped:
            raise NotImplementedError(
                f"{flag}={cfg.get(flag)} is not in the port yet")
    return MonoDETR(
        num_classes=cfg.get("num_classes", 3),
        num_queries=cfg.get("num_queries", 50),
        group_num=11,
        d_model=cfg.get("hidden_dim", 256),
        d_ffn=cfg.get("dim_feedforward", 256),
        nheads=cfg.get("nheads", 8),
        enc_layers=cfg.get("enc_layers", 3),
        dec_layers=cfg.get("dec_layers", 3),
        num_feature_levels=cfg.get("num_feature_levels", 4),
        enc_n_points=cfg.get("enc_n_points", 4),
        dec_n_points=cfg.get("dec_n_points", 4),
        num_depth_bins=cfg.get("num_depth_bins", 80),
        depth_min=float(cfg.get("depth_min", 1e-3)),
        depth_max=float(cfg.get("depth_max", 60.0)),
        msda_backend=cfg.get("msda_backend", "auto"),
        dropout=cfg.get("dropout", 0.1),
        two_stage=bool(cfg.get("two_stage", False)),
        position_embedding=cfg.get("position_embedding", "sine"),
        use_depth=bool(cfg.get("use_depth", False)),
        use_dab=bool(cfg.get("use_dab", False)),
        compute_dtype=str(cfg.get("compute_dtype", "auto")),
        device=device, seed=seed)
