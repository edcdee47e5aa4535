"""MonoDETR-equivalent monocular 3D detector (torch).

Behavioral contract (MonoDETR/lib/models/monodetr/monodetr.py:34-299; the
JAX package's ``models/monodetr.py``):

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

The variants the JAX package reads from the yaml (its monodetr.py:159-253):

* ``two_stage``: every encoder token proposes a 6-dof box; the top-k of
  the class-0 scores (k = 550 in training, 50 in eval) seed the decoder's
  queries and reference points, and the proposals' heads come out as
  ``enc_outputs``;
* ``use_dab``: learned content embeddings and 6-dof anchor boxes, the query
  positions re-derived in every decoder layer from the current anchors;
* ``position_embedding: learned``: ``LearnedPositionEmbedding`` in place of
  the sine table;
* ``use_depth``: the RGB-D stem (4-channel images);
* DN-DETR queries (``forward(..., dn_queries=)`` in training, with
  ``use_dn`` at construction for the label table): noised ground-truth
  copies prepended to the queries under a block attention mask, their
  heads split off into ``dn_outputs``.

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

import numpy as np
import torch
from torch import nn

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.models.backbone import BACKBONE_CHANNELS, ResNet50
from monosowa_tpu_torch.models.depth_predictor import DepthPredictor
from monosowa_tpu_torch.models.dn_components import (DNQueries,
                                                     build_joint_attn_mask)
from monosowa_tpu_torch.models.layers import (MLP, Dropout,
                                              check_compute_dtype, conv,
                                              dense, group_norm,
                                              inverse_sigmoid, layer_dtype)
from monosowa_tpu_torch.models.position_encoding import (
    LearnedPositionEmbedding, sine_position_encoding)
from monosowa_tpu_torch.models.transformer import (DepthAwareDecoderLayer,
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


def _class_head(d_model: int, num_classes: int, gen: torch.Generator):
    """Class logits whose bias starts at the focal prior of 0.01."""
    cls = dense(d_model, num_classes, gen)
    with torch.no_grad():
        cls.bias.fill_(FOCAL_BIAS)
    return cls


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
                 use_dab: bool = False, use_dn: bool = False,
                 compute_dtype: str = "auto",
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        """Weights are drawn on the host from ``torch.Generator`` seeded
        with ``seed``, then moved to ``device`` (default ``cuda``).  A
        ``compute_dtype`` outside ``layers.COMPUTE_DTYPES``, or "float64"
        off the CPU, raises ``ValueError``.  ``use_dn`` adds the DN-DETR
        label table ``label_enc`` that ``forward(..., dn_queries=)`` needs
        (the JAX package makes it at the first call with DN queries)."""
        super().__init__()
        if num_feature_levels != 4:
            raise NotImplementedError(
                "the port builds 4 feature levels, as the JAX model does "
                "(C3, C4, C5 and one stride-64 level)")
        if position_embedding not in ("sine", "learned"):
            raise ValueError(f"position_embedding {position_embedding!r}: "
                             "want 'sine' or 'learned'")
        dev = resolve_device(device)
        self.compute_dtype = cd = check_compute_dtype(compute_dtype, dev)
        gen = torch.Generator().manual_seed(seed)

        self.num_classes, self.num_queries = num_classes, num_queries
        self.group_num, self.d_model = group_num, d_model
        self.dec_layers = dec_layers
        self.num_feature_levels = num_feature_levels
        self.two_stage, self.use_dab = two_stage, use_dab
        self._consts: Dict[Tuple, torch.Tensor] = {}

        self.backbone = ResNet50(gen, compute_dtype=cd, depth_input=use_depth)
        for i, c in enumerate(BACKBONE_CHANNELS):
            self.add_module(f"input_proj{i}",
                            conv(c, d_model, 1, gen, compute_dtype=cd))
        self.input_proj3 = conv(BACKBONE_CHANNELS[-1], d_model, 3, gen,
                                stride=2, padding=1, compute_dtype=cd)
        # Flax's GroupNorm_0..3
        for i in range(num_feature_levels):
            self.add_module(f"input_norm{i}", group_norm(d_model))
        self.position_embedding = (
            LearnedPositionEmbedding(gen, d_model // 2)
            if position_embedding == "learned" else None)
        self.level_embed = _normal((num_feature_levels, d_model), gen)
        self.depth_predictor = DepthPredictor(gen, d_model, num_depth_bins,
                                              depth_min, depth_max, cd)
        self.encoder = VisualEncoder(gen, enc_layers, d_model, d_ffn,
                                     num_feature_levels, nheads, enc_n_points,
                                     msda_backend, dropout, cd)
        n_table = num_queries * group_num
        if two_stage:
            self.enc_output = dense(d_model, d_model, gen)
            self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)
            self.enc_class = _class_head(d_model, num_classes, gen)
            self.enc_bbox = BBoxEmbed(d_model, gen)
            self.pos_trans = dense(2 * d_model, 2 * d_model, gen)
            self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=1e-5)
        elif use_dab:
            self.tgt_embed = _normal((n_table, d_model), gen)
            self.refpoint_embed = _normal((n_table, 6), gen)
        else:
            self.query_embed = _normal((n_table, 2 * d_model), gen)
            self.reference_points = dense(d_model, 2, gen)
        if use_dn:
            self.label_enc = _normal((num_classes + 1, d_model - 1), gen)
        for i in range(dec_layers):
            self.add_module(f"decoder_layer{i}", DepthAwareDecoderLayer(
                gen, d_model, d_ffn, num_feature_levels, nheads,
                dec_n_points, msda_backend, dropout, group_num, cd))
            self.add_module(f"class_embed{i}",
                            _class_head(d_model, num_classes, gen))
            self.add_module(f"bbox_embed{i}",
                            BBoxEmbed(d_model, gen, init_minus_two=(i == 0)))
            self.add_module(f"dim_embed{i}", MLP(d_model, d_model, 3, 2, gen))
            self.add_module(f"angle_embed{i}",
                            MLP(d_model, d_model, 24, 2, gen))
            self.add_module(f"depth_embed{i}",
                            MLP(d_model, d_model, 2, 2, gen))
        if use_dab:
            # decoder-level heads shared by the layers
            # (depthaware_transformer.py:530-533)
            self.dab_ref_point_head = MLP(3 * d_model, d_model, d_model, 2,
                                          gen)
            self.dab_query_scale = MLP(d_model, d_model, d_model, 2, gen)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.level_embed.device

    def _const(self, key: Tuple, make) -> torch.Tensor:
        """A constant of the forward (a sine table, the proposals), made
        once per key from numpy and kept on the key's device."""
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(make()).to(key[-1])
        return self._consts[key]

    def _positions(self, spatial_shapes, dev):
        """Each level's (H, W, d_model) position embedding."""
        if self.position_embedding is not None:
            return [self.position_embedding(h, w) for h, w in spatial_shapes]
        return [self._const(("sine", h, w, str(dev)),
                            lambda h=h, w=w: sine_position_encoding(
                                h, w, self.d_model // 2))
                for h, w in spatial_shapes]

    def _two_stage_queries(self, memory, spatial_shapes, nq: int):
        """(query_pos, tgt, ref, enc_outputs) from the encoder's proposals
        (depthaware_transformer.py:234-257; the JAX package's
        monodetr.py:159-193), the top-k by ``top_k_indices``."""
        b, d = memory.shape[0], self.d_model
        dev = memory.device
        proposals = self._const(("proposals", spatial_shapes, str(dev)),
                                lambda: encoder_proposals(spatial_shapes))
        enc_mem = self.enc_output_norm(self.enc_output(memory))
        enc_logits = self.enc_class(enc_mem)
        enc_unact = self.enc_bbox(enc_mem) + inverse_sigmoid(proposals)[None]
        enc_outputs = {"pred_logits": enc_logits,
                       "pred_boxes": torch.sigmoid(enc_unact)}
        k = min(nq, enc_logits.shape[1])
        top_idx = top_k_indices(enc_logits[..., 0], k)            # (B, k)
        top_unact = torch.gather(enc_unact, 1, top_idx[..., None].expand(
            -1, -1, 6)).detach()                                  # (B, k, 6)
        ref = torch.sigmoid(top_unact)
        pos4 = torch.cat([top_unact[..., :2],
                          top_unact[..., 2:3] + top_unact[..., 3:4],
                          top_unact[..., 4:5] + top_unact[..., 5:6]], -1)
        trans = self.pos_trans_norm(self.pos_trans(
            proposal_pos_embed(pos4, d // 2)))
        query_pos, tgt = trans[..., :d], trans[..., d:]
        if k < nq:
            pad = trans.new_zeros(b, nq - k, d)
            query_pos = torch.cat([query_pos, pad], 1)
            tgt = torch.cat([tgt, pad], 1)
            ref = torch.cat([ref, ref.new_full((b, nq - k, 6), 0.5)], 1)
        return query_pos, tgt, ref, enc_outputs

    def forward(self, images: torch.Tensor, calibs: torch.Tensor,
                img_sizes: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dn_queries: Optional[DNQueries] = None,
                batch_shard: Optional[Tuple[int, int]] = None
                ) -> Dict[str, Any]:
        """images (B, H, W, 3) normalized (4 channels with use_depth);
        calibs (B, 3, 4) P2; img_sizes (B, 2) as (width, height).  Returns
        the reference's output dict (with ``enc_outputs`` under two_stage,
        ``dn_outputs`` with DN queries).  In training mode every dropout
        draws from ``generator`` (on the model's device), or from the
        device's default generator if None; ``dn_queries``
        (``dn_components.prepare_dn``) are used in training mode only, as
        in the JAX package.  ``batch_shard`` (rank, n): the images are
        rank's slice of a batch n times as large, and each dropout keeps
        that slice of the whole batch's draws (data parallelism,
        ``parallel.dist``)."""
        b = images.shape[0]
        d = self.d_model
        dev = images.device
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator
                mod.batch_shard = batch_shard
        # images in the compute dtype (JAX package monodetr.py:108-109)
        images = images.to(layer_dtype(self.compute_dtype, images,
                                       self.level_embed))
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))

        srcs = [getattr(self, f"input_norm{i}")(
                    getattr(self, f"input_proj{i}")(f))
                for i, f in enumerate((c3, c4, c5))]
        srcs.append(self.input_norm3(self.input_proj3(c5)))

        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        pos = self._positions(spatial_shapes, dev)

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
        enc_outputs = None
        if self.two_stage:
            query_pos, tgt, ref, enc_outputs = self._two_stage_queries(
                memory, spatial_shapes, nq)
        elif self.use_dab:
            # DAB-DETR: content embeddings and 6-dof anchors; query_pos is
            # re-derived in every decoder layer from the current anchors
            tgt = self.tgt_embed[None, :nq].expand(b, -1, -1)
            ref = torch.sigmoid(self.refpoint_embed[None, :nq]).expand(
                b, -1, -1)
            query_pos = tgt.new_zeros(b, nq, d)
        else:
            qe = self.query_embed[:nq]
            query_pos = qe[None, :, :d].expand(b, -1, -1)
            tgt = qe[None, :, d:].expand(b, -1, -1)
            ref = torch.sigmoid(self.reference_points(query_pos))  # (B,nq,2)

        # ------- DN-DETR denoising queries, prepended -----------------
        num_dn = 0
        self_attn_mask = None
        if dn_queries is not None and self.training:
            num_dn = dn_queries.num_dn
            dn_emb = self.label_enc[dn_queries.label_ids.long()]  # (B,N,d-1)
            dn_tgt = torch.cat([dn_emb, dn_emb.new_ones(
                dn_emb.shape[:-1] + (1,))], -1)
            # matchable queries carry a zero indicator in their last channel
            tgt = torch.cat([dn_tgt, torch.cat(
                [tgt[..., :-1], tgt.new_zeros(tgt.shape[:-1] + (1,))], -1)],
                1)
            query_pos = torch.cat([torch.zeros_like(dn_tgt), query_pos], 1)
            # 6-dof refs everywhere: matchable edges start at sigmoid(-2)
            if ref.shape[-1] == 2:
                edge = float(torch.sigmoid(torch.tensor(-2.0)))
                ref = torch.cat([ref, ref.new_full(ref.shape[:-1] + (4,),
                                                   edge)], -1)
            ref = torch.cat([dn_queries.refpoints.to(ref.dtype), ref], 1)
            groups = dn_queries.num_groups
            self_attn_mask = build_joint_attn_mask(
                groups, num_dn // groups, self.group_num, self.num_queries,
                dev)

        # ------- decoder with iterative refinement ---------------------
        output = tgt
        refs_before, hs = [], []
        for lid in range(self.dec_layers):
            if self.use_dab:
                raw_qp = self.dab_ref_point_head(
                    dab_sine_embed(ref, d // 2))
                query_pos = (raw_qp if lid == 0
                             else self.dab_query_scale(output) * raw_qp)
            ref_input = ref[:, :, None, :].expand(
                -1, -1, self.num_feature_levels, -1)
            output = getattr(self, f"decoder_layer{lid}")(
                output, query_pos, ref_input, memory, spatial_shapes,
                depth_embed_seq, self_attn_mask)
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

        dn_outputs = None
        if num_dn:
            # split the denoising slots off every layer's outputs
            dn_outputs = [{k: o[k][:, :num_dn] for k in
                           ("pred_logits", "pred_boxes")} for o in outputs]
            outputs = [{k: v[:, num_dn:] for k, v in o.items()}
                       for o in outputs]

        out = dict(outputs[-1])
        out["pred_depth_map_logits"] = depth_logits
        out["aux_outputs"] = outputs[:-1]
        out["weighted_depth"] = weighted_depth
        if dn_outputs is not None:
            out["dn_outputs"] = dn_outputs
        if enc_outputs is not None:
            out["enc_outputs"] = enc_outputs
        return out


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S) float32 or float64 -> (B, k) indices of the k largest scores
    in descending order as ``jax.lax.top_k`` orders them: by the floats'
    total order (+0.0 above -0.0), the lower index first among equal
    scores.  A stable descending sort of the scores' bits, read as signed
    integers with a negative float's magnitude bits flipped, cut to k
    (``torch.topk`` promises no order on ties)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    bits = scores.contiguous().view(ints[scores.dtype])
    key = torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)
    return torch.sort(key, dim=1, descending=True,
                      stable=True).indices[:, :k]


def encoder_proposals(spatial_shapes) -> np.ndarray:
    """(S, 6) float32 per-token 6-dof proposals: grid centers +
    0.05 * 2^lvl half-extents, clipped to [0.01, 0.99]
    (gen_encoder_output_proposals semantics; the JAX package's
    ``_encoder_proposals``)."""
    rows = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        half = 0.05 * (2.0 ** lvl) / 2.0
        n = h * w
        rows.append(np.stack(
            [gx.reshape(-1), gy.reshape(-1)] + [np.full(n, half)] * 4, -1))
    prop = np.concatenate(rows, 0).astype(np.float32)
    return np.clip(prop, 0.01, 0.99)


def _dim_t(num_feats: int, temperature: float, dev) -> torch.Tensor:
    i = torch.arange(num_feats, device=dev) // 2
    return temperature ** (2 * i / num_feats)


def _sine(coord: torch.Tensor, dim_t: torch.Tensor) -> torch.Tensor:
    """(...) -> (..., F): sin on the even, cos on the odd channels of
    coord * 2pi / dim_t."""
    p = coord[..., None] * (2 * math.pi) / dim_t
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       -1).reshape(coord.shape + (dim_t.shape[0],))


def dab_sine_embed(ref6: torch.Tensor, num_feats: int = 128,
                   temperature: float = 10000.0) -> torch.Tensor:
    """(B, Q, 6) anchors in [0,1] -> (B, Q, 6*num_feats) sine embedding in
    the reference's [y, x, l, r, t, b] channel order
    (gen_sineembed_for_position, depthaware_transformer.py:29-65)."""
    dim_t = _dim_t(num_feats, temperature, ref6.device)
    order = (1, 0, 2, 3, 4, 5)
    return torch.cat([_sine(ref6[..., i], dim_t) for i in order], -1)


def proposal_pos_embed(pos4: torch.Tensor, num_feats: int = 128,
                       temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of 4-dof proposals -> (..., 4 * num_feats)
    (get_proposal_pos_embed)."""
    dim_t = _dim_t(num_feats, temperature, pos4.device)
    return _sine(pos4, dim_t).reshape(pos4.shape[:-1] + (4 * num_feats,))


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
    (configs/monodetr_kitti.yaml model section), reading the keys the JAX
    package's ``build_monodetr`` reads.  Two keys that the JAX
    ``build_monodetr`` ignores raise ``NotImplementedError`` here at their
    unshipped values: ``use_dn: True`` (no trainer builds DN queries) and
    ``with_box_refine: False`` (both packages always refine).  A caller
    that builds DN queries itself constructs ``MonoDETR(use_dn=True)``, as
    the JAX package's tests/test_dn_wiring.py constructs its model."""
    for flag, shipped in (("use_dn", False), ("with_box_refine", True)):
        if bool(cfg.get(flag, shipped)) != shipped:
            raise NotImplementedError(
                f"{flag}={cfg.get(flag)}: the JAX package's build_monodetr "
                "ignores it and its trainer never runs it")
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
