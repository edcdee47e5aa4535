"""Traffic driver ``mask_frames``: the labeller's mask stage, frames one
after another through the port's ``sowa/masks.py``
``Mask2FormerBackend.predict_masks_multi`` with the label groups that
``sowa/cli.py`` ``_masks_frame`` asks for (the car labels and the person
label from one forward).  A frame is done when its kept masks are on the
host, as ``save_masks`` would be given them; the compressed write is not
part of the window.

Set-up builds the backend on the card, fills the network with the seed's
weights, draws ``distinct_frames`` frames of ``frame_hw`` from the seed,
raises the car label's class bias so that the first ``bias_frames`` frames
keep ``kept_cars_per_frame`` car masks a frame on average (``car_bias``),
and runs ``warm_frames`` of them.  The window cycles through the
frames.  A sample of the frames the window finishes, drawn from the seed,
keeps the network's class and mask logits, the attention masks its decoder
used and the kept masks for the check against the plain reference.  The
reference picks its own car bias from its own forwards of the bias
frames; there, as on the sampled frames, its decoder takes the attention
masks the program's used (kept on the host from set-up), since a
last-bit flip of one would carry through every later layer, and
``att_gap`` judges those masks against the reference's own decisions.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import bench_flops as bf
from bench_harness import Spans, seeded_frame
from bench_weights import float_shapes, load_into, seeded_state, sub_seed


def port_config(config: Dict[str, Any]):
    from monosowa_tpu_torch.models.mask2former import Mask2FormerConfig
    from monosowa_tpu_torch.models.swin import SwinConfig

    bb = dict(config["backbone"])
    for k in ("depths", "num_heads", "out_indices"):
        bb[k] = tuple(bb[k])
    keys = Mask2FormerConfig.__dataclass_fields__
    rest = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in config.items() if k in keys and k != "backbone"}
    return Mask2FormerConfig(backbone=SwinConfig(**bb), **rest)


class Cell:
    """One run of a ``mask_frames`` cell."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, dev: torch.device, trace: bool, reference,
                 fault: Optional[str] = None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.dev, self.trace, self.ref = dev, trace, reference
        self.fault = fault
        self.spans = Spans()
        self.units = self.attempted = self.failed = 0
        self.kept: List[int] = []

    def setup(self) -> None:
        from monosowa_tpu_torch.convert import zoo_params
        from monosowa_tpu_torch.models.mask2former import Mask2Former
        from monosowa_tpu_torch.sowa.masks import Mask2FormerBackend

        cfg, tr = self.config, self.traffic
        marks = [("start", time.time())]
        pcfg = port_config(cfg)
        tree = zoo_params(Mask2Former(pcfg, device="cpu"))
        self.backend = Mask2FormerBackend(
            tree, pcfg, car_label_ids=tuple(cfg["car_label_ids"]),
            score_threshold=float(cfg["score_threshold"]),
            input_hw=tuple(cfg["input_hw"]), device=self.dev)
        del tree
        model = self.backend.model
        self.shapes = float_shapes(model.state_dict())
        self.weight_seed = sub_seed(self.seed, 5)
        load_into(model, seeded_state(self.shapes, self.weight_seed,
                                      self.dev, cfg.get("table_std")))
        marks.append(("build", time.time()))
        self.groups = [tuple(cfg["car_label_ids"]),
                       tuple(cfg["person_label_ids"])]
        h, w = tr["frame_hw"]
        self.frame_seeds = [sub_seed(self.seed, 1, i)
                            for i in range(int(tr["distinct_frames"]))]
        self.frames = [seeded_frame(s, h, w, int(tr["image_block"]))
                       for s in self.frame_seeds]
        rng = np.random.default_rng(sub_seed(self.seed, 2))
        self.sample = set(rng.choice(int(tr["check_within"]),
                                     int(tr["check_frames"]),
                                     replace=False).tolist())
        self.captured: Dict[int, Dict[str, Any]] = {}
        self._capture = None
        model.register_forward_hook(self._hook)
        model.transformer.mask_predictor.register_forward_hook(self._att_hook)
        # the bias frames' attention masks are kept on the host for the
        # check: the reference's forwards of these frames take them
        needs, self.bias_att = [], []
        for img in self.frames[:int(cfg["bias_frames"])]:
            self._capture = {}
            self.backend.forward(img)
            needs.append(car_needs(self._capture["classes"],
                                   cfg["car_label_ids"],
                                   float(cfg["score_threshold"])))
            self.bias_att.append([a.cpu() for a in self._capture["att"]])
        self._capture = None
        self.car_bias = pick_bias(needs, int(cfg["kept_cars_per_frame"]))
        with torch.no_grad():
            model.transformer.class_predictor.bias[
                list(cfg["car_label_ids"])] += self.car_bias
        marks.append(("bias", time.time()))
        for i in range(int(tr["warm_frames"])):
            self.backend.predict_masks_multi(self.frames[i], self.groups)
        self.n = 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        marks.append(("warm", time.time()))
        self.setup_phases = {b[0]: b[1] - a[1]
                             for a, b in zip(marks[:-1], marks[1:])}

    def _hook(self, module, inputs, out):
        if self.fault == "altered":
            out[1].add_(1e-2 * out[1].abs().max())
        if self._capture is not None:
            self._capture["classes"] = out[0][0].detach().clone()
            self._capture["masks"] = out[1][0].detach().clone()

    def _att_hook(self, module, inputs, out):
        if self.fault == "inverted_attention":
            out = (out[0], ~out[1])
        if self._capture is not None:
            self._capture.setdefault("att", []).append(out[1].clone())
        return out

    def step(self) -> None:
        k = self.n
        img = self.frames[k % len(self.frames)]
        self._capture = {} if k in self.sample else None
        t0 = time.time()
        with torch.profiler.record_function("bench.predict_masks_multi"):
            out = self.backend.predict_masks_multi(img, self.groups)
        self.spans.add("frame", time.time() - t0)
        if self._capture is not None:
            self._capture["out"] = out
            self._capture["frame"] = k % len(self.frames)
            self.captured[k] = self._capture
            self._capture = None
        self.kept.append(len(out[0][0]))
        self.attempted += 1
        self.units += 1
        self.n += 1

    def close_window(self) -> None:
        pass

    def counts(self) -> Dict[str, Any]:
        h, w = self.config["input_hw"]
        f = bf.mask2former_frame(self.config, int(h) // 32 * 32,
                                 int(w) // 32 * 32)
        return {"frame_flops": f["gemm"] + f["msda"],
                "msda_calls": f["msda_calls"],
                "kept_cars_mean": float(np.mean(self.kept))
                if self.kept else 0.0, "car_bias": self.car_bias}

    def check(self, limits: Dict[str, float]):
        """Each sampled frame's class and mask logits, the attention masks
        its decoder used and its kept masks against the reference's on the
        same frame and weights, and the attention masks of the bias frames
        too.  The reference picks its own car bias from its own forwards
        of the first ``bias_frames`` frames."""
        del self.backend
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg = self.config
        margin = float(cfg["att_margin"])
        missing = sorted(self.sample - set(self.captured))
        ref_bias, bias_ref = reference_bias(
            self.ref, cfg, self.shapes, self.weight_seed, self.dev,
            self.frames[:int(cfg["bias_frames"])], forced=self.bias_att)
        ref = self.ref.mask_reference(
            cfg, self.shapes, self.weight_seed, ref_bias, self.dev,
            [self.frames[c["frame"]] for c in self.captured.values()],
            self.groups, forced=[c["att"] for c in self.captured.values()])
        numbers = compare_frames(list(self.captured.values()), ref, margin)
        numbers["att_gap"] = max(numbers["att_gap"], attention_gap(
            self.bias_att, [r["own_att_logit"] for r in bias_ref], margin))
        self.diagnostics = {
            "attention_flips": attention_flips(
                list(self.captured.values()), ref),
            "car_bias": self.car_bias, "car_bias_ref": ref_bias,
            "kept_prog": [[len(m) for m, _ in c["out"]]
                          for c in self.captured.values()],
            "kept_ref": [[len(m) for m, _ in r["out"]] for r in ref]}
        if missing:
            numbers["frames_missing"] = float(len(missing))
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()}
        correct = bool(self.captured) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in checks.values())
        return correct, checks


def car_needs(classes: torch.Tensor, car_ids, threshold: float
              ) -> torch.Tensor:
    """Per query, the car-label bias at which its car probability (of the
    softmax over every label and the null class) reaches ``threshold``."""
    lg = classes.double()
    car = torch.zeros(lg.shape[1], dtype=torch.bool, device=lg.device)
    car[list(car_ids)] = True
    need = math.log(threshold / (1 - threshold)) \
        + torch.logsumexp(lg[:, ~car], 1) - lg[:, car].max(1).values
    return need.cpu()


def pick_bias(needs: List[torch.Tensor], per_frame: int) -> float:
    """The bias at which the frames keep ``per_frame`` queries a frame on
    average: just above that many of the queries' needs."""
    allv = torch.sort(torch.cat(needs)).values
    k = per_frame * len(needs)
    return float((allv[k - 1] + allv[k]) / 2)


def reference_bias(ref, config: Dict[str, Any], shapes, weight_seed: int,
                   dev, frames, forced=None, tf32: bool = False):
    """The car bias picked, as set-up picks the program's, from the
    reference's own class logits of ``frames`` (its decoder taking the
    attention masks ``forced``, as in ``mask_reference``), and the
    reference's forwards of them (``class_logits``)."""
    outs = ref.class_logits(config, shapes, weight_seed, dev, frames,
                            tf32=tf32, forced=forced)
    needs = [car_needs(o["classes"], config["car_label_ids"],
                       float(config["score_threshold"])) for o in outs]
    return pick_bias(needs, int(config["kept_cars_per_frame"])), outs


def attention_gap(used: List[List[torch.Tensor]],
                  logits: List[List[torch.Tensor]], margin: float) -> float:
    """The worst share, over frames and decoder layers, of the attention
    mask entries that a forward ``used`` set otherwise than the
    reference's own resized mask logit decides (masked where it is below
    0), where that logit lies more than ``margin`` of the layer's largest
    magnitude from 0."""
    worst = 0.0
    for frame_used, frame_logits in zip(used, logits):
        for u, logit in zip(frame_used, frame_logits):
            b, q, n = logit.shape
            u = u.to(logit.device).reshape(b, -1, q, n)
            clear = logit.abs() > margin * logit.abs().max()
            off = (u != (logit < 0)[:, None]) & clear[:, None]
            worst = max(worst, float(off.float().mean()))
    return worst


def compare_frames(prog: List[Dict[str, Any]], ref: List[Dict[str, Any]],
                   att_margin: float) -> Dict[str, float]:
    """The widest gap over the frames of the class logits and of the mask
    logits, each against the reference's largest magnitude on the frame;
    the reference's decoder takes the attention masks the program's used
    (the decoder binarises them at a logit of 0, so a last-bit difference
    flips an entry that every later layer inherits; each layer's mask
    logits, compared at the last, are what decide them).  And, of the
    program's kept masks, the
    pixels by which their count map (how many kept masks cover each pixel,
    per label group) leaves the reference's bounds (``frame_masks``), as a
    share of the pixels of the reference's clearly kept masks.  And, since
    the reference's decoder takes the program's attention masks, how far
    those depart from the reference's own decisions (``attention_gap``)."""
    cls_gap = mask_gap = kept_gap = 0.0
    att_gap = attention_gap([p["att"] for p in prog],
                            [r["own_att_logit"] for r in ref], att_margin)
    for p, r in zip(prog, ref):
        rc, rm = r["classes"], r["masks"]
        cls_gap = max(cls_gap, float((p["classes"].to(rc.device) - rc)
                                     .abs().max() / rc.abs().max()))
        mask_gap = max(mask_gap, float((p["masks"].to(rm.device) - rm)
                                       .abs().max() / rm.abs().max()))
        off = total = 0
        for (masks, _), (strict, loose) in zip(p["out"], r["bounds"]):
            count = np.zeros(strict.shape, np.int32)
            for m in masks:
                count += m
            off += int(np.maximum(strict - count, 0).sum()
                       + np.maximum(count - loose, 0).sum())
            total += int(strict.sum())
        kept_gap = max(kept_gap, off / max(total, 1))
    return {"class_gap": cls_gap, "mask_gap": mask_gap,
            "kept_gap": kept_gap, "att_gap": att_gap}


def attention_flips(prog: List[Dict[str, Any]], ref: List[Dict[str, Any]]
                    ) -> int:
    """How many attention-mask entries the reference's own decisions would
    have set otherwise, over the frames, those near a logit of 0 included
    (diagnostic)."""
    return sum(int((a.to(b.device) != b).sum())
               for p, r in zip(prog, ref)
               for a, b in zip(p["att"], r["own_att"]))


def controls(bench, cell, seed: int, dev, config: Dict[str, Any],
             traffic: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's numbers for the control, on the frames a run of ``seed``
    samples: the reference in TF32 in the program's place, its car bias
    picked from its own TF32 forwards, against the float32 reference,
    which picks its own and takes the TF32 forwards' attention masks as it
    takes the program's."""
    ref = bench.reference(cell["config"])
    from monosowa_tpu_torch.models.mask2former import Mask2Former

    shapes = float_shapes(Mask2Former(port_config(config),
                                      device="cpu").state_dict())
    h, w = traffic["frame_hw"]
    block = int(traffic["image_block"])
    rng = np.random.default_rng(sub_seed(seed, 2))
    picks = rng.choice(int(traffic["check_within"]),
                       int(traffic["check_frames"]), replace=False)
    n = int(traffic["distinct_frames"])
    frames = [seeded_frame(sub_seed(seed, 1, int(k) % n), h, w, block)
              for k in picks]
    groups = [tuple(config["car_label_ids"]),
              tuple(config["person_label_ids"])]
    wseed = sub_seed(seed, 5)
    warm = [seeded_frame(sub_seed(seed, 1, k), h, w, block)
            for k in range(int(config["bias_frames"]))]
    margin = float(config["att_margin"])
    bias32, warm32 = reference_bias(ref, config, shapes, wseed, dev, warm,
                                    tf32=True)
    warm_att = [o["att"] for o in warm32]
    bias, warm_ref = reference_bias(ref, config, shapes, wseed, dev, warm,
                                    forced=warm_att)
    other = ref.mask_reference(config, shapes, wseed, bias32, dev, frames,
                               groups, tf32=True)
    base = ref.mask_reference(config, shapes, wseed, bias, dev, frames,
                              groups, forced=[o["att"] for o in other])
    prog = [{"classes": o["classes"], "masks": o["masks"], "out": o["out"],
             "att": o["att"]} for o in other]
    numbers = compare_frames(prog, base, margin)
    numbers["att_gap"] = max(numbers["att_gap"], attention_gap(
        warm_att, [o["own_att_logit"] for o in warm_ref], margin))
    kept = [len(o["out"][0][0]) for o in base]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"tf32": numbers, "kept_cars": kept, "car_bias": [bias32, bias]}
