"""Where the model zoo's networks spend their time on one GPU.

Builds Mask2Former on Swin-B, Depth Anything Large and, with ``--sam``,
SAM ViT-H at full width (seeded random weights, TF32 off) on ``cuda``,
through their backends (``sowa/masks.py`` ``Mask2FormerBackend`` and
``SamRefineBackend``, ``sowa/depth.py`` ``DepthAnythingBackend``), warms
up, then for one seeded 375x1242 frame each:

* times each stage with CUDA events from forward hooks (Mask2Former: the
  Swin trunk, the pixel decoder and each of its encoder layers, the
  masked-attention decoder; Depth Anything: each DINOv2 layer, each
  reassemble and each fusion layer; SAM: the patch embedding, each of the
  32 encoder layers, the neck, and the prompt encoder and mask decoder of
  ``refine`` on 16 boxes, one decoder chunk);
* traces the backend's whole call (encode, forward, post-processing) with
  ``torch.profiler`` and sums device time by kernel name, with the
  device's busy share of the call's wall time.

Prints one JSON line per part, after the card's name and power limit;
SAM's adds its encoder's operations and bound (``chip_smoke.
sam_encoder_work``).

    python tools/profile_torch_zoo.py [--only masks|depth | --sam]
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stage_events(model, names):
    """CUDA events before and after each named submodule's forward."""
    import torch

    events, handles = {}, []
    for name in names:
        mod = model.get_submodule(name)

        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = [ev]

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append(ev)

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return events, handles


def profile(label, backend, call, stages) -> None:
    import torch

    import chip_smoke

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    events, handles = stage_events(backend.model, stages)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    for hd in handles:
        hd.remove()
    print(json.dumps({"part": f"{label}_stages_ms",
                      "call_ms": start.elapsed_time(end), **{
                          n: events[n][0].elapsed_time(events[n][1])
                          for n in stages}}), flush=True)
    torch.cuda.reset_peak_memory_stats()
    res = chip_smoke.busy_share(call, top=15)
    print(json.dumps({"part": f"{label}_kernels", **res, "peak_mem_GB":
                      torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--only", choices=["masks", "depth"], default=None)
    which.add_argument("--sam", action="store_true",
                       help="SAM ViT-H alone")
    args = parser.parse_args()
    import torch

    import chip_smoke
    from monosowa_tpu_torch.convert import zoo_params
    from monosowa_tpu_torch.models.depth_anything import DepthAnything
    from monosowa_tpu_torch.models.mask2former import Mask2Former
    from monosowa_tpu_torch.sowa.depth import DepthAnythingBackend
    from monosowa_tpu_torch.sowa.masks import Mask2FormerBackend

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    frame = chip_smoke.zoo_frames(1)["000000"]
    if not args.sam and args.only in (None, "masks"):
        cfg = chip_smoke.mask2former_config()
        backend = Mask2FormerBackend(
            zoo_params(Mask2Former(cfg, device="cpu")), cfg,
            input_hw=chip_smoke.MASK_INPUT_HW)
        stages = ["backbone", "pixel_decoder"] + [
            f"pixel_decoder.encoder_layers.{i}"
            for i in range(cfg.encoder_layers)]
        stages += ["transformer"]
        profile("mask2former", backend,
                lambda: backend.predict_masks_scores(frame), stages)
        del backend
        torch.cuda.empty_cache()
    if not args.sam and args.only in (None, "depth"):
        cfg = chip_smoke.depth_anything_config()
        backend = DepthAnythingBackend(
            chip_smoke.unit_gain(zoo_params(DepthAnything(cfg,
                                                          device="cpu"))),
            cfg, fx=721.5377, input_size=chip_smoke.DEPTH_INPUT_SIZE)
        stages = [f"backbone.layer_{i}"
                  for i in range(cfg.backbone.num_hidden_layers)]
        stages += [f"reassemble.{i}" for i in range(4)]
        stages += [f"fusion.{i}" for i in range(4)]
        profile("depth_anything", backend,
                lambda: backend.predict_depth(frame), stages)
        del backend
        torch.cuda.empty_cache()
    if args.sam:
        import numpy as np

        from monosowa_tpu_torch.models.sam import Sam, vit_h
        from monosowa_tpu_torch.sowa.masks import SamRefineBackend

        cfg = vit_h()
        backend = SamRefineBackend(
            chip_smoke.unit_gain(zoo_params(Sam(cfg, device="cpu"))), cfg)
        rng = np.random.default_rng(0)
        h, w = frame.shape[:2]
        x0, y0 = rng.integers(0, w - 200, 16), rng.integers(0, h - 100, 16)
        boxes = np.stack([x0, y0, x0 + rng.integers(40, 200, 16),
                          y0 + rng.integers(30, 100, 16)], 1)
        stages = ["vision.patch_proj"] + [
            f"vision.layer_{i}" for i in range(cfg.vision.num_hidden_layers)]
        stages += ["vision.neck", "decoder"]
        profile("sam_vit_h", backend, lambda: backend.refine(frame, boxes),
                stages)
        work = chip_smoke.sam_encoder_work(cfg)
        print(json.dumps({"part": "sam_vit_h_encoder_work",
                          "tflop": work["flop"] / 1e12, "bytes": work["bytes"],
                          "bound_ms": work["bound_ms"],
                          "bound_by": work["bound_by"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
