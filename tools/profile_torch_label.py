"""Where the torch port's pseudo-labeller spends its time on one GPU.

Builds the synthetic 375x1242 sequence of ``sowa/sample.py`` (about 460k
points a frame, about 6 cars in view) and labels three consecutive groups
of 8 reference frames with windows of +-6 frames through
``PseudoLabeler.label_frames`` (host candidates, the full 41 x 41 x 40 grid,
360 fine thetas, float32, TF32 off):

* group 1 is the first use of every CUDA kernel and library in the process:
  its stage times are printed as ``first_group``;
* group 2 is timed by stage on the host clock (extraction, tracking and
  aggregation, fit, NMS, merge re-fit, writing) and, inside every
  ``fit_cars_conv`` call, with CUDA events: the coarse convolution grid,
  the exact rescore with its half-pitch refinement, the fine theta pass;
* group 3 runs under ``torch.profiler``: device time by kernel name and the
  device's busy share of the group's wall time.

With ``--bank`` the jobs also give depth maps (``make_jobs(with_depth=True)``)
and take bank mode: the stages are then the extraction's dispatch, the
metadata copy, tracking and slot selection, the fused fit + NMS + re-fit
and writing, and CUDA events also span each extraction chunk
(``_extract_window_bank``) and the fused function (``_fit_nms_from_bank``).

Prints one JSON line per part, after the card's name and power limit.

    python tools/profile_torch_label.py [--bank] [--window N]

``--window`` sets the half window (default 6; the production window is 30).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUP, WINDOW = 8, 6


def main() -> int:
    import torch

    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import (bank, candidates_device, fitting,
                                         pipeline, sample)
    from monosowa_tpu_torch.utils import timing

    argv = sys.argv[1:]
    use_bank = "--bank" in argv
    window = int(argv[argv.index("--window") + 1]) if "--window" in argv \
        else WINDOW

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    frames, _ = sample.make_sequence(3 * GROUP, window)
    cfg = pipeline.PipelineConfig(
        nscans_before=window, nscans_after=window, max_cars=16,
        max_points=2048, min_standing_points=400,
        fit=fitting.FitConfig(fine_chunk=60))
    labeler = pipeline.PseudoLabeler(cfg)

    # CUDA events around the three parts of every fit
    spans = []

    def timed(module, name, label):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((label, start, end))
            return out

        setattr(module, name, wrapper)

    timed(tfl, "grid_pose_losses_conv", "coarse_conv_ms")
    timed(fitting, "_exact_rescore_translations", "exact_rescore_ms")
    timed(fitting, "exact_theta_losses", "fine_pass_ms")
    if use_bank:
        timed(candidates_device, "_extract_window_bank", "extract_chunk_ms")
        timed(bank, "_fit_nms_from_bank", "fused_fit_ms")

    def label_group(jobs):
        spans.clear()
        timing.reset_counters("tfl.launches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = labeler.label_frames(jobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parts, calls = {}, {}
        for label, start, end in spans:
            parts.setdefault(label, []).append(start.elapsed_time(end))
        stages = dict(labeler.stage_seconds)
        host = stages["extract"] + stages["track_aggregate"]
        return {"frames": n, "wall_s": wall,
                "label_ms_per_frame": wall * 1e3 / max(n, 1),
                "stage_seconds": stages, "host_share": host / wall,
                "fit_calls": len(parts.get("coarse_conv_ms", ())),
                "fit_parts_device_ms": {k: sum(v) for k, v in parts.items()},
                "spans_ms": {k: v for k, v in parts.items()
                             if k in ("extract_chunk_ms", "fused_fit_ms")},
                "tfl_launches": timing.counter("tfl.launches")}

    with tempfile.TemporaryDirectory() as tmp:
        groups = [sample.make_jobs(frames, window, tmp, lo=g * GROUP,
                                   hi=(g + 1) * GROUP, with_depth=use_bank)
                  for g in range(3)]
        print(json.dumps({"part": "first_group", **label_group(groups[0])}),
              flush=True)
        print(json.dumps({"part": "second_group", **label_group(groups[1])}),
              flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            third = label_group(groups[2])
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(json.dumps({"part": "kernels", "bank": use_bank, "window": window,
                      "wall_ms": third["wall_s"] * 1e3,
                      "stage_seconds": third["stage_seconds"],
                      "device_ms": busy,
                      "device_busy_share": busy / (third["wall_s"] * 1e3),
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in rows[:20]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
