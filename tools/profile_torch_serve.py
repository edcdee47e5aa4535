"""Where the torch port's serve forward spends its time on one GPU.

Builds the full-width MonoDETR (seeded random weights, TF32 off) on
``cuda`` under ``--compute-dtype`` (default float32; "auto" or bfloat16 for
the bf16 policy), warms up, then for one request of two 384x1280 images:

* times each stage with CUDA events from forward hooks (backbone, input
  projections, depth predictor, each encoder layer and its MSDA module,
  each decoder layer and its MSDA module);
* traces the same forward with ``torch.profiler`` and sums device time by
  kernel name, and the device's busy share of the forward's wall time.

Prints one JSON line per part, after the card's name and power limit.

    python tools/profile_torch_serve.py [--compute-dtype auto]
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compute-dtype", default="float32",
                        help="the model's compute_dtype (float32, bfloat16 "
                             "or auto)")
    args = parser.parse_args()
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.train.trainer import make_eval_step

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    model = MonoDETR(device="cuda", seed=0,
                     compute_dtype=args.compute_dtype)
    rng = np.random.default_rng(1)
    b, h, w = 2, 384, 1280
    batch = {"image": rng.normal(size=(b, h, w, 3)).astype(np.float32),
             "calib": np.tile(np.array([[700.0, 0, w / 2, 0],
                                        [0, 700.0, h / 2, 0],
                                        [0, 0, 1, 0]], np.float32),
                              (b, 1, 1)),
             "img_size": np.tile(np.array([w, h], np.float32), (b, 1))}
    step = make_eval_step(model, topk=50)
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()

    # per-stage device time from CUDA events around each module
    stages = ["backbone", "input_proj0", "input_proj1", "input_proj2",
              "input_proj3", "depth_predictor"]
    stages += [f"encoder.layer{i}" for i in range(3)]
    stages += [f"encoder.layer{i}.self_attn" for i in range(3)]
    stages += [f"decoder_layer{i}" for i in range(3)]
    stages += [f"decoder_layer{i}.cross_attn" for i in range(3)]
    events, handles = {}, []
    for name in stages:
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(batch)
    end.record()
    torch.cuda.synchronize()
    for hd in handles:
        hd.remove()
    total = start.elapsed_time(end)
    print(json.dumps({"part": "stages_ms", "compute_dtype": args.compute_dtype,
                      "forward_ms": total, **{
        n: events[n][0].elapsed_time(events[n][1]) for n in stages}}),
        flush=True)

    # kernel time by name and the device's busy share
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(json.dumps({"part": "kernels", "wall_ms": wall_ms,
                      "device_ms": busy,
                      "device_busy_share": busy / wall_ms,
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in rows[:15]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
