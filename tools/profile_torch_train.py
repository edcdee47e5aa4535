"""Where the torch port's train step spends its time on one GPU.

Builds the full-width MonoDETR (seeded random weights, float32, TF32 off,
50 x 11 Group-DETR queries, dropout 0.1) on ``cuda`` with AdamW, warms up
with two steps of ``make_train_step`` on ``sample_batch(2, 384, 1280)``,
then:

* times one step's phases with CUDA events: input upload, forward (and its
  stages, from forward hooks), criterion with Hungarian matching (host
  round trips included), backward, optimizer update;
* traces one whole ``train_step`` with ``torch.profiler`` and sums device
  time by kernel name, and the device's busy share of the step's wall time.

Prints one JSON line per part, after the card's name and power limit.

    python tools/profile_torch_train.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    from monosowa_tpu_torch.models.criterion import CriterionConfig, criterion
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  make_train_step,
                                                  targets_from_batch)

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    model = MonoDETR(device=dev, seed=0)
    opt = make_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, None, opt)
    batch = sample_batch(2, 384, 1280)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        step(batch, gen)
    torch.cuda.synchronize()
    ccfg = CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes)

    # forward stages from CUDA events in forward hooks
    stages = ["backbone", "depth_predictor", "encoder"]
    stages += [f"encoder.layer{i}.self_attn" for i in range(3)]
    stages += [f"decoder_layer{i}" for i in range(3)]
    stages += [f"decoder_layer{i}.cross_attn" for i in range(3)]
    events, handles = {}, []

    def record(name, slot):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, [None, None])[slot] = ev

    for name in stages:
        mod = model.get_submodule(name)
        handles += [
            mod.register_forward_pre_hook(
                lambda _m, _a, name=name: record(name, 0)),
            mod.register_forward_hook(
                lambda _m, _a, _o, name=name: record(name, 1))]

    # the step's phases, as make_train_step runs them
    t0 = time.perf_counter()
    record("upload", 0)
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    record("upload", 1)
    record("forward", 0)
    out = model(*inputs, generator=gen)
    record("forward", 1)
    record("criterion", 0)
    losses = criterion(out, targets, ccfg)
    record("criterion", 1)
    record("backward", 0)
    opt.zero_grad(set_to_none=True)
    losses["loss_total"].backward()
    record("backward", 1)
    record("optimizer", 0)
    opt.step()
    record("optimizer", 1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for hd in handles:
        hd.remove()
    phases = ["upload", "forward", "criterion", "backward", "optimizer"]
    print(json.dumps({
        "part": "phases_ms", "step_wall_ms": wall_ms,
        **{n: events[n][0].elapsed_time(events[n][1])
           for n in phases + stages}}), flush=True)

    # kernel time by name and the device's busy share over one train_step
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
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
                              for k, t, c in rows[:20]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
