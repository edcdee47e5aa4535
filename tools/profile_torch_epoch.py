"""Where an epoch of the torch port's train / test / AP loop spends its
time on one GPU.

Drives ``tools/train_val_torch.py`` ``run`` at full width (the shipped
detector, float32, TF32 off, batch 2) on the in-memory ``SampleDataset``
(16 training and 8 test images of 384x1280): a first epoch that loads every
library and kernel, then, resumed from its checkpoint, a second one whose
stages are reported:

* from ``run``'s record: waiting for the loader, the train steps, the
  checkpoints (epoch and best), inference and AP scoring;
* inside inference, by host clock around the tester's calls: building the
  test batches, forward + top-k (ends in a copy to the host), decode, the
  result files;
* with ``torch.profiler`` over the whole second ``run``: device time by
  kernel name and the device's busy share of the wall time.

Prints one JSON line per part, after the card's name and power limit.

    python tools/profile_torch_epoch.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_TRAIN, N_VAL = 16, 8


def profile(dev, n_train=N_TRAIN, n_val=N_VAL, hw=None, model=None) -> None:
    """The two runs and the two JSON lines; the defaults are the full
    width, smaller sizes are for a rehearsal on the CPU."""
    import torch

    import chip_smoke
    from monosowa_tpu_torch.train import tester
    from monosowa_tpu_torch.train.sample import (SampleDataset,
                                                 write_sample_labels)
    from tools import train_val_torch

    h, w = hw or (chip_smoke.IMG_H, chip_smoke.IMG_W)
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # host seconds inside the tester's calls, by name
    seconds = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) \
                    + time.perf_counter() - t0
        return wrapper

    make_eval_step = tester.make_eval_step

    def timed_eval_step(net, topk):
        step = make_eval_step(net, topk)
        return timed("forward_topk", lambda batch: step(batch).cpu())

    tester.collate = timed("test_batches", tester.collate)
    tester.decode_detections = timed("decode", tester.decode_detections)
    tester.write_detection_file = timed("write", tester.write_detection_file)
    tester.make_eval_step = timed_eval_step

    with tempfile.TemporaryDirectory() as tmp:
        cfg = chip_smoke.detector_config(tmp, h, w, model)
        train_ds = SampleDataset(n_train, cfg["dataset"])
        val_ds = SampleDataset(n_val, cfg["dataset"], first_id=n_train)
        write_sample_labels(os.path.join(tmp, "training", "label_2"), val_ds)
        quiet = lambda s: None                               # noqa: E731
        t0 = time.perf_counter()
        train_val_torch.run(cfg, train_ds, val_ds, dev, logger=quiet)
        sync()
        first_s = time.perf_counter() - t0

        cfg["continue_train"] = True
        cfg["trainer"]["max_epoch"] = 2
        seconds.clear()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            record = train_val_torch.run(cfg, train_ds, val_ds, dev,
                                         logger=quiet)
            sync()
            wall_s = time.perf_counter() - t0
    ep, ev = record["epochs"][0], record["evaluated"][0]
    if record["start_epoch"] != 1 or ep["epoch"] != 1:
        raise AssertionError(f"the second run did not resume: {record}")
    steps = len(ep["loss_total"])
    print(json.dumps({
        "part": "epoch_stages_s", "first_run_s": first_s,
        "second_run_s": wall_s, "train_images": n_train,
        "val_images": n_val, "steps": steps,
        "loader_wait": ep["loader_wait_s"], "train_steps": ep["step_s"],
        "step_ms_mean": ep["step_s"] * 1e3 / steps,
        "checkpoints": ep["checkpoint_s"], "inference": ev["inference"],
        "ap": ev["ap"], "inference_parts": dict(seconds),
        "test_ms_per_image": ev["inference"] * 1e3 / n_val,
        "model_restore_and_rest": wall_s - ep["train_s"]
        - ep["checkpoint_s"] - ev["inference"] - ev["ap"]}), flush=True)

    # kernels and copies only: the optimizer's annotated range shows up on
    # the device track too and would count its kernels twice
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(json.dumps({"part": "kernels", "wall_ms": wall_s * 1e3,
                      "device_ms": busy,
                      "device_busy_share": busy / (wall_s * 1e3),
                      "top": [{"kernel": k[:90], "ms": t, "count": c}
                              for k, t, c in rows[:12]]}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    profile(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
