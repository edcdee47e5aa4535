"""Where the Waymo path's networks spend their time on one GPU.

Builds EfficientLoFTR and the ViT tracker at full width (seeded random
weights, TF32 off) on ``cuda`` and, on a seeded 2 x 480 x 640 grey pair and
a 128 / 256 crop pair:

* times LoFTR's stages with CUDA events (the RepVGG backbone, the
  aggregated-attention transformer, the coarse matching, the fine fusion
  and both fine stages) and a whole forward, and the tracker's step;
* traces one LoFTR forward and one tracker step with ``torch.profiler``
  and sums device time by kernel name, with the device's busy share;
* times each convolution of the fine fusion (float32) through cuDNN and
  through PyTorch's own convolution (cuDNN off), and each 1 x 1 also as
  one product over the channels: the routes ``models/efficientloftr.py``
  chooses from;
* times the aggregated attention's depthwise 4 x 4, stride-4 query
  convolution at the coarse grid through cuDNN (the model's route),
  through PyTorch's own and as a reshape and one weighted sum (its
  windows do not overlap);
* times ``ops/warp.py``'s ``cv2_warp_perspective`` of a float32 mask at
  the 1380 x 4590 pair canvas (the tracker's switch check warps one a
  step) and its source mapping, computed once a column (OpenCV's vector
  code for the full blocks of 16 columns, its scalar code for the rest)
  and, for comparison, by both code paths for every column, one picked
  per column.

Prints one JSON line per part, after the card's name and power limit.

    python tools/profile_torch_waymo.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def event_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def traced(fn, top: int = 8) -> dict:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0), key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall,
            "launches": sum(r[2] for r in rows),
            "top_kernels": [{"kernel": k[:80], "ms": t, "count": c}
                            for k, t, c in rows[:top]]}


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from monosowa_tpu_torch.device import resolve_device
    from monosowa_tpu_torch.models.efficientloftr import EfficientLoFTR
    from monosowa_tpu_torch.models.vit_tracker import ViTTracker
    from monosowa_tpu_torch.ops import warp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = resolve_device()
    gen = torch.Generator().manual_seed(0)
    pair = torch.rand(1, 2, 480, 640, generator=gen).to(dev)
    m = EfficientLoFTR(device=dev)
    with torch.no_grad():
        feats, coarse = m.coarse_features(pair)
        b, _, ch, cw, c = coarse.shape
        scores = m.coarse_scores(coarse)
        idx, _ = m.get_matches(scores, ch, cw)
        coarse_n = coarse.reshape(b * 2, ch, cw, c) / c ** 0.5
        f0, f1 = m.fine_fusion_forward(coarse_n, [feats[1], feats[0]])
        n = f0.shape[1]
        g0 = torch.gather(f0, 1, (idx[:, 0] % n)[:, :, None, None].expand(
            -1, -1, f0.shape[2], f0.shape[3]))
        g1 = torch.gather(f1, 1, (idx[:, 1] % n)[:, :, None, None].expand(
            -1, -1, f1.shape[2], f1.shape[3]))
        kp = torch.zeros(b, 2, n, 2, device=dev)
        stages = {
            "backbone": lambda: m.repvgg_forward(pair.reshape(2, 480, 640,
                                                              1)),
            "transformer": lambda: m.local_feature_transformer(
                feats[-1].reshape(b, 2, ch, cw, c),
                m.rope((ch - 4) // 4 + 1, (cw - 4) // 4 + 1, dev)),
            "coarse_matching": lambda: m.get_matches(
                m.coarse_scores(coarse), ch, cw),
            "fine_fusion": lambda: m.fine_fusion_forward(
                coarse_n, [feats[1], feats[0]]),
            "fine_matching": lambda: m.fine_matching(g0, g1, kp, 1.0),
            "forward": lambda: m(pair)}
        loftr = {k: event_ms(fn) for k, fn in stages.items()}
        trace = traced(lambda: m(pair))
    print(json.dumps({"part": "loftr", "input_hw": [480, 640],
                      "stage_ms": loftr, **trace}), flush=True)

    t = ViTTracker(device=dev)
    z = torch.randn(1, 128, 128, 3, generator=gen).to(dev)
    x = torch.randn(1, 256, 256, 3, generator=gen).to(dev)
    with torch.no_grad():
        step = event_ms(lambda: t(z, x, t.track_token), 20)
        trace = traced(lambda: t(z, x, t.track_token))
    print(json.dumps({"part": "tracker", "step_ms": step, **trace}),
          flush=True)

    # (kernel, c_in, c_out, (h, w)) of the fine fusion at the 480 x 640
    # input: out_conv, each out-conv block's out_conv1, out_conv2 (an
    # nn.Conv2d) and out_conv3
    convs = []
    for k, cin, cout, hw in ((1, 256, 256, (60, 80)),
                             (1, 128, 256, (120, 160)),
                             (3, 256, 256, (120, 160)),
                             (3, 256, 128, (120, 160)),
                             (1, 64, 128, (240, 320)),
                             (3, 128, 128, (240, 320)),
                             (3, 128, 64, (240, 320))):
        xi = torch.rand(2, cin, *hw, generator=gen).to(dev)
        w = torch.rand(cout, cin, k, k, generator=gen).to(dev) / cin
        row = {"kernel": k, "in": cin, "out": cout, "hw": list(hw)}
        for name, on in (("cudnn_ms", True), ("pytorch_ms", False)):
            with torch.backends.cudnn.flags(enabled=on, allow_tf32=False):
                row[name] = event_ms(
                    lambda: F.conv2d(xi, w, padding=k // 2), 3, 1)
        if k == 1:
            xl = xi.permute(0, 2, 3, 1).contiguous()
            wm = w[:, :, 0, 0].t().contiguous()
            row["matmul_ms"] = event_ms(lambda: torch.matmul(xl, wm), 3, 1)
        convs.append(row)
    print(json.dumps({"part": "fine_fusion_convs", "convs": convs}),
          flush=True)

    agg = m.transformer[0].self_attention
    xq = torch.rand(2, 60, 80, 256, generator=gen).to(dev)
    xc = xq.permute(0, 3, 1, 2)
    row = {"in": 256, "hw": [60, 80], "kernel": 4, "stride": 4}
    with torch.no_grad():
        for name, on in (("cudnn_ms", True), ("pytorch_ms", False)):
            with torch.backends.cudnn.flags(enabled=on, allow_tf32=False):
                row[name] = event_ms(lambda: agg.q_aggregation(xc), 3, 1)
        wt = agg.q_aggregation.weight[:, 0].permute(1, 2, 0)   # (4, 4, C)

        def reshape_sum():
            win = xq.reshape(2, 15, 4, 20, 4, 256)
            return (win * wt[None, None, :, None]).sum((2, 4))

        row["reshape_sum_ms"] = event_ms(reshape_sum, 3, 1)
        ref = agg.q_aggregation(xc).permute(0, 2, 3, 1)
        row["reshape_sum_rel_err"] = float(
            (reshape_sum() - ref).abs().max() / ref.abs().max())
    print(json.dumps({"part": "query_aggregation", **row}), flush=True)

    h, w = 1380, 4590
    homo = np.array([[1.0, 0.01, 2500.0], [-0.008, 1.0, 76.0],
                     [2e-5, 0.0, 1.0]])
    mask = (torch.rand(h, w, generator=gen) > 0.5).float().to(dev)
    inv = warp.cv2_invert_3x3(homo).astype(np.float32)

    def both_paths():
        x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        vec = torch.arange(w, device=dev)[None, :] < w // 16 * 16
        out = []
        for r in range(3):
            m0, m1, m2 = (float(v) for v in inv[r])
            vt = warp._fma(x.expand(h, w), m0, (y * m1 + m2).expand(h, w))
            st = warp._fma(x.expand(h, w), m0, (y * m1).expand(h, w)) + m2
            out.append(torch.where(vec, vt, st))
        return out[0] / out[2], out[1] / out[2]

    def once():
        return warp._source_coords(homo, (h, w), dev, torch.float32)

    row = {"hw": [h, w],
           "warp_ms": event_ms(
               lambda: warp.cv2_warp_perspective(mask, homo, (w, h))),
           "mapping_ms": event_ms(once),
           "both_paths_mapping_ms": event_ms(both_paths),
           "same_bits": all(torch.equal(a, b)
                            for a, b in zip(once(), both_paths()))}
    print(json.dumps({"part": "warp", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
