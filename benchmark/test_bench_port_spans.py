"""The per-layer metrics that read the port's own spans
(``port_spans.py``): the tiny mask cell, traced, on the CPU reports all
seven, and the frame's stages and its waits on the card add up to the
benchmark's own frame span (the mean ``masks.mfu_pct`` divides by)."""

import os

import torch

import bench_harness as bh
import bench_tiny

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = bh.load_module(os.path.join(HERE, "run.py"), "bench_run_module")
CELL = "mask2former-swinb-masks"
STAGES = ("masks.encode_host_ms", "masks.backbone_host_ms",
          "masks.pixel_decoder_host_ms", "masks.decoder_host_ms",
          "masks.keep_host_ms")
PORT = STAGES + ("masks.sync_wait_ms", "masks.host_syncs")


def test_port_spans_in_the_tiny_mask_cell():
    torch.set_num_threads(4)
    bench = bh.Bench()
    assert {m["name"] for m in bench.metrics(CELL, trace=True)} >= set(PORT)
    res = RUN.run_cell(bench, CELL, 2 ** 40 + 17, 3.0, trace=True,
                       device="cpu",
                       overrides=bench_tiny.overrides(bench, CELL))
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(PORT) <= set(got), sorted(got)
    assert all(res["metrics"][k]["unit"] == "ms" for k in PORT[:-1])
    # nothing waits on a card here
    assert got["masks.sync_wait_ms"] == got["masks.host_syncs"] == 0
    # the benchmark's frame span: the mean masks.mfu_pct divides by
    frame_ms = 1e3 * res["work"]["frame_flops"] / (
        got["masks.mfu_pct"] / 100 * bench.peaks()["float32_flops"])
    parts = sum(got[k] for k in STAGES) + got["masks.sync_wait_ms"]
    assert abs(parts - frame_ms) <= 0.1 * frame_ms, (parts, frame_ms)
