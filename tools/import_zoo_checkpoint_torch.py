#!/usr/bin/env python
"""Convert a local Hugging Face checkpoint directory into a model-zoo
``.npz`` that the port's ``backends:`` config section loads
(``monosowa_tpu_torch/sowa/zoo.py``), with the port alone.

The counterpart of ``tools/import_zoo_checkpoint.py``: the same arguments
and the same file (the param tree of the JAX package's importers, written
by ``save_checkpoint``; either package loads it), but no ``jax``,
``transformers`` or ``safetensors``: ``sowa/hf_checkpoint.py`` reads the
directory's ``config.json`` and ``model.safetensors`` (or its shards, or
``pytorch_model.bin``) with numpy and torch, and the port's
``import_hf_*`` writes the tree.  Nothing is downloaded: ``--hf`` must
name a directory on disk, as ``save_pretrained`` or a download of the
public release's files leaves it::

    <dir>/config.json
    <dir>/model.safetensors            (or model.safetensors.index.json
                                        and its shards, or
                                        pytorch_model.bin)

Usage::

    python tools/import_zoo_checkpoint_torch.py --kind depth_anything \
        --hf ckpts/Depth-Anything-V2-Metric-Outdoor-Large-hf \
        --out ckpts/depth_metric_outdoor.npz
    python tools/import_zoo_checkpoint_torch.py --kind mask2former \
        --hf ckpts/mask2former-swin-base-coco-instance --out ...
    python tools/import_zoo_checkpoint_torch.py --kind sam \
        --hf ckpts/sam-vit-huge --out ...
    python tools/import_zoo_checkpoint_torch.py --kind loftr \
        --hf ckpts/efficientloftr --out ...

(public releases: depth-anything/Depth-Anything-V2-Metric-Outdoor-Large-
hf, facebook/mask2former-swin-base-coco-instance, facebook/sam-vit-huge,
zju-community/efficientloftr).  Then point the config at the file::

    backends:
      depth: depth_anything
      depth_checkpoint: ckpts/depth_metric_outdoor.npz
      mask: mask2former
      mask_checkpoint: <mask2former .npz>
      matcher: loftr
      matcher_checkpoint: <loftr .npz>
    paths:
      sam_path: <sam .npz>            # with frames_creation.use_SAM: True

The last line printed is a JSON object: the seconds spent reading,
importing and writing, the resident memory before and its peak during
them.
``--no-compress`` stores the arrays undeflated (a larger file, written
several times faster; both packages load it the same way).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

KINDS = ["depth_anything", "mask2former", "sam", "loftr"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True, choices=KINDS + ["vit_tracker"])
    ap.add_argument("--hf", required=True,
                    help="local checkpoint directory (config.json + "
                         "weights)")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--no-compress", action="store_true",
                    help="store the arrays undeflated")
    args = ap.parse_args(argv)
    if args.kind == "vit_tracker":
        raise SystemExit("--kind vit_tracker: tracker checkpoints come from "
                         "training, not a public HF release")

    from monosowa_tpu_torch.sowa import hf_checkpoint, zoo

    with RssPeak() as rss:
        t0 = time.perf_counter()
        try:
            config, state = hf_checkpoint.read_checkpoint_dir(args.hf)
        except FileNotFoundError as e:
            raise SystemExit(str(e))
        t1 = time.perf_counter()
        params, cfg = hf_checkpoint.import_checkpoint(args.kind, config,
                                                      state)
        t2 = time.perf_counter()
        zoo.save_checkpoint(args.out, args.kind, params, cfg,
                            compress=not args.no_compress)
        t3 = time.perf_counter()
    print(f"wrote {args.out} ({args.kind})")
    print(json.dumps({
        "kind": args.kind, "out": args.out, "read_s": t1 - t0,
        "import_s": t2 - t1, "write_s": t3 - t2,
        "tensors_read": len(state),
        "bytes_written": os.path.getsize(args.out),
        "rss_before_GB": rss.before / 1e9, "peak_rss_GB": rss.peak / 1e9}))
    return 0


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise OSError("no VmRSS")


class RssPeak:
    """The largest resident memory sampled every 5 ms while the block runs
    (``VmRSS``; ``ru_maxrss`` and ``VmHWM`` may carry a forking parent's
    peak), or ``ru_maxrss`` where there is no ``/proc``."""

    def __enter__(self):
        import threading

        try:
            self.before = self.peak = _rss_bytes()
        except OSError:
            self.before = self.peak = 0
            self._thread = None
            return self
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, _rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is None:
            self.peak = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
            return
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


if __name__ == "__main__":
    raise SystemExit(main())
