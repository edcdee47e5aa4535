#!/usr/bin/env python
"""Detector training / evaluation command line of the torch port.

CLI contract (MonoDETR/tools/train_val.py:36-122; the JAX package's
``tools/train_val.py``): ``--config <yaml>`` (reference-format
monodetr.yaml), ``-e/--evaluate_only`` and ``--ckpt``; seeds, datasets,
model, optimizer and schedule from the config, resume, the epoch loop with
per-epoch checkpoints and periodic evaluation, best-by-Car-moderate-AP
tracking, and the ``tester.mode: all`` sweep.

    python tools/train_val_torch.py --config configs/monodetr_kitti.yaml
    python tools/train_val_torch.py --config <yaml> -e [--ckpt <path>]
    torchrun --nproc_per_node N tools/train_val_torch.py --config <yaml>

Runs on one CUDA device unless ``--device cpu`` is given: the train step of
``monosowa_tpu_torch.train.trainer`` (hand-written CUDA kernels for
multi-scale deformable attention, forward and backward), host-side numpy
data loading with threaded prefetch, torch checkpoints, KITTI AP through
``monosowa_tpu_torch.evalkitti``.  ``run`` is ``main`` without the files:
it takes a config dict and two datasets.

Under ``torchrun`` each process trains on a card (``cuda:LOCAL_RANK``, or
the CPU with ``--device cpu``) as the JAX trainer's data mesh does
(``monosowa_tpu_torch.parallel``): the first ``n`` ranks, ``n`` the largest
count that divides the batch, each take their slice of every global batch,
and the step is the one a single process takes on the whole batch.  Rank 0
alone logs, writes checkpoints and result files, and evaluates.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

LOG_EVERY = 30


def parse_args(argv=None):
    p = argparse.ArgumentParser("monosowa-tpu detector train/val (torch)")
    p.add_argument("--config", required=True)
    p.add_argument("-e", "--evaluate_only", action="store_true")
    p.add_argument("--ckpt", default=None, help="checkpoint to evaluate")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' runs "
                        "the kernels' plain versions)")
    return p.parse_args(argv)


def run(cfg: Dict[str, Any], train_ds, val_ds, device=None,
        evaluate_only: bool = False, ckpt: Optional[str] = None,
        logger: Callable[[str], None] = print,
        data_parallel=None) -> Dict[str, Any]:
    """Everything after the datasets: model, optimizer and schedule, resume,
    then either the evaluation(s) or the epoch loop.  Returns a record of
    what ran: ``evaluated`` (one entry per evaluation: checkpoint name or
    None, epoch, AP dict, seconds of inference and of AP scoring),
    ``epochs`` (per epoch: every step's ``loss_total``, the last step's loss
    dict, seconds in all, waiting for the loader, in steps, in the
    checkpoint) and ``best_ap``.  With ``data_parallel`` (a
    ``parallel.DataParallel`` of a training group) the model lives on its
    device, each rank steps on its slice of the batches, and ranks other
    than 0 neither log, save nor evaluate."""
    import torch

    from monosowa_tpu_torch.data.loader import build_loader
    from monosowa_tpu_torch.models.monodetr import build_monodetr
    from monosowa_tpu_torch.train import checkpoint as ckpt_io
    from monosowa_tpu_torch.train import tester
    from monosowa_tpu_torch.train.optim import (make_lr_schedule,
                                                make_optimizer,
                                                optimizer_step)
    from monosowa_tpu_torch.train.trainer import (criterion_config_from_yaml,
                                                  make_train_step)

    lead = data_parallel is None or data_parallel.rank == 0
    if data_parallel is not None:
        device = data_parallel.device
    if not lead:
        logger = lambda s: None                              # noqa: E731
    seed = int(cfg.get("random_seed", 444))
    np.random.seed(seed)
    model = build_monodetr(cfg["model"], device=device, seed=seed)
    batch_size = int(cfg["dataset"].get("batch_size", 16))
    steps_per_epoch = max(len(train_ds) // batch_size, 1)

    opt_cfg = cfg.get("optimizer", {})
    sch_cfg = cfg.get("lr_scheduler", {})
    base_lr = float(opt_cfg.get("lr", 2e-4))
    optimizer = make_optimizer(
        model, base_lr, float(opt_cfg.get("weight_decay", 1e-4)))
    schedule = make_lr_schedule(
        base_lr, steps_per_epoch,
        decay_epochs=tuple(sch_cfg.get("decay_list", (125, 165))),
        decay_rate=float(sch_cfg.get("decay_rate", 0.1)),
        warmup_epochs=5 if sch_cfg.get("warmup", False) else 0)

    save_path = cfg["trainer"].get("save_path", "outputs")
    os.makedirs(save_path, exist_ok=True)
    start_epoch = 0
    resume = ckpt or (ckpt_io.latest_checkpoint(save_path)
                      if cfg.get("continue_train", False) else None)
    if resume:
        start_epoch = ckpt_io.restore_checkpoint(resume, model,
                                                 optimizer)["epoch"]
        logger(f"resumed from {resume} (epoch {start_epoch})")

    record: Dict[str, Any] = {"device": str(model.device),
                              "start_epoch": start_epoch, "evaluated": [],
                              "epochs": [], "best_ap": -1.0}

    def evaluate(name: Optional[str], epoch: int) -> Dict:
        seconds: Dict[str, float] = {}
        res = tester.test(model, val_ds, cfg, logger, seconds=seconds)
        record["evaluated"].append({"checkpoint": name, "epoch": epoch,
                                    "results": res, **seconds})
        return res

    if evaluate_only:
        if not lead:
            return record
        # tester.mode 'all' (tester_helper.py:28-78): evaluate the best
        # checkpoint first when present, then EVERY epoch checkpoint in
        # epoch order; 'single' evaluates the resumed/--ckpt state only
        mode = str(cfg.get("tester", {}).get("mode", "single"))
        if mode == "all" and not ckpt:
            best = ckpt_io.latest_checkpoint(save_path, tag="best")
            sweep = ([best] if best else []) + \
                ckpt_io.list_checkpoints(save_path)
            for path in sweep:
                ep = ckpt_io.restore_checkpoint(path, model,
                                                optimizer)["epoch"]
                logger(f"== evaluating {os.path.basename(path)} "
                       f"(epoch {ep}) ==")
                evaluate(os.path.basename(path), ep)
        else:
            evaluate(os.path.basename(resume) if resume else None,
                     start_epoch)
        return record

    train_step = make_train_step(
        model, criterion_config_from_yaml(model, cfg["model"]), optimizer,
        schedule, data_parallel)
    loader = build_loader(train_ds, batch_size, shuffle=True,
                          shard=(data_parallel.shard(batch_size)
                                 if data_parallel is not None
                                 else slice(None)))
    max_epoch = int(cfg["trainer"].get("max_epoch", 195))
    save_freq = int(cfg["trainer"].get("save_frequency", 1))
    # dropout's stream; the JAX package's key stream cannot be reproduced
    generator = torch.Generator(device=model.device).manual_seed(seed)

    for epoch in range(start_epoch, max_epoch):
        t0 = time.perf_counter()
        ep = {"epoch": epoch, "loss_total": [], "losses": {},
              "loader_wait_s": 0.0, "step_s": 0.0, "checkpoint_s": 0.0}
        batches = iter(loader())
        i = 0
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            t_step = time.perf_counter()
            ep["loader_wait_s"] += t_step - t_wait
            if batch is None:
                break
            losses = train_step(batch, generator)   # ends in a copy to host
            ep["step_s"] += time.perf_counter() - t_step
            ep["loss_total"].append(losses["loss_total"])
            ep["losses"] = losses
            if i % LOG_EVERY == 0:
                msg = " ".join(f"{k}={v:.3f}"
                               for k, v in sorted(losses.items())
                               if not k[-1].isdigit())
                logger(f"epoch {epoch} step {i}/{steps_per_epoch}: {msg}")
            i += 1
        ep["train_s"] = time.perf_counter() - t0
        logger(f"epoch {epoch} done in {ep['train_s']:.0f}s")
        record["epochs"].append(ep)
        if lead and (epoch + 1) % save_freq == 0:
            def save(**kw):
                t_ck = time.perf_counter()
                path = ckpt_io.save_checkpoint(
                    save_path, model, optimizer, optimizer_step(optimizer),
                    epoch + 1, **kw)
                ep["checkpoint_s"] += time.perf_counter() - t_ck
                return path

            name = os.path.basename(save())
            res = evaluate(name, epoch + 1)
            ap_mod = res.get("car_3d_strict", {}).get("ap40", [0, 0, 0])[1]
            if ap_mod > record["best_ap"]:
                record["best_ap"] = ap_mod
                save(best_ap=ap_mod, tag="best")
    return record


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)

    from monosowa_tpu_torch.config import load_yaml
    from monosowa_tpu_torch.data.kitti_dataset import KittiDetectionDataset

    cfg = load_yaml(args.config)
    ds_cfg = dict(cfg["dataset"])
    root = ds_cfg["root_dir"]
    train_ds = KittiDetectionDataset(root, ds_cfg.get("train_split", "train"),
                                     ds_cfg)
    val_ds = KittiDetectionDataset(root, ds_cfg.get("test_split", "val"),
                                   ds_cfg)

    import torch.distributed as dist

    from monosowa_tpu_torch.parallel import setup

    dp = setup(int(ds_cfg.get("batch_size", 16)), args.device)
    try:
        if not dp.trains:
            return {"device": str(dp.device), "rank": dp.rank,
                    "trained": False}
        return run(cfg, train_ds, val_ds, dp.device, args.evaluate_only,
                   args.ckpt, data_parallel=(dp if dp.group is not None
                                             else None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
