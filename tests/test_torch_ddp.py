"""Data-parallel training (``monosowa_tpu_torch/parallel``): two processes
on ``gloo``, each with half of a batch of 4, against one process with the
whole batch.

The JAX trainer computes the global batch's loss and gradients over its
data mesh (GSPMD); the port's step under ``make_train_step(...,
data_parallel=)`` must give the same: its batch normalisers (the
criterion's ``num_boxes``, the dimension loss's ratio, the depth map's
pixel count, DN-DETR's valid slots) are summed over the ranks, the
gradients summed before AdamW, and each dropout keeps its slice of the whole
batch's draws.  Losses and gradients within 2e-4 of their scale
(tests/test_torch_train_step.py's bar), with dropout on, for the default
model, with ``use_add_data`` (TFL and mask losses), with DN-DETR queries and
with two_stage.  The processes meet through a ``FileStore`` (no network).
The module imports no JAX: the spawned processes import it.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from monosowa_tpu_torch.parallel import (data_parallel_size,
                                         from_process_group, launcher_ranks,
                                         shard_slice)

B, H, W = 4, 96, 160
WORLD = 2
CASES = ("default", "add_data", "dn", "two_stage")
TINY = dict(enc_layers=1, dec_layers=2, group_num=2, d_model=64, d_ffn=64,
            nheads=4, num_queries=10, num_depth_bins=16, dropout=0.1)
BAR = 2e-4
SPAWN_TIMEOUT_S = 300


def _spawn(fn, args, nprocs):
    """``mp.spawn`` with a deadline: a rank that hangs in a collective is
    killed and the test fails, where a plain join would wait forever."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{fn.__name__}: ranks still running after "
                               f"{SPAWN_TIMEOUT_S} s")


@pytest.mark.parametrize("batch,world,want", [
    (4, 1, 1), (4, 2, 2), (4, 3, 2), (4, 4, 4), (4, 8, 4), (3, 2, 1),
    (6, 4, 3), (16, 5, 4), (16, 16, 16), (1, 8, 1)])
def test_data_parallel_size_is_the_jax_rule(batch, world, want):
    """tools/train_val.py:166-168: the largest device count that divides
    the batch."""
    assert data_parallel_size(batch, world) == want
    assert want == max(d for d in range(1, world + 1) if batch % d == 0)


def test_shard_slices_cover_the_batch_in_order():
    got = [list(range(8))[shard_slice(8, r, 4)] for r in range(4)]
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]
    for bad in ((8, 4, 4), (8, -1, 4), (6, 0, 4)):
        with pytest.raises(ValueError):
            shard_slice(*bad)
    assert launcher_ranks({}) == (0, 1, 0)
    assert launcher_ranks({"RANK": "3", "WORLD_SIZE": "4",
                           "LOCAL_RANK": "1"}) == (3, 4, 1)


def test_one_process_without_a_group():
    dp = from_process_group(B, torch.device("cpu"))
    assert (dp.rank, dp.size, dp.group) == (0, 1, None)
    assert dp.trains and dp.batch_shard is None and dp.shard(B) == slice(0, 4)


def _launched_rank(rank, world, port, out_dir):
    """A process as ``torchrun`` starts one: the launcher's environment,
    then ``setup`` (gloo for the CPU, a localhost rendezvous)."""
    from monosowa_tpu_torch.parallel import global_sum, setup

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    logs = []
    dp = setup(B, "cpu", logs.append)
    try:
        total = None
        if dp.trains:
            total = global_sum(torch.tensor([float(rank + 1)]),
                               dp.group).item()
        with open(os.path.join(out_dir, f"setup{rank}.json"), "w") as f:
            json.dump({"rank": dp.rank, "size": dp.size,
                       "trains": dp.trains, "device": str(dp.device),
                       "group": dp.group is not None,
                       "batch_shard": dp.batch_shard, "total": total,
                       "logs": logs}, f)
    finally:
        dist.destroy_process_group()


def test_setup_from_the_launcher_takes_the_jax_groups_size(tmp_path):
    """Three launched processes and a batch of 4: the first two train (the
    largest count that divides the batch), the third takes no part, and
    rank 0 says so."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    _spawn(_launched_rank, (3, port, str(tmp_path)), 3)
    got = []
    for r in range(3):
        with open(tmp_path / f"setup{r}.json") as f:
            got.append(json.load(f))
    assert [(g["rank"], g["size"], g["trains"], g["group"]) for g in got] \
        == [(0, 2, True, True), (1, 2, True, True), (2, 2, False, False)]
    assert [g["batch_shard"] for g in got[:2]] == [[0, 2], [1, 2]]
    assert [g["total"] for g in got] == [3.0, 3.0, None]
    assert {g["device"] for g in got} == {"cpu"}
    assert len(got[0]["logs"]) == 1 and "2 of 3" in got[0]["logs"][0]
    assert got[1]["logs"] == got[2]["logs"] == []


def _add_batch(b, seed=0):
    """sample_batch plus a car payload: two cars an image of 64 template
    points near the synthetic targets, one moving, and their masks
    (tests/test_torch_add_data.py's)."""
    from monosowa_tpu_torch.sowa.templates import TemplateBank
    from monosowa_tpu_torch.train.sample import sample_batch

    batch = sample_batch(b, H, W, seed=seed)
    rng = np.random.default_rng(seed + 10)
    pts_t = np.asarray(TemplateBank.default().points)
    tmpl = pts_t[:, ::max(1, pts_t.shape[1] // 64)][:, :64]
    c, p = 3, 64
    pts = np.zeros((b, c, p, 3), np.float32)
    for i in range(b):
        for k in range(2):
            pts[i, k] = tmpl[k] + rng.uniform([-3, 0.5, 8], [3, 1.5, 25])
    masks = np.zeros((b, c, H // 8, W // 8), np.float32)
    masks[:, :2, 4:8, 6:14] = 1.0
    ident = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
                    (b, 1, 1))
    batch.update(car_points=pts,
                 car_pmask=np.ones((b, c, p), bool),
                 car_valid=np.tile([True, True, False], (b, 1)),
                 car_moving=np.tile([False, True, False], (b, 1)),
                 car_masks=masks, trans=ident, trans_inv=ident,
                 flip_flag=np.zeros(b, bool),
                 canonical_scale=np.ones(b, np.float32))
    return batch


def _step(case, dp):
    """One train step of ``case`` on this process's slice of the global
    batch (the whole batch without ``dp``): its loss dict and every
    gradient after the reduction."""
    from monosowa_tpu_torch.models.criterion import (CriterionConfig,
                                                     criterion)
    from monosowa_tpu_torch.models.dn_components import (DNConfig,
                                                         DNQueries, dn_loss,
                                                         prepare_dn)
    from monosowa_tpu_torch.models.matcher import MatcherConfig
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.parallel import all_reduce_grads, global_sum
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  make_train_step,
                                                  targets_from_batch)

    cpu = torch.device("cpu")
    model = MonoDETR(device="cpu", seed=0, use_dn=case == "dn",
                     two_stage=case == "two_stage", **TINY)
    whole = _add_batch(B) if case == "add_data" else sample_batch(B, H, W)
    # five valid targets in one image, one in another, none in a third
    whole["valid"][:] = False
    whole["valid"][0, :5] = whole["valid"][1, :1] = True
    whole["valid"][3, :3] = True
    whole["mask_2d"] = whole["valid"].copy()
    sl = dp.shard(B) if dp is not None else slice(None)
    batch = {k: v[sl] for k, v in whole.items()}
    ccfg = CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes,
                           matcher=MatcherConfig(backend="jv"),
                           use_tfl=case == "add_data",
                           use_mask_loss=case == "add_data",
                           tfl_gather_k=8)
    opt = make_optimizer(model, 2e-4, 1e-4)
    gen = torch.Generator().manual_seed(7)
    if case != "dn":
        losses = make_train_step(model, ccfg, opt, data_parallel=dp)(
            batch, gen)
    else:
        group = dp.group if dp is not None else None
        dn_cfg = DNConfig(scalar=3, num_classes=model.num_classes)
        # the DN queries are drawn for the whole batch, each rank takes its
        # images' (prepare_dn's draws are per image and slot)
        t_all = targets_from_batch(whole, cpu)
        q = prepare_dn(torch.Generator().manual_seed(3), t_all.labels,
                       t_all.boxes_3d, t_all.valid,
                       model.num_queries * model.group_num, dn_cfg)
        q = DNQueries(q.label_ids[sl], q.refpoints[sl], q.valid[sl],
                      q.attn_mask, q.num_dn, q.num_groups)
        targets = targets_from_batch(batch, cpu)
        model.train()
        out = model(*[torch.as_tensor(batch[k], dtype=torch.float32)
                      for k in MODEL_INPUTS], generator=gen, dn_queries=q,
                    batch_shard=dp.batch_shard if dp is not None else None)
        loss_d = criterion(out, targets, ccfg, group=group)
        loss_d.update(dn_loss(out["dn_outputs"][-1], targets.labels,
                              targets.boxes_3d, targets.valid, dn_cfg,
                              group=group))
        loss_d["loss_total"] = (loss_d["loss_total"] + loss_d["tgt_loss_ce"]
                                + loss_d["tgt_loss_bbox"])
        opt.zero_grad(set_to_none=True)
        loss_d["loss_total"].backward()
        all_reduce_grads(model.parameters(), group)
        vals = global_sum(torch.stack([v.detach() for v in loss_d.values()]),
                          group).tolist()
        losses = dict(zip(loss_d, vals))
    grads = {n: p.grad.detach().numpy().copy()
             for n, p in model.named_parameters() if p.grad is not None}
    return losses, grads


def _rank_main(rank, store_path, out_dir, case):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        dp = from_process_group(B, torch.device("cpu"))
        assert (dp.rank, dp.size) == (rank, WORLD)
        losses, grads = _step(case, dp)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **grads)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(losses, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_two_gloo_ranks_take_the_one_process_step(case, tmp_path,
                                                  one_thread):
    _spawn(_rank_main, (str(tmp_path / "store"), str(tmp_path), case), WORLD)
    want_losses, want_grads = _step(case, None)
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.json") as f:
            losses = json.load(f)
        with np.load(tmp_path / f"rank{r}.npz") as z:
            grads = {k: z[k] for k in z.files}
        ranks.append((losses, grads))
    # every rank holds the same global loss dict and gradients
    assert ranks[0][0] == ranks[1][0]
    assert sorted(ranks[0][1]) == sorted(ranks[1][1]) == sorted(want_grads)
    for k in want_grads:
        np.testing.assert_array_equal(ranks[0][1][k], ranks[1][1][k])
    got_losses, got_grads = ranks[0]
    assert sorted(got_losses) == sorted(want_losses)
    loss_rel = {k: abs(got_losses[k] - v) / max(abs(v), 1e-6)
                for k, v in want_losses.items() if k != "grad_norm"}
    floor = 1e-4 * max(float(np.abs(g).max()) for g in want_grads.values())
    grad_rel = {k: float(np.abs(got_grads[k] - g).max())
                / max(float(np.abs(g).max()), floor)
                for k, g in want_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(json.dumps({"ddp_case": case, "loss_max_rel": max(
        loss_rel.values()), "grad_max_rel": grad_rel[worst],
        "grad_worst": worst, "grad_norm": [got_losses.get("grad_norm"),
                                           want_losses.get("grad_norm")]}))
    if case == "add_data":
        for k in ("loss_tfl", "loss_mask"):
            assert want_losses[k] > 0, (k, want_losses[k])
    if case == "dn":
        assert want_losses["tgt_loss_ce"] > 0
    if case == "two_stage":
        assert "loss_ce_enc" in want_losses
    assert max(loss_rel.values()) <= BAR, loss_rel
    assert grad_rel[worst] <= BAR, (worst, grad_rel[worst])


# ------------------------------------------- tools/train_val_torch.py run

def _run_cfg(root, save_path):
    return {"dataset": {"resolution": [W, H], "max_objs": 8,
                        "batch_size": B, "root_dir": root},
            "model": {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 64,
                      "dim_feedforward": 64, "nheads": 4, "num_queries": 10,
                      "num_depth_bins": 16},
            "trainer": {"max_epoch": 2, "save_path": save_path},
            "tester": {"threshold": 0.0, "topk": 10}}


def _run(root, save_path, dp, logs):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import train_val_torch

    from monosowa_tpu_torch.train.sample import SampleDataset

    cfg = _run_cfg(root, save_path)
    return train_val_torch.run(
        cfg, SampleDataset(8, cfg["dataset"]),
        SampleDataset(2, cfg["dataset"], first_id=8), "cpu",
        logger=logs.append, data_parallel=dp)


def _run_rank(rank, store_path, root, save_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        logs = []
        rec = _run(root, save_path, from_process_group(
            B, torch.device("cpu")), logs)
        with open(os.path.join(out_dir, f"run{rank}.json"), "w") as f:
            json.dump({"loss_total": [e["loss_total"] for e in
                                      rec["epochs"]],
                       "evaluated": len(rec["evaluated"]), "logs": logs},
                      f)
    finally:
        dist.destroy_process_group()


def test_run_on_two_ranks_steps_as_one_and_rank_0_alone_writes(tmp_path,
                                                               one_thread):
    """``run`` with a training group of two, two epochs of two steps: the
    first epoch's losses are the one process's (2e-4; the second epoch's
    are reported: AdamW turns the rounding noise of gradients that are 0
    in exact arithmetic, the key projections' biases, into steps of the
    learning rate, and the runs part), rank 0 writes the checkpoints and
    result files and evaluates, rank 1 neither logs, saves nor
    evaluates."""
    from monosowa_tpu_torch.train.sample import (SampleDataset,
                                                 write_sample_labels)

    root = str(tmp_path / "kitti")
    write_sample_labels(root + "/training/label_2",
                        SampleDataset(2, _run_cfg(root, "")["dataset"],
                                      first_id=8))
    _spawn(_run_rank, (str(tmp_path / "store"), root, str(tmp_path / "ddp"),
                       str(tmp_path)), WORLD)
    want = _run(root, str(tmp_path / "one"), None, [])
    runs = []
    for r in range(WORLD):
        with open(tmp_path / f"run{r}.json") as f:
            runs.append(json.load(f))
    assert runs[0]["loss_total"] == runs[1]["loss_total"]
    got = np.array(runs[0]["loss_total"])
    ref = np.array([e["loss_total"] for e in want["epochs"]])
    assert got.shape == ref.shape == (2, 2)
    print(json.dumps({"run_loss_total_rel": (
        np.abs(got - ref) / np.abs(ref)).tolist()}))
    np.testing.assert_allclose(got[0], ref[0], rtol=BAR)
    assert np.isfinite(got).all()
    assert runs[0]["evaluated"] == len(want["evaluated"]) == 2
    assert runs[1]["evaluated"] == 0 and runs[1]["logs"] == []
    assert runs[0]["logs"]
    assert sorted(os.listdir(tmp_path / "ddp")) == sorted(
        os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "ddp" / "outputs" / "data")) == [
        "000008.txt", "000009.txt"]
