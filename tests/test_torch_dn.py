"""DN-DETR in the torch port (``models/dn_components.py`` and
``MonoDETR.forward(..., dn_queries=)``) against the JAX package's.

``jax.random``'s draws cannot be made in torch, so the model comparison
hands the port the JAX ``prepare_dn`` arrays as numpy; the port's own
``prepare_dn`` is held to its contract instead (shapes, tiled targets,
noise bounds, label flips only where drawn).  Model sizes as in
tests/test_torch_detector_variants.py (10 queries x 2 groups, d_model 64),
3 DN groups of 4 slots, no dropout.  Tolerances: masks equal; the forward's
``dn_outputs`` and matchable outputs 2e-4 of each output's largest
magnitude; ``dn_loss`` 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models import depth_predictor as jax_dp
from monosowa_tpu.models import dn_components as jdn
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu_torch.convert import load_flax_params
from monosowa_tpu_torch.models import dn_components as dn
from monosowa_tpu_torch.models.monodetr import MonoDETR
from test_torch_detector_variants import (B, HEADS, TINY, TOL,
                                          _JaxDepthEncoderNoDropout, _close,
                                          _to_numpy, inputs, jax_variables,
                                          no_dropout)
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)

M = 4
DN_CFG = dict(scalar=3, label_noise_scale=0.2, box_noise_scale=0.4,
              num_classes=3)


def _targets(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, (B, M)).astype(np.int32)
    boxes = np.zeros((B, M, 6), np.float32)
    boxes[..., :2] = rng.uniform(0.3, 0.7, (B, M, 2))
    boxes[..., 2:] = rng.uniform(0.05, 0.2, (B, M, 4))
    valid = np.ones((B, M), bool)
    valid[1, 3] = False
    return labels, boxes, valid


@pytest.mark.parametrize("groups,size,match_groups,per_group", [
    (5, 50, 11, 50), (3, 4, 2, 10), (1, 7, 1, 3), (2, 1, 3, 2)])
def test_joint_attn_mask_equals_jax(groups, size, match_groups, per_group):
    want = np.asarray(jdn.build_joint_attn_mask(groups, size, match_groups,
                                                per_group))
    got = dn.build_joint_attn_mask(groups, size, match_groups,
                                   per_group).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups,size,queries", [(5, 50, 550), (3, 4, 20),
                                                 (1, 2, 1)])
def test_dn_attn_mask_equals_jax(groups, size, queries):
    want = np.asarray(jdn.build_dn_attn_mask(groups, size, queries))
    got = dn.build_dn_attn_mask(groups, size, queries).numpy()
    np.testing.assert_array_equal(got, want)


def test_prepare_dn_contract():
    """Shapes, tiled targets and validity, box noise within
    +-box_noise_scale of each coordinate's extent and clamped to [0, 1],
    labels changed only where the flip was drawn, the mask of
    build_dn_attn_mask; one generator seed gives one draw."""
    labels, boxes, valid = (torch.from_numpy(a) for a in _targets(1))
    cfg = dn.DNConfig(**DN_CFG)
    g = cfg.scalar
    q = dn.prepare_dn(torch.Generator().manual_seed(0), labels, boxes, valid,
                      20, cfg)
    assert q.num_dn == g * M and q.num_groups == g
    assert q.label_ids.shape == (B, g * M) and q.refpoints.shape == (
        B, g * M, 6)
    assert torch.equal(q.valid, valid.repeat(1, g))
    assert torch.equal(q.attn_mask, dn.build_dn_attn_mask(g, M, 20))
    known = boxes.repeat(1, g, 1)
    extent = torch.cat([((known[..., 2] + known[..., 3]) / 2)[..., None],
                        ((known[..., 4] + known[..., 5]) / 2)[..., None],
                        known[..., 2:]], -1)
    bound = cfg.box_noise_scale * extent + 1e-6
    assert bool(((q.refpoints - known).abs() <= bound).all())
    assert bool(((q.refpoints >= 0) & (q.refpoints <= 1)).all())
    assert not torch.equal(q.refpoints, known)
    # the draws in prepare_dn's order: flips, random labels, box noise
    gen = torch.Generator().manual_seed(0)
    p = torch.rand(q.label_ids.shape, generator=gen)
    flipped = p < cfg.label_noise_scale
    assert bool((q.label_ids[~flipped] == labels.repeat(1, g)[~flipped])
                .all())
    assert bool(((q.label_ids >= 0) & (q.label_ids < 3)).all())
    assert 0 < int(flipped.sum()) < flipped.numel()
    again = dn.prepare_dn(torch.Generator().manual_seed(0), labels, boxes,
                          valid, 20, cfg)
    assert torch.equal(again.label_ids, q.label_ids)
    assert torch.equal(again.refpoints, q.refpoints)


def test_dn_loss_matches_jax():
    labels, boxes, valid = _targets(2)
    rng = np.random.default_rng(3)
    n = DN_CFG["scalar"] * M
    out = {"pred_logits": rng.normal(size=(B, n, 3)).astype(np.float32),
           "pred_boxes": rng.uniform(0, 1, (B, n, 6)).astype(np.float32)}
    want = jdn.dn_loss({k: jnp.asarray(v) for k, v in out.items()},
                       jnp.asarray(labels), jnp.asarray(boxes),
                       jnp.asarray(valid), jdn.DNConfig(**DN_CFG))
    got = dn.dn_loss({k: torch.from_numpy(v) for k, v in out.items()},
                     torch.from_numpy(labels), torch.from_numpy(boxes),
                     torch.from_numpy(valid), dn.DNConfig(**DN_CFG))
    assert sorted(got) == sorted(want) == ["tgt_loss_bbox", "tgt_loss_ce"]
    for k in want:
        _close(float(got[k]), float(want[k]), TOL, f"dn_loss {k}")


@pytest.fixture(scope="module", params=["base", "two_stage"])
def dn_run(request):
    """Both models in training mode with the JAX package's DN queries."""
    flags = {"two_stage": True} if request.param == "two_stage" else {}
    args = inputs()
    labels, boxes, valid = _targets()
    jq = jdn.prepare_dn(jax.random.PRNGKey(7), jnp.asarray(labels),
                        jnp.asarray(boxes), jnp.asarray(valid),
                        num_queries=TINY["num_queries"],
                        cfg=jdn.DNConfig(**DN_CFG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dp, "DepthEncoderLayer", _JaxDepthEncoderNoDropout)
        jm = JaxMonoDETR(msda_backend="xla", compute_dtype="float32",
                         dropout=0.0, **TINY, **flags)
        v = jax_variables(jm, args, first_image=False, training=True,
                          dn_queries=jq)
        v["params"]["label_enc"] = np.random.default_rng(9).normal(
            size=v["params"]["label_enc"].shape).astype(np.float32)
        j_out = _to_numpy(jax.jit(lambda v, *a: jm.apply(
            v, *a, training=True, dn_queries=jq,
            rngs={"dropout": jax.random.PRNGKey(0)}))(v, *args))
        j_eval = _to_numpy(jax.jit(lambda v, *a: jm.apply(v, *a))(v, *args))
    tm = no_dropout(MonoDETR(device="cpu", dropout=0.0, use_dn=True,
                             **TINY, **flags))
    load_flax_params(tm, v["params"], v["frozen"])
    tq = dn.DNQueries(label_ids=torch.from_numpy(np.array(jq.label_ids)),
                      refpoints=torch.from_numpy(np.array(jq.refpoints)),
                      valid=torch.from_numpy(np.array(jq.valid)),
                      attn_mask=torch.from_numpy(np.array(jq.attn_mask)),
                      num_dn=jq.num_dn, num_groups=jq.num_groups)
    tm.train()
    with torch.no_grad():
        t_out = tm(*[torch.from_numpy(a) for a in args], dn_queries=tq)
    tm.eval()
    with torch.no_grad():
        t_eval = tm(*[torch.from_numpy(a) for a in args], dn_queries=tq)
    return dict(name=request.param, j_out=j_out, t_out=t_out,
                j_eval=j_eval, t_eval=t_eval)


def test_dn_outputs_match_jax(dn_run):
    t, j = dn_run["t_out"], dn_run["j_out"]
    n = DN_CFG["scalar"] * M
    assert len(t["dn_outputs"]) == len(j["dn_outputs"]) == TINY["dec_layers"]
    for lid, (tl, jl) in enumerate(zip(t["dn_outputs"], j["dn_outputs"])):
        for key in ("pred_logits", "pred_boxes"):
            assert tl[key].shape[1] == n
            _close(tl[key].numpy(), jl[key], TOL,
                   f"dn {dn_run['name']} layer {lid} {key}")


@pytest.mark.parametrize("key", HEADS)
def test_matchable_outputs_with_dn_match_jax(dn_run, key):
    t, j = dn_run["t_out"], dn_run["j_out"]
    nq = TINY["num_queries"] * TINY["group_num"]
    assert t[key].shape[1] == nq
    _close(t[key].numpy(), j[key], TOL, f"dn {dn_run['name']} {key}")
    _close(t["aux_outputs"][0][key].numpy(), j["aux_outputs"][0][key], TOL,
           f"dn {dn_run['name']} aux {key}")


def test_eval_mode_ignores_dn_queries(dn_run):
    """DN queries act in training mode only, as in the JAX package."""
    t, j = dn_run["t_eval"], dn_run["j_eval"]
    assert "dn_outputs" not in t and "dn_outputs" not in j
    assert t["pred_logits"].shape == (B, TINY["num_queries"], 3)
    _close(t["pred_boxes"].numpy(), j["pred_boxes"], TOL,
           f"dn {dn_run['name']} eval pred_boxes")
