"""CUDA graphs of Mask2Former's trunk and pixel decoder
(``monosowa_tpu_torch/utils/graphs.py``).

On the CPU: the graphs never engage, whatever else holds (gradients, train
mode, a forward hook or pre-hook on a module of a stage, a global hook),
and each such call equals the plain eager one; the engagement rule's
predicates name the reason; a module or parameter set anew drops a
stage's graphs; the tracer's ``counts_kept``; ``note`` and the shared
table cache; a copy of the network starts without graphs.

On the card (the ``cuda`` fixture; skipped without one), the full Swin-B
configuration at 384 x 1280 with seeded weights: graphed and eager logits
equal bit for bit over frames of different content; two captures once, two
replays and six K1 launches a frame; a weight copied in in place, a
parameter's storage or the parameter replaced, a hooked trunk, the table
cache cleared after capture.  The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_graphs.py -q
"""

import copy
import gc
import pickle

import pytest
import torch

from monosowa_tpu_torch.models import mask2former, swin
from monosowa_tpu_torch.models import zoo_layers as zl
from monosowa_tpu_torch.utils import graphs, timing

CAPTURES, REPLAYS, K1 = "graph.captures", "graph.replays", "msda.fwd_launches"

TINY = mask2former.Mask2FormerConfig(
    backbone=swin.SwinConfig(embed_dim=16, depths=(1, 1, 2, 1),
                             num_heads=(1, 2, 4, 8), window_size=4),
    feature_size=32, mask_feature_size=32, hidden_dim=32, encoder_layers=2,
    decoder_layers=3, num_attention_heads=2, encoder_feedforward_dim=32,
    dim_feedforward=32, num_queries=6, num_labels=3)
# facebook/mask2former-swin-base-coco-instance, as the mask cell runs it
SWIN_B = mask2former.Mask2FormerConfig(backbone=swin.SwinConfig(
    embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
    window_size=12))
SWIN_B_HW = (384, 1280)


def _counts():
    return tuple(timing.counter(n) for n in (CAPTURES, REPLAYS))


def _frames(n, hw, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(1, *hw, 3, generator=gen).to(dev) for _ in range(n)]


def _eager(model, x):
    """The three stages called one by one: no graph."""
    mask_features, multi_scale = model.pixel_decoder(model.backbone(x))
    classes, masks = model.transformer(multi_scale, mask_features)
    return classes[-1], masks[-1]


# ------------------------------------------------------------------ CPU

def test_the_rule_engages_on_a_plain_inference_call():
    """The control of the cases below: under no_grad, in eval mode and
    without hooks only the device keeps a CPU call eager."""
    model = mask2former.Mask2Former(TINY, device="cpu")
    x = _frames(1, (64, 96), "cpu")[0]
    with torch.no_grad():
        assert graphs._replay_allowed()
    assert not graphs._on_card([x])
    for stage in (model.backbone, model.pixel_decoder):
        s = graphs._Stage(stage)
        assert not graphs._blocked(s)
        assert s.tensors == tuple(stage.parameters())


CASES = ["cpu", "gradients", "train mode", "hook on the trunk",
         "pre-hook on the trunk", "hook on a pixel decoder layer",
         "global hook", "global pre-hook"]


@pytest.mark.parametrize("case", CASES)
def test_a_call_the_graphs_must_not_serve_runs_eagerly(case):
    model = mask2former.Mask2Former(TINY, device="cpu")
    x = _frames(1, (64, 96), "cpu")[0]
    calls = []
    handles = []
    hook = (lambda *a: calls.append(1))
    if case == "train mode":
        model.train()
    elif case == "hook on the trunk":
        handles.append(model.backbone.stage_2.block_1.attn
                       .register_forward_hook(hook))
    elif case == "pre-hook on the trunk":
        handles.append(model.backbone.register_forward_pre_hook(hook))
    elif case == "hook on a pixel decoder layer":
        handles.append(model.pixel_decoder.encoder_layers[1]
                       .register_forward_hook(hook))
    elif case == "global hook":
        handles.append(torch.nn.modules.module.register_module_forward_hook(
            hook))
    elif case == "global pre-hook":
        handles.append(
            torch.nn.modules.module.register_module_forward_pre_hook(hook))
    before = _counts()
    try:
        with torch.set_grad_enabled(case == "gradients"):
            got = [model(x) for _ in range(3)]
            want = _eager(model, x)
            allowed = graphs._replay_allowed()
        blocked = [graphs._blocked(graphs._Stage(s))
                   for s in (model.backbone, model.pixel_decoder)]
    finally:
        for h in handles:
            h.remove()
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    assert _counts() == before == (0, 0)
    assert not graphs._on_card([x])
    # the reason the rule gives besides the device
    if case in ("gradients", "global hook", "global pre-hook"):
        assert not allowed
    elif case == "train mode":
        assert blocked == [True, True]
    elif case in ("hook on the trunk", "pre-hook on the trunk"):
        assert blocked == [True, False]
    elif case == "hook on a pixel decoder layer":
        assert blocked == [False, True]
    if case not in ("cpu", "gradients", "train mode"):
        assert calls


def test_a_module_or_parameter_set_anew_drops_the_stages_graphs():
    """torch's registration hooks tell the stage's table to read the stage
    anew; a module or parameter set anew changes what it reads, and the
    stage's graphs go (a fake graph stands for one here)."""
    model = mask2former.Mask2Former(TINY, device="cpu")
    sg = model.graphs
    fc = model.backbone.stage_0.block_0.fc1
    for change in ("unrelated", "parameter", "module"):
        before = sg._stage(model.backbone)
        g = graphs._Graph()
        g.outputs = []
        sg._graphs[(id(model.backbone), "layout")] = g
        sg._graphs[(id(model.pixel_decoder), "layout")] = g
        if change == "unrelated":
            torch.nn.Linear(2, 2)
        elif change == "parameter":
            fc.weight = torch.nn.Parameter(fc.weight.detach().clone())
        else:
            model.backbone.stage_0.block_0.fc2 = torch.nn.Linear(
                fc.out_features, fc.in_features)
        after = sg._stage(model.backbone)
        assert after is not before
        kept = (id(model.backbone), "layout") in sg._graphs
        assert kept == (change == "unrelated")
        assert (id(model.pixel_decoder), "layout") in sg._graphs
        assert sg._stage(model.backbone) is after
    assert after.tensors == tuple(model.backbone.parameters())


def test_counts_kept_go_to_their_table_alone():
    tr = timing.Tracer()
    with tr.unit("u"):
        tr.count("a")
        with tr.counts_kept() as kept:
            tr.count("a", 5)
            tr.count("b")
        tr.count("b", 2)
    assert kept == {"a": 5, "b": 1}
    assert tr.records[-1].counts == {"a": 1, "b": 2}
    assert tr.counter("a") == 1 and tr.counter("b") == 2


def test_a_capture_notes_the_tables_it_reads():
    fn, args = mask2former._sine_pos, (3, 5, 4)
    graphs.note("outside")          # nothing collects it
    notes = []
    graphs._NOTES.notes = notes
    try:
        t = zl.constant(fn, args, torch.device("cpu"))
    finally:
        graphs._NOTES.notes = None
    assert notes == [t] and zl.constant(fn, args, torch.device("cpu")) is t
    # the shared cache may drop the table; what the capture noted stays
    zl._constant.cache_clear()
    again = zl.constant(fn, args, torch.device("cpu"))
    assert again is not t and torch.equal(again, t) and notes == [t]


def test_a_copy_of_the_network_starts_without_graphs():
    model = mask2former.Mask2Former(TINY, device="cpu")
    model.graphs._seen[("key",)] = []
    for other in (copy.deepcopy(model).graphs,
                  pickle.loads(pickle.dumps(model.graphs))):
        assert isinstance(other, graphs.StageGraphs)
        assert other is not model.graphs and not other._seen


# ----------------------------------------------------------------- card

@pytest.fixture
def swin_b():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from monosowa_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")        # TF32 off, as the entry points
    model = mask2former.Mask2Former(SWIN_B, device=dev, seed=0)
    yield model, dev
    del model
    gc.collect()
    torch.cuda.empty_cache()


def _forward(model, x):
    with torch.no_grad():
        return [t.clone() for t in model(x)]


def _same(a, b):
    return all(torch.equal(p, q) for p, q in zip(a, b))


def _captured(model, frames):
    """Two forwards: the first eager, the second captures."""
    for x in frames[:2]:
        _forward(model, x)
    assert len(model.graphs._graphs) == 2


def test_graphed_forward_equals_eager_bit_for_bit(swin_b):
    model, dev = swin_b
    frames = _frames(3, SWIN_B_HW, dev)
    # eager, capture, replays; frames of other content each time, then
    # the first again: the static input is refreshed
    for i in (0, 1, 2, 0, 1):
        got = _forward(model, frames[i])
        with torch.no_grad():
            want = _eager(model, frames[i])
        assert _same(got, want), i
    assert not _same(_forward(model, frames[0]), _forward(model, frames[1]))


def test_two_captures_once_two_replays_and_six_k1_launches_a_frame(swin_b):
    model, dev = swin_b
    frames = _frames(4, SWIN_B_HW, dev, seed=1)
    before = _counts()
    recs = []
    for x in frames:
        with timing.unit("graphs.frame"):
            _forward(model, x)
        recs.append(timing.TRACER.records[-1])
    assert [r.counts.get(CAPTURES, 0) for r in recs] == [0, 2, 0, 0]
    assert [r.counts.get(REPLAYS, 0) for r in recs] == [0, 2, 2, 2]
    assert [r.counts[K1] for r in recs] == [SWIN_B.encoder_layers] * 4
    assert _counts() == (before[0] + 2, before[1] + 6)


def test_a_weight_copied_in_in_place_reaches_the_replay(swin_b):
    model, dev = swin_b
    frames = _frames(3, SWIN_B_HW, dev, seed=2)
    _captured(model, frames)
    old = _forward(model, frames[2])
    with torch.no_grad():
        model.backbone.stage_2.block_5.fc1.weight.mul_(1.5)
        model.pixel_decoder.encoder_layers[3].value_proj.weight.copy_(
            torch.randn_like(
                model.pixel_decoder.encoder_layers[3].value_proj.weight))
    captures = _counts()[0]
    got = _forward(model, frames[2])
    with torch.no_grad():
        want = _eager(model, frames[2])
    assert _same(got, want) and not _same(got, old)
    assert _counts()[0] == captures


@pytest.mark.parametrize("how", ["storage", "object"])
def test_a_parameter_given_new_storage_is_captured_anew(swin_b, how):
    model, dev = swin_b
    frames = _frames(3, SWIN_B_HW, dev, seed=3)
    _captured(model, frames)
    fc = model.backbone.stage_1.block_0.fc2
    if how == "storage":
        fc.weight.data = fc.weight.data * 0.5
    else:
        fc.weight = torch.nn.Parameter(fc.weight.detach() * 0.5)
    before = _counts()
    for i, x in enumerate(frames):
        got = _forward(model, x)
        with torch.no_grad():
            want = _eager(model, x)
        assert _same(got, want), i
    # the trunk's new key: eager, then captured and replayed twice; the
    # pixel decoder replays throughout
    assert _counts() == (before[0] + 1, before[1] + 3 + 2)
    assert len(model.graphs._graphs) == 2


def test_a_hooked_trunk_runs_eagerly_and_its_hook_fires(swin_b):
    model, dev = swin_b
    frames = _frames(3, SWIN_B_HW, dev, seed=4)
    _captured(model, frames)
    fired = []
    handle = model.backbone.register_forward_hook(
        lambda *a: fired.append(1))
    try:
        before = _counts()
        got = _forward(model, frames[2])
        with torch.no_grad():
            want = _eager(model, frames[2])
    finally:
        handle.remove()
    assert len(fired) == 2          # the graphed forward and the eager one
    assert _same(got, want)
    assert _counts() == (before[0], before[1] + 1)  # the pixel decoder


def test_the_replay_holds_the_tables_it_reads(swin_b):
    """After capture the shared table cache is cleared and tensors of the
    tables' sizes are filled with NaN, where freed tables would be reused:
    the replay reads the tables the graph holds."""
    model, dev = swin_b
    frames = _frames(3, SWIN_B_HW, dev, seed=5)
    _captured(model, frames)
    want = _forward(model, frames[2])
    kept = [t for g in model.graphs._graphs.values() for t in g.keep
            if isinstance(t, torch.Tensor)]
    assert len(kept) >= 4
    zl._constant.cache_clear()
    gc.collect()
    junk = [torch.full_like(t, float("nan")) if t.is_floating_point()
            else torch.full_like(t, -1) for t in kept for _ in range(4)]
    got = _forward(model, frames[2])
    del junk
    assert _same(got, want)
