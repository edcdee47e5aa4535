"""The port's SAM (``models/sam.py``), its refinement backend and
``refine_masks`` (``sowa/masks.py``), the ``sam`` zoo checkpoint kind
(``sowa/zoo.py``) and the CLI's ``mask_tracking`` with ``use_SAM``,
against the JAX package's, on the CPU.

The same weights on both sides: the port's seeded tree (``convert.
zoo_params``) with its kernels at unit gain and its biases, norm scales
and raw tables drawn (at the initialisers' 0.02 every logit sits near 0),
handed to the JAX functions.  Tiny widths: hidden 32, 3 layers (layer 1
global), window 4 on a 6 x 6 grid (padded to 8), decoder hidden 16; a
configuration without the absolute position table runs at other input
sizes, so the global layer's relative-position tables are resized.

Tolerance: 2e-5 of each output's magnitude (the zoo's bar, ``tests/
test_torch_depth_anything.py``); the written masks equal (the flips, 0
so far, are printed).  With ``transformers`` installed, a tiny
``SamModel`` goes through the JAX importer and checkpoint into the port."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from monosowa_tpu.models import sam as jsam
from monosowa_tpu.sowa import cli as jcli
from monosowa_tpu.sowa import masks as jmasks
from monosowa_tpu.sowa import zoo as jzoo
from monosowa_tpu_torch.config import Config
from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
from monosowa_tpu_torch.models import mask2former as m2f
from monosowa_tpu_torch.models import sam
from monosowa_tpu_torch.sowa import cli, masks, zoo

from test_torch_swin_mask2former import CFG as M2F_CFG
from test_torch_swin_mask2former import car_bias

pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

TOL = 2e-5
VISION = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
              image_size=96, patch_size=16, window_size=4,
              global_attn_indexes=(1,), output_channels=16, mlp_dim=64)
DECODER = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=2,
               mlp_dim=32, iou_head_hidden_dim=16)
PROMPT = dict(prompt_image_size=96, embedding_size=6)


def configs(**vision):
    """(JAX SamConfig, port SamConfig) of the test widths."""
    vc = {**VISION, **vision}
    return (jsam.SamConfig(vision=jsam.SamVisionConfig(**vc),
                           decoder=jsam.SamDecoderConfig(**DECODER),
                           **PROMPT),
            sam.SamConfig(vision=sam.SamVisionConfig(**vc),
                          decoder=sam.SamDecoderConfig(**DECODER), **PROMPT))


def random_tree(cfg, seed=0):
    """The port's seeded tree with each kernel at std 1 / sqrt(fan in),
    biases N(0, 0.1), norm scales 1 + N(0, 0.1) and raw tables N(0,
    0.5)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        shape = node.shape
        if key == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif key == "bias":
            v = 0.1 * rng.normal(size=shape)
        else:
            v = 0.5 * rng.normal(size=shape)
        return v.astype(np.float32)

    return walk(zoo_params(sam.Sam(cfg, device="cpu", seed=seed)))


def port_model(cfg, tree):
    return load_zoo_params(sam.Sam(cfg, device="cpu", seed=7), tree)


def close(got, want, what, tol=TOL, floor=0.1):
    """got within ``tol`` of want's magnitude, which must exceed ``floor``
    (the outputs do not all sit near 0)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(json.dumps({"sam": what, "max_abs_err": err, "scale": scale}))
    assert scale > floor and err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def nets():
    jcfg, cfg = configs()
    tree = random_tree(cfg)
    return jcfg, cfg, tree, port_model(cfg, tree)


def _pixels(s, b=1, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(
        np.float32)


BOXES = np.array([[[3.0, 4.0, 50.0, 60.0], [10.0, 0.0, 95.0, 40.0],
                   [0.0, 0.0, 95.0, 95.0]],
                  [[20.5, 30.0, 70.0, 90.0], [5.0, 5.0, 12.0, 30.0],
                   [40.0, 2.0, 60.0, 80.0]]], np.float32)


def test_tree_round_trip(nets):
    """zoo_params -> load_zoo_params -> zoo_params gives the tree back,
    the JAX importer's lists (``hyper_mlps``, ``iou_head/layers``)
    included; the JAX checkpoint format carries it both ways."""
    _, cfg, tree, model = nets
    back = zoo_params(model)
    assert isinstance(back["decoder"]["hyper_mlps"], list)
    assert len(back["decoder"]["hyper_mlps"]) == 4
    assert isinstance(back["decoder"]["iou_head"]["layers"], list)
    flat, want = zoo.flatten_params(back), zoo.flatten_params(tree)
    assert flat.keys() == want.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k])
    # the (hw, 3, heads, d) qkv layout and the transposed convolutions'
    # (kh, kw, in, out) kernels are the JAX tree's
    assert tree["vision"]["layer_0"]["attn"]["qkv"]["kernel"].shape == \
        (32, 96)
    assert tree["decoder"]["upscale_conv1"]["kernel"].shape == (2, 2, 16, 4)
    assert tree["vision"]["layer_1"]["attn"]["rel_pos_h"].shape == (11, 16)
    assert tree["vision"]["layer_0"]["attn"]["rel_pos_h"].shape == (7, 16)


def test_vision_encoder_matches_jax(nets):
    """Windows of 4 on the 6 x 6 grid (padded to 8 after norm1, the
    padded tokens attending unmasked) and the global layer 1."""
    jcfg, cfg, tree, model = nets
    x = _pixels(96, b=2)
    with torch.no_grad():
        got = model.vision_forward(torch.from_numpy(x))
    want = jsam.sam_vision_forward(tree["vision"], jnp.asarray(x),
                                   jcfg.vision)
    close(got, want, "vision encoder")


@pytest.mark.parametrize("side", [64, 128])
def test_rel_pos_tables_resized_as_jax(side):
    """Without the absolute table the encoder runs at another input
    size: the global layer's 11-row tables resized to 7 or 15 rows with
    torch's linear rule, the JAX package's matrix."""
    jcfg, cfg = configs(use_abs_pos=False)
    tree = random_tree(cfg, seed=3)
    model = port_model(cfg, tree)
    x = _pixels(side, seed=side)
    with torch.no_grad():
        got = model.vision_forward(torch.from_numpy(x))
    want = jsam.sam_vision_forward(tree["vision"], jnp.asarray(x),
                                   jcfg.vision)
    close(got, want, f"vision encoder at {side}")
    table = torch.from_numpy(tree["vision"]["layer_1"]["attn"]["rel_pos_h"])
    n = side // 16
    close(sam._interp_rel_pos(table, n),
          jsam._interp_rel_pos(jnp.asarray(table.numpy()), n),
          f"rel-pos table to {2 * n - 1} rows")


def test_prompt_encoder_matches_jax(nets):
    """Box corners (box + 0.5) / 96 through the Fourier table plus
    point_embed[2] / [3]; the image PE in (x, y) order."""
    jcfg, cfg, tree, model = nets
    with torch.no_grad():
        close(model.embed_boxes(torch.from_numpy(BOXES)),
              jsam.sam_embed_boxes(tree["prompt"], jnp.asarray(BOXES), jcfg),
              "box embedding")
        close(model.image_pe(), jsam.sam_image_pe(tree["prompt"], jcfg),
              "image PE")


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(nets, multimask):
    """The two-way decoder on the same embeddings and prompts."""
    jcfg, cfg, tree, model = nets
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(2, 6, 6, 16)).astype(np.float32)
    sparse = rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
    dense = rng.normal(size=(2, 6, 6, 16)).astype(np.float32)
    pe = rng.normal(size=(1, 6, 6, 16)).astype(np.float32)
    with torch.no_grad():
        got = model.mask_decoder(*(torch.from_numpy(a) for a in
                                   (emb, pe, sparse, dense)), multimask)
    want = jsam.sam_mask_decoder(tree["decoder"], *(jnp.asarray(a) for a in
                                                    (emb, pe, sparse,
                                                     dense)),
                                 jcfg, multimask)
    close(got[0], want[0], f"decoder masks, multimask {multimask}")
    close(got[1], want[1], f"decoder iou, multimask {multimask}")


@pytest.mark.parametrize("multimask", [False, True])
def test_predict_boxes_matches_jax(nets, multimask):
    jcfg, cfg, tree, model = nets
    x = _pixels(96, b=2, seed=9)
    with torch.no_grad():
        masks_t, iou_t = model.predict_boxes(torch.from_numpy(x),
                                             torch.from_numpy(BOXES),
                                             multimask)
    masks_j, iou_j = jsam.sam_predict_boxes(tree, jnp.asarray(x),
                                            jnp.asarray(BOXES), jcfg,
                                            multimask)
    assert masks_t.shape == (2, 3, 3 if multimask else 1, 24, 24)
    close(masks_t, masks_j, f"low-res masks, multimask {multimask}")
    close(iou_t, iou_j, f"iou, multimask {multimask}")


def _flips(got, want):
    assert len(got) == len(want)
    return sum(int((np.asarray(a) != np.asarray(b)).sum())
               for a, b in zip(got, want))


def test_refine_backend_matches_jax(nets):
    """``SamRefineBackend.refine`` against ``FlaxSamRefineBackend`` on a
    72 x 120 frame (resized to 58 x 96 and padded to 96), 5 boxes in
    chunks of 3; ``refine_masks`` replaces only the eligible masks."""
    jcfg, cfg, tree, _ = nets
    port = masks.SamRefineBackend(tree, cfg, max_boxes=3, device="cpu")
    ref = jmasks.FlaxSamRefineBackend(tree, jcfg, max_boxes=3)
    img = np.random.default_rng(11).integers(0, 256, (72, 120, 3), np.uint8)
    padded, hw, scale = port._encode(img)
    want_padded, want_hw, want_scale = ref._encode(img)
    assert hw == want_hw == (58, 96) and scale == want_scale
    np.testing.assert_allclose(padded.numpy(), want_padded, atol=1e-6)
    boxes = np.array([[2, 2, 60, 50], [10, 4, 118, 70], [0, 0, 119, 71],
                      [5, 5, 30, 30], [70, 20, 100, 60]], np.int64)
    got, want = port.refine(img, boxes), ref.refine(img, boxes)
    assert all(m.shape == (72, 120) and m.dtype == bool for m in got)
    flips = _flips(got, want)
    filled = [float(m.mean()) for m in got]
    print(json.dumps({"refine_flips": flips, "mask_fill": filled}))
    assert flips == 0 and 0 < min(filled) and max(filled) < 1
    assert port.refine(img, np.zeros((0, 4), np.int64)) == []

    coarse = [np.zeros((72, 120), bool) for _ in range(4)]
    for i, b in enumerate(boxes[:3]):
        coarse[i][b[1]:b[3], b[0]:b[2]] = True
    scores = [0.9, 0.5, 0.95, 0.99]          # the last mask is empty
    out = masks.refine_masks(coarse, scores, img, port)
    out_j = jmasks.refine_masks(coarse, scores, img, ref)
    assert out[1] is coarse[1] and out[3] is coarse[3]
    assert _flips(out, out_j) == 0
    assert not np.array_equal(out[0], coarse[0])


def test_jax_checkpoint_loads_into_the_port(nets, tmp_path):
    """A ``sam`` checkpoint written by the JAX ``save_checkpoint`` loads
    unchanged (``global_attn_indexes`` back from JSON), through
    ``zoo.sam_refine_backend`` from ``paths.sam_path`` or
    ``backends.sam_checkpoint``; the port's loads in the JAX package."""
    jcfg, cfg, tree, model = nets
    path = str(tmp_path / "sam.npz")
    jzoo.save_checkpoint(path, "sam", tree, jcfg)
    kind, got_tree, got_cfg = zoo.load_checkpoint(path)
    assert kind == "sam" and isinstance(got_cfg, sam.SamConfig)
    assert got_cfg == cfg
    assert got_cfg.vision.global_attn_indexes == (1,)
    for conf in ({"paths": {"sam_path": path}},
                 {"backends": {"sam_checkpoint": path}}):
        backend = zoo.sam_refine_backend(Config(
            {"frames_creation": {"use_SAM": True}, **conf}), device="cpu")
        assert isinstance(backend, masks.SamRefineBackend)
        assert backend.max_boxes == 16
    x = _pixels(96, seed=2)
    with torch.no_grad():
        got = backend.model.predict_boxes(torch.from_numpy(x),
                                          torch.from_numpy(BOXES[:1]))
    want = jsam.sam_predict_boxes(tree, jnp.asarray(x),
                                  jnp.asarray(BOXES[:1]), jcfg)
    close(got[0], want[0], "JAX checkpoint masks")
    out = str(tmp_path / "port.npz")
    zoo.save_checkpoint(out, "sam", zoo_params(model), cfg)
    jkind, jtree, jc = jzoo.load_checkpoint(out)
    assert jkind == "sam" and jc == jcfg
    flat, want_flat = jzoo.flatten_params(jtree), zoo.flatten_params(tree)
    assert flat.keys() == want_flat.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], want_flat[k])
    with pytest.raises(ValueError, match="sam_path"):
        zoo.sam_refine_backend(Config({"frames_creation": {"use_SAM": True}}))
    assert zoo.sam_refine_backend(Config(
        {"frames_creation": {"use_SAM": False}})) is None


def test_hf_sam_through_the_jax_importer(tmp_path):
    """A tiny ``transformers.SamModel`` (the configuration of
    ``tests/test_sam_parity.py``) imported by ``import_hf_sam``, written
    by the JAX ``save_checkpoint`` and loaded by the port: its masks and
    IoU against the JAX forward (2e-5) and against transformers (the JAX
    parity test's 5e-4 / 2e-4)."""
    transformers = pytest.importorskip("transformers")
    from test_sam_parity import _tiny_hf_config

    hf_cfg = _tiny_hf_config()
    torch.manual_seed(0)
    hf = transformers.SamModel(hf_cfg).eval()
    jcfg = jsam.config_from_hf_sam(hf_cfg)
    tree = jsam.import_hf_sam(hf.state_dict(), jcfg)
    path = str(tmp_path / "hf_sam.npz")
    jzoo.save_checkpoint(path, "sam", tree, jcfg)
    _, ptree, pcfg = zoo.load_checkpoint(path)
    model = port_model(pcfg, ptree)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 32, 32, generator=g)
    boxes = torch.tensor([[[2.0, 3.0, 20.0, 28.0], [8.0, 1.0, 30.0, 12.0]],
                          [[0.0, 0.0, 31.0, 31.0], [5.0, 5.0, 9.0, 22.0]]])
    with torch.no_grad():
        out = hf(pixel_values=x, input_boxes=boxes, multimask_output=False)
        got = model.predict_boxes(x.permute(0, 2, 3, 1), boxes)
    want = jsam.sam_predict_boxes(tree, jnp.asarray(x.numpy().transpose(
        0, 2, 3, 1)), jnp.asarray(boxes.numpy()), jcfg)
    # transformers' initialisers leave the masks near 1e-5
    close(got[0], want[0], "HF checkpoint masks vs JAX", floor=0.0)
    close(got[1], want[1], "HF checkpoint iou vs JAX", floor=0.0)
    np.testing.assert_allclose(got[0].numpy(), out.pred_masks.numpy(),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), out.iou_scores.numpy(),
                               atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the CLI's mask_tracking with use_SAM, port and JAX driver
# ---------------------------------------------------------------------------

H, W = 72, 120
FIDS = ["000000", "000001"]
MASK_HW = (64, 96)
# the detector's threshold for both label groups, 0.003 or more from every
# query's person probability; the cars SAM refines are those above 0.7
# (refine_masks' threshold), 0.006 or more from every car probability
THRESHOLD = 0.2625


def frame_image(i):
    rng = np.random.default_rng(200 + i)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255 / W, yy * 255 / H,
                     127 + 100 * np.sin(xx / 7.0 + i)], -1)
    return np.clip(base + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def kitti_sam(tmp_path_factory, nets):
    """A KITTI tree of two frames, a Mask2Former checkpoint whose car and
    person biases pass THRESHOLD for some queries of frame 0, and a SAM
    checkpoint written by the JAX package."""
    jcfg, _, tree, _ = nets
    root = tmp_path_factory.mktemp("kitti_sam")
    kd = root / "kitti"
    (kd / "training" / "image_2").mkdir(parents=True)
    (kd / "training" / "calib").mkdir(parents=True)
    p2 = "100.0 0 60.0 0 0 100.0 36.0 0 0 0 1 0"
    calib = "\n".join([f"P{i}: {p2}" for i in range(4)]
                      + ["R0_rect: 1 0 0 0 1 0 0 0 1",
                         "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0",
                         "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n"
    for i, fid in enumerate(FIDS):
        Image.fromarray(frame_image(i)).save(
            kd / "training" / "image_2" / f"{fid}.png")
        (kd / "training" / "calib" / f"{fid}.txt").write_text(calib)
    mtree = zoo_params(m2f.Mask2Former(M2F_CFG, device="cpu", seed=0))
    bias = mtree["transformer"]["class_predictor"]["bias"]
    img = frame_image(0)
    bias[2] += car_bias(mtree, M2F_CFG, img, MASK_HW, quantile=0.5,
                        target=0.88)
    bias[0] += car_bias(mtree, M2F_CFG, img, MASK_HW, label=0, quantile=0.3,
                        target=0.25)
    mpath, spath = str(root / "mask.npz"), str(root / "sam.npz")
    zoo.save_checkpoint(mpath, "mask2former", mtree, M2F_CFG)
    jzoo.save_checkpoint(spath, "sam", tree, jcfg)
    return root, mpath, spath


def test_cli_mask_tracking_with_sam_matches_jax(kitti_sam):
    """`--action mask_tracking` with use_SAM (paths.sam_path) and
    extract_pedestrians: masks_raw/ (the car masks above 0.7 refined by
    SAM, the others as the detector gave them) and pedestrians/
    (unrefined) equal to the JAX driver's files."""
    root, mpath, spath = kitti_sam
    written = {}
    for tag, main, dev in (("torch", cli.main, ["--device", "cpu"]),
                           ("jax", jcli.main, [])):
        conf = {"paths": {"kitti_path": str(root / "kitti"),
                          "merged_frames_path": str(root / tag),
                          "labels_path": str(root / tag / "labels"),
                          "sam_path": spath},
                "backends": {"mask": "mask2former", "mask_checkpoint": mpath,
                             "mask_input_hw": list(MASK_HW)},
                "filtering": {"score_detectron_thresh": THRESHOLD},
                "frames_creation": {"use_SAM": True,
                                    "extract_pedestrians": True}}
        path = root / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(conf))
        assert main(["--config", str(path), "--action", "mask_tracking"]
                    + dev) == 0
    counts, flips = {}, 0
    for sub in ("masks_raw", "pedestrians"):
        for fid in FIDS:
            got = masks.load_masks(str(root / "torch" / sub), fid)
            want = jmasks.load_masks(str(root / "jax" / sub), fid)
            counts[f"{sub}/{fid}"] = len(got)
            flips += _flips(got, want)
    print(json.dumps({"sam_cli_masks": counts, "flips": flips}))
    assert flips == 0
    assert counts["masks_raw/000000"] > 0
    assert counts["pedestrians/000000"] > 0
    # the car masks are SAM's: not the unrefined forward's
    backend = zoo.mask_backend(cli.load_config(str(root / "torch.yaml")),
                               device="cpu")
    raw, scores = backend.predict_masks_scores(frame_image(0))
    refined = masks.load_masks(str(root / "torch" / "masks_raw"), FIDS[0])
    assert min(scores) > THRESHOLD and len(raw) == len(refined)
    same = [np.array_equal(a, b) for a, b in zip(raw, refined)]
    assert same == [s <= masks.SCORE_THRESHOLD for s in scores]
    assert same.count(False) == 2
