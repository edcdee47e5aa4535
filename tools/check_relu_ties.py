"""Find the ReLU inputs of the port's ResNet-50 that float32 puts on the
other side of zero than float64.

At such an input the ReLU's derivative differs between two float32
implementations that round differently, and every gradient below it
changes.  This runs the backbone of the train-step parity test
(tests/test_torch_train.py: the JAX package's MonoDETR init at the test
widths, carried over by ``load_flax_params``) on that test's images,
``sample_batch(2, 96, 160)``, once in float32 and once in float64, and
prints one JSON line per ReLU input whose sign differs, then a summary.

    JAX_PLATFORMS=cpu python tools/check_relu_ties.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def pre_relu(backbone, x):
    """(name, tensor) of every ReLU input of the backbone, in order."""
    import torch

    out = []
    y = backbone.bn1(backbone.conv1(x))
    out.append(("stem", y))
    y = backbone.pool(torch.relu(y))
    for stage, blocks in enumerate(backbone.stage_sizes):
        for b in range(blocks):
            blk = getattr(backbone, f"layer{stage + 1}_{b}")
            p1 = blk.bn1(blk.conv1(y))
            p2 = blk.bn2(blk.conv2(torch.relu(p1)))
            idt = blk.down_bn(blk.down_conv(y)) if blk.downsample else y
            p3 = blk.bn3(blk.conv3(torch.relu(p2))) + idt
            name = f"layer{stage + 1}_{b}"
            out += [(name + ".relu1", p1), (name + ".relu2", p2),
                    (name + ".relu_out", p3)]
            y = torch.relu(p3)
    return out


def main() -> int:
    import jax
    import numpy as np
    import torch

    from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
    from monosowa_tpu_torch.convert import load_flax_params
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.train.sample import sample_batch

    widths = dict(enc_layers=1, dec_layers=2, group_num=2, d_model=64,
                  d_ffn=64, nheads=4, num_queries=10, num_depth_bins=16)
    batch = sample_batch(2, 96, 160)
    jm = JaxMonoDETR(msda_backend="xla", compute_dtype="float32", **widths)
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(
        *[batch[k][:1] for k in ("image", "calib", "img_size")])
    tm = MonoDETR(device="cpu", **widths)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, v["params"]),
                     jax.tree_util.tree_map(np.asarray, v["frozen"]))
    image = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        f32 = pre_relu(tm.backbone, image)
        f64 = pre_relu(tm.backbone.double(), image.double())
    n_inputs, n_flips = 0, 0
    for (name, a), (_, b) in zip(f32, f64):
        a, b = a.numpy(), b.numpy()
        n_inputs += a.size
        for idx in zip(*np.nonzero((a > 0) != (b > 0))):
            n_flips += 1
            print(json.dumps({"relu": name, "index": [int(i) for i in idx],
                              "float64": float(b[idx]),
                              "float32": float(a[idx])}))
    print(json.dumps({"relu_inputs": n_inputs, "sign_differs": n_flips}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
