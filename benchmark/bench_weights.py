"""Seeded weights, made on the device in one draw, the same for the port
and for the plain reference.

The benchmark fills every floating tensor of a network's state (its
parameters and buffers, by the names the two implementations share) from
one normal draw of a ``torch.Generator`` on the device, each tensor a slice
of it scaled by its kind: a dense or convolution kernel takes the
standard deviation 1 / sqrt(fan in); a learned table the standard
deviation its published initialiser gives it (``TABLE_STD``: the query
and level embeddings N(0, 1) as ``nn.Embedding`` draws them, Swin's
relative-position bias 0.02); a norm's scale and a frozen norm's variance
1 + 0.05 x normal; a mean or a bias 0.02 x normal.  The result depends
only on the seed and the names and shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]

SCALE_LEAVES = ("weight", "scale", "var")
TABLE_STD = {"level_embed": 1.0, "query_embed": 1.0, "depth_pos_embed": 1.0,
             "queries_embedder": 1.0, "queries_features": 1.0,
             "rel_bias_table": 0.02}
# raw kernels stored (in, out): their fan in is the first axis
IN_OUT_KERNELS = ("reduction",)


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed drawn from ``seed`` (any whole number) and ``path``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def float_shapes(state: Dict[str, torch.Tensor]) -> Shapes:
    """The (name, shape) of each floating tensor of a state dict, in the
    dict's order."""
    return [(k, tuple(v.shape)) for k, v in state.items()
            if v.is_floating_point()]


def _scale_shift(name: str, shape: Tuple[int, ...],
                 stds: Dict[str, float]) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in stds:
        return stds[leaf], 0.0
    if leaf in IN_OUT_KERNELS:
        return 1.0 / math.sqrt(shape[0]), 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf in SCALE_LEAVES:
        return 0.05, 1.0
    return 0.02, 0.0


def seeded_state(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, table_std: Optional[Dict[str, float]] = None
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for each (name, shape);
    ``table_std`` (a configuration's) overrides ``TABLE_STD`` by leaf."""
    stds = dict(TABLE_STD, **(table_std or {}))
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        std, mean = _scale_shift(name, shape, stds)
        out[name] = flat[off:off + n].view(shape) * std + mean
        off += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, state: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``state`` into the module's tensors of the same names; every
    name must be the module's."""
    own = module.state_dict(keep_vars=True)
    missing = [k for k in state if k not in own]
    if missing:
        raise KeyError(f"no such tensors in {type(module).__name__}: "
                       f"{missing[:5]}")
    for k, v in state.items():
        own[k].copy_(v)
