"""Checkpoints of the train state as torch ``state_dict`` files.

Behavioral contract (MonoDETR/lib/helpers/save_helper.py:13-45,
trainer_helper.py:86-107; the JAX package's ``train/checkpoint.py``):
per-epoch checkpoints carrying model, optimizer, step and epoch, a tracked
best checkpoint (by Car-moderate AP3D), and resume.  The names are the JAX
package's: ``<ckpt_dir>/<tag>_epoch_<n>`` (here one file, there an orbax
directory) beside ``<tag>_epoch_<n>.meta``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch
from torch import nn


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], step: int,
                    epoch: int, best_ap: Optional[float] = None,
                    tag: str = "checkpoint") -> str:
    """Save model/optimizer state, step, epoch and best_ap under
    <ckpt_dir>/<tag>_epoch_<n>; returns that path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{tag}_epoch_{epoch}")
    torch.save({"model": model.state_dict(),
                "optimizer": (optimizer.state_dict()
                              if optimizer is not None else None),
                "step": int(step), "epoch": int(epoch), "best_ap": best_ap},
               path)
    with open(path + ".meta", "w") as f:
        f.write(f"epoch={epoch}\nbest_ap={best_ap if best_ap else ''}\n")
    return path


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> Dict[str, Any]:
    """Load ``path`` into ``model`` (and ``optimizer``) in place; returns
    {"step", "epoch", "best_ap"}."""
    dev = next(model.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        if payload["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["optimizer"])
    return {k: payload[k] for k in ("step", "epoch", "best_ap")}


def list_checkpoints(ckpt_dir: str, tag: str = "checkpoint") -> List[str]:
    """All <tag>_epoch_<n> checkpoints sorted by epoch (the tester's 'all'
    sweep, tester_helper.py:62-68)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(f"{tag}_epoch_") and not name.endswith(".meta"):
            try:
                e = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            out.append((e, os.path.join(ckpt_dir, name)))
    return [p for _, p in sorted(out)]


def latest_checkpoint(ckpt_dir: str, tag: str = "checkpoint"
                      ) -> Optional[str]:
    found = list_checkpoints(ckpt_dir, tag)
    return found[-1] if found else None
