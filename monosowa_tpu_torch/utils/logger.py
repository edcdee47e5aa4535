"""Logging + seeding helpers.

Behavioural contract (MonoDETR/lib/helpers/utils_helper.py:6-27; the JAX
package's ``utils/logger.py``): a file and a console handler with one
format; a seed helper that seeds Python's and numpy's global generators.
The port's own draws go on through explicit ``torch.Generator`` objects
made from the same seed by their callers.
"""

from __future__ import annotations

import logging
import random

import numpy as np


def create_logger(log_file: str, name: str = "monosowa_tpu_torch",
                  level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
