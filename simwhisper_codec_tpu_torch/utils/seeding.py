"""Deterministic seeding (a copy of the JAX package's ``utils/seeding.py``;
reference: SpeechBrain's seed_everything, ``hparams/train.yaml:12-13``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> int:
    """Seed Python, numpy and torch (every device); return the seed."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return seed
