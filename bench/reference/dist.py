"""Point-to-point distance: the float32 Bellman-Ford distance
(``sssp.py``) from the root at the target.

As a kind of query (``bench/harness/check.py``): ``dist_mismatch``
counts the answers that differ from the reference's distance bit for
bit; the control is the bfloat16 reference's distance.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import sssp

NUMBER = "dist_mismatch"
SAMPLE = 6                  # answers a run keeps for the check


def combine(a: int, b: int) -> int:
    return a + b


def reading(ref, a) -> int:
    want = np.float32(sssp.answer(ref, a.root)[a.target].item())
    return int(np.float32(a.value) != want)


def control(ref, a) -> float:
    return float(sssp.answer(ref, a.root, torch.bfloat16)[a.target])
