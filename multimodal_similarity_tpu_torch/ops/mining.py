"""Host-side batch selection for the batch-structured losses."""

from __future__ import annotations

import random
from typing import List

import numpy as np


def select_batch_balanced(
    labels,
    batch_size: int,
    rng: random.Random | None = None,
) -> np.ndarray:
    """Class-balanced round-robin batch builder for batch-hard / lifted
    training: cycle foreground classes, taking one shuffled index from each
    until ``batch_size`` is reached; classes are recycled if exhausted.
    A copy of the JAX package's ``ops/mining.py`` function: the same rng
    state gives the same indices."""
    rng = rng or random
    np_lab = np.asarray(labels).reshape(-1)
    idx_dict: dict[int, list[int]] = {}
    for i, l in enumerate(np_lab):
        if int(l) != 0:
            idx_dict.setdefault(int(l), []).append(i)
    if not idx_dict:
        return np.zeros((0,), dtype=np.int64)
    pools = {k: list(v) for k, v in idx_dict.items()}
    for key in pools:
        rng.shuffle(pools[key])
    out: List[int] = []
    keys = list(pools.keys())
    cursor = {k: 0 for k in keys}
    while len(out) < batch_size:
        for key in keys:
            if cursor[key] >= len(pools[key]):
                rng.shuffle(pools[key])
                cursor[key] = 0
            out.append(pools[key][cursor[key]])
            cursor[key] += 1
            if len(out) >= batch_size:
                break
    return np.asarray(out, dtype=np.int64)
