"""CAN-bus sensor normalization.

Reference recipe (preprocess/scripts.py:114-153), channel layout
[accel, steer_angle, steer_speed, vel, brake, left, right, yaw]:
  - zero mean + unit std for accel (0), vel (3), brake (4);
  - unit std only for steer_angle (1), steer_speed (2), yaw (7) — keeps
    the sign meaningful;
  - left (5) / right (6) turn-signal bits mapped {0 -> -1, 1 -> 1}.
Statistics are computed over ALL sessions jointly.

The port's copy of the JAX package's ``preprocess/sensors.py`` (the port
imports nothing of that package); the same arithmetic, bit for bit.
"""

from __future__ import annotations

import os
import sys
from typing import Sequence, Tuple

import numpy as np

ZERO_MEAN_CHANNELS = (0, 3, 4)
UNIT_STD_CHANNELS = (1, 2, 7)
BINARY_CHANNELS = (5, 6)


def compute_sensor_stats(
        session_feats: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    all_feats = np.concatenate(list(session_feats), axis=0)
    mu = np.mean(all_feats, axis=0)
    std = np.std(all_feats, axis=0) + np.finfo(float).tiny
    return mu, std


def normalize_sensors(feats: np.ndarray, mu: np.ndarray,
                      std: np.ndarray) -> np.ndarray:
    new = np.array(feats, dtype=np.float32, copy=True)
    for c in ZERO_MEAN_CHANNELS:
        new[:, c] = (feats[:, c] - mu[c]) / std[c]
    for c in UNIT_STD_CHANNELS:
        new[:, c] = feats[:, c] / std[c]
    for c in BINARY_CHANNELS:
        new[np.where(feats[:, c] == 0)[0], c] = -1
        new[np.where(feats[:, c] != 0)[0], c] = 1
    return new


def normalize_sessions(feature_root: str, session_ids: Sequence[str],
                       suffix_in: str = "_sensors.npy",
                       suffix_out: str = "_sensors_normalized.npy") -> int:
    """Batch-normalize every session in place on disk."""
    raws = {s: np.load(os.path.join(feature_root, s + suffix_in))
            for s in session_ids}
    mu, std = compute_sensor_stats(raws.values())
    for s, feats in raws.items():
        np.save(os.path.join(feature_root, s + suffix_out),
                normalize_sensors(feats, mu, std))
    return len(raws)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--feature_root", required=True)
    p.add_argument("--session_file", required=True)
    args = p.parse_args(argv)
    with open(args.session_file) as f:
        sessions = f.read().strip().split("\n")
    n = normalize_sessions(args.feature_root, sessions)
    print(f"normalized {n} sessions")


if __name__ == "__main__":
    main(sys.argv[1:])
