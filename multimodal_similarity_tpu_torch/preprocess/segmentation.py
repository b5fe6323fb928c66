"""Semantic-segmentation feature extraction.

Reference: preprocess/extract_seg_feature.py:28-65 (spatial-pyramid softmax
histograms: L levels, per-level 2^l x 2^l bins, per-bin mean of per-pixel
class softmax -> concat [sum_l 4^l * n_classes]-d; L=3 with 17 classes
gives 21 * 17 = 357) and preprocess/downsample_seg.py:23-52 (5x5 max-pool
then softmax).

The port's copy of the JAX package's ``preprocess/segmentation.py`` (the
port imports nothing of that package); the same NumPy arithmetic.
"""

from __future__ import annotations

import sys

import numpy as np


def softmax(x: np.ndarray) -> np.ndarray:
    x = x - np.max(x, axis=-1, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=-1, keepdims=True)


def spatial_pyramid_features(seg: np.ndarray, levels: int = 3) -> np.ndarray:
    """[N, H, W, D] per-pixel logits -> [N, (sum_l 4^l) * D] histograms."""
    n, h, w, d = seg.shape
    probs = softmax(seg.astype(np.float64))
    feat = []
    for level in range(levels):
        h_size = h // (2 ** level)
        w_size = w // (2 ** level)
        for i in range(2 ** level):
            for j in range(2 ** level):
                region = probs[:, i * h_size:(i + 1) * h_size,
                               j * w_size:(j + 1) * w_size, :]
                feat.append(np.mean(region, axis=(1, 2)))
    return np.concatenate(feat, axis=1).astype(np.float32)


def downsample_seg(seg: np.ndarray, pool: int = 5) -> np.ndarray:
    """[N, H, W, D] logits -> max-pooled (pool x pool) softmax maps."""
    n, h, w, d = seg.shape
    h2, w2 = -(-h // pool), -(-w // pool)
    pad_h, pad_w = h2 * pool - h, w2 * pool - w
    padded = np.pad(seg, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                    constant_values=-np.inf)
    pooled = padded.reshape(n, h2, pool, w2, pool, d).max(axis=(2, 4))
    return softmax(pooled).astype(np.float32)


def main(argv=None):
    import argparse
    import glob
    import os

    p = argparse.ArgumentParser()
    p.add_argument("--seg_root", required=True,
                   help="directory of <session>_seg.npy per-pixel logits")
    p.add_argument("--feature_root", required=True)
    p.add_argument("--mode", choices=("pyramid", "down"), default="pyramid")
    p.add_argument("--levels", type=int, default=3)
    args = p.parse_args(argv)

    for f in sorted(glob.glob(os.path.join(args.seg_root, "*_seg.npy"))):
        base = os.path.basename(f)
        out_suffix = "_sp.npy" if args.mode == "pyramid" else "_down.npy"
        out = os.path.join(args.feature_root,
                           base.replace(".npy", out_suffix))
        if os.path.isfile(out):
            continue
        seg = np.load(f)
        if args.mode == "pyramid":
            feat = spatial_pyramid_features(seg, args.levels)
        else:
            feat = downsample_seg(seg)
        np.save(out, feat)
        print(base, "->", out, feat.shape)


if __name__ == "__main__":
    main(sys.argv[1:])
