"""Result analysis: the notebooks' functionality as importable utilities.

Reference: notebooks/parse_results.ipynb (confusion-matrix rendering from
results.pkl) and notebooks/check_label.ipynb (label-distribution stats);
here as functions + a CLI that work headless (text table always, PNG when
matplotlib is present).
"""

from __future__ import annotations

import pickle
import sys
from typing import Dict, Optional

import numpy as np

from multimodal_similarity_tpu_torch.data.honda import HONDA_NUM2LABELS


def label_distribution(labels: np.ndarray,
                       name_map: Optional[Dict[int, str]] = None) -> str:
    """Per-class event counts + fractions as a text table."""
    name_map = name_map or HONDA_NUM2LABELS
    labels = np.asarray(labels).reshape(-1)
    counts = np.bincount(labels)
    total = counts.sum()
    lines = ["label  count  fraction  name"]
    for i, c in enumerate(counts):
        lines.append(f"{i:5d}  {c:5d}  {c / total:8.4f}  "
                     f"{name_map.get(i, '')}")
    return "\n".join(lines)


def format_confusion(confusion: Dict, name_map=None) -> str:
    """results.pkl confusion dict -> aligned text matrix."""
    name_map = name_map or HONDA_NUM2LABELS
    cm = np.asarray(confusion["confusion_matrix"])
    labels = confusion["labels"]
    header = "        " + " ".join(f"{l:>6}" for l in labels)
    lines = [header]
    for i, l in enumerate(labels):
        row = " ".join(f"{cm[i, j]:6.3f}" for j in range(len(labels)))
        lines.append(f"{str(l):>7} {row}")
    return "\n".join(lines)


def plot_confusion(confusion: Dict, out_path: str,
                   name_map=None) -> Optional[str]:
    """PNG heatmap when matplotlib is available; returns path or None."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    name_map = name_map or HONDA_NUM2LABELS
    cm = np.asarray(confusion["confusion_matrix"])
    labels = [name_map.get(l, str(l)) for l in confusion["labels"]]
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(cm, cmap="viridis")
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def summarize_results(results_path: str) -> str:
    """Human-readable report from an evaluate_model results.pkl."""
    with open(results_path, "rb") as f:
        results = pickle.load(f)
    lines = [f"mAP        = {results['mAP']:.4f}"]
    if "mAP_macro" in results:
        lines.append(f"mAP_macro  = {results['mAP_macro']:.4f}")
    lines.append(f"mPrec@0.5  = {results['mPrec']:.4f}")
    for k, r in zip((1, 2, 4, 8, 16, 32), results["recall"]):
        lines.append(f"Recall@{k:<3d} = {r:.4f}")
    lines.append("")
    lines.append("per-class mAP:")
    for key in sorted(results["mAP_event"]):
        name = HONDA_NUM2LABELS.get(key, str(key))
        lines.append(f"  {name:24s} {results['mAP_event'][key]:.4f}")
    if "confusion" in results:
        lines.append("")
        lines.append("confusion (rows=query class):")
        lines.append(format_confusion(results["confusion"]))
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("results_pkl")
    p.add_argument("--png", default=None,
                   help="optional confusion-matrix PNG output path")
    args = p.parse_args(argv)
    print(summarize_results(args.results_pkl))
    if args.png:
        with open(args.results_pkl, "rb") as f:
            results = pickle.load(f)
        out = plot_confusion(results["confusion"], args.png)
        print(f"confusion heatmap: {out or 'matplotlib unavailable'}")


if __name__ == "__main__":
    main(sys.argv[1:])
