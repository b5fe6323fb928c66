"""Leave-one-out retrieval metrics.

Two tiers, as in the JAX package's ``eval/metrics.py``:

1. **NumPy oracle**, semantics-exact to the reference: per-query AP via
   sklearn-compatible tie-grouped average precision on scores
   ``max(dist) - dist``, the early-break ``precision_at_recall``, and
   Recall@K.  Used for final numbers and as the oracle in tests.

2. **Device version** (:func:`retrieval_metrics`), vectorised over queries
   in PyTorch (one distance product + a stable sort), used for per-epoch
   validation inside the training loop.  It ignores score ties when
   integrating AP (real-valued distances tie with probability ~0).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance

# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn-compatible average precision (tie-grouped thresholds).

    AP = sum over distinct descending score thresholds of
    (delta recall) * precision.  Returns NaN when there are no positives
    (matches sklearn emitting NaN + warning, which the reference catches at
    utils.py:118-122).
    """
    y_true = np.asarray(y_true).astype(bool).reshape(-1)
    y_score = np.asarray(y_score, dtype=np.float64).reshape(-1)
    n_pos = int(y_true.sum())
    if n_pos == 0:
        return float("nan")

    order = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[order]
    y_score = y_score[order]

    # indices of the last element of each tie group
    distinct = np.where(np.diff(y_score))[0]
    boundaries = np.r_[distinct, y_true.size - 1]

    cum_tp = np.cumsum(y_true)[boundaries]
    cum_count = boundaries + 1.0
    precision = cum_tp / cum_count
    recall = cum_tp / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def retrieve_one(query: np.ndarray, database: np.ndarray,
                 query_label=None, labels=None):
    """Single-query retrieval: (distances, ascending index order, AP).

    Reference: utils.py:55-81 (euclidean distance; score = max(dist) - dist).
    """
    dist = np.linalg.norm(query.reshape(1, -1) - database, axis=1)
    idx = np.argsort(dist)
    ap = None
    if labels is not None:
        ap = average_precision(np.squeeze(np.asarray(labels) == query_label),
                               np.squeeze(np.max(dist) - dist))
    return dist, idx, ap


def precision_at_recall(label_list: np.ndarray, query_label,
                        alpha: float = 0.5):
    """Precision for all classes at recall ``alpha`` of the query class.

    Exact reproduction of the reference's early-break loop semantics
    (utils.py:231-255), including the int() floor of the recall target and
    the break-on-equality quirk (a target of 0 stops at the first non-query
    item).  Returns (precision of the query class, per-class dict).
    """
    label_list = np.asarray(label_list).reshape(-1)
    num_this_label = int(np.sum(label_list == query_label))
    num_recall_alpha = int(alpha * num_this_label)

    unique_labels = sorted(set(label_list.tolist()))
    prec_dict = dict.fromkeys(unique_labels, 0)

    i = 0
    for i in range(label_list.shape[0]):
        prec_dict[label_list[i]] += 1
        if prec_dict[query_label] == num_recall_alpha:
            break

    for key in prec_dict:
        prec_dict[key] /= (i + 1)
    return prec_dict[query_label], prec_dict


def recall_at_K(label_list: np.ndarray, query_label, K: int = 10) -> int:
    """1 if any of the K nearest labels matches the query (utils.py:257-266)."""
    knn_label = np.asarray(label_list).reshape(-1)[:K]
    return 1 if np.sum(knn_label == query_label) > 0 else 0


def _prep(embeddings: np.ndarray, normalize: bool, standardize: bool):
    embeddings = np.array(embeddings, dtype=np.float64, copy=True)
    if normalize:
        embeddings /= np.linalg.norm(embeddings, axis=1).reshape(-1, 1)
    if standardize:
        mu = np.mean(embeddings, axis=0)
        std = np.std(embeddings, axis=0) + np.finfo(float).tiny
        embeddings = (embeddings - mu) / std
    return embeddings


def evaluate_simple(embeddings: np.ndarray, labels: np.ndarray,
                    normalize: bool = False, standardize: bool = False,
                    alpha: float = 0.5) -> Tuple[float, float, float]:
    """(mAP, mPrec@alpha, Recall@1) over foreground leave-one-out queries.

    Reference: utils.py:83-138.  Queries whose class appears once (AP NaN)
    are skipped.
    """
    embeddings = _prep(embeddings, normalize, standardize)
    labels = np.squeeze(np.asarray(labels))
    n = embeddings.shape[0]

    aps, precs, num_correct = [], [], []
    for i in range(n):
        if labels[i] > 0:
            _, sorted_idx, ap = retrieve_one(
                embeddings[i], np.delete(embeddings, i, 0),
                labels[i], np.delete(labels, i))
            if np.isnan(ap):
                continue
            aps.append(ap)
            rest = np.delete(labels, i)
            prec, _ = precision_at_recall(rest[sorted_idx], labels[i], alpha)
            precs.append(prec)
            num_correct.append(recall_at_K(rest[sorted_idx], labels[i], 1))

    return (float(np.mean(aps)), float(np.mean(precs)),
            float(np.mean(num_correct)))


def evaluate(embeddings: np.ndarray, labels: np.ndarray,
             normalize: bool = False, standardize: bool = False,
             alpha: float = 0.5):
    """Full evaluation: (mAP, per-class mAP dict, mPrec, confusion dict,
    per-class counts, Recall@{1,2,4,8,16,32} list).

    Reference: utils.py:140-229.
    """
    embeddings = _prep(embeddings, normalize, standardize)
    labels = np.squeeze(np.asarray(labels))
    n = embeddings.shape[0]
    unique_labels = sorted(set(labels.tolist()))
    ks = (1, 2, 4, 8, 16, 32)

    aps, lab, precs, confs = [], [], [], []
    num_correct = [0] * len(ks)
    for i in range(n):
        if labels[i] > 0:
            _, sorted_idx, ap = retrieve_one(
                embeddings[i], np.delete(embeddings, i, 0),
                labels[i], np.delete(labels, i))
            if np.isnan(ap):
                continue
            aps.append(ap)
            lab.append(int(labels[i]))
            rest = np.delete(labels, i)
            prec, conf = precision_at_recall(rest[sorted_idx], labels[i], alpha)
            precs.append(prec)
            confs.append(conf)
            for j, k in enumerate(ks):
                num_correct[j] += recall_at_K(rest[sorted_idx], labels[i], k)

    mAP = float(np.mean(aps))
    mPrec = float(np.mean(precs))

    mAP_event: Dict[int, float] = {}
    for ap, l in zip(aps, lab):
        mAP_event.setdefault(l, []).append(ap)
    for key in mAP_event:
        mAP_event[key] = float(np.mean(mAP_event[key]))

    confusion_matrix = np.zeros((len(unique_labels), len(unique_labels)),
                                dtype="float32")
    count = np.zeros((len(unique_labels), 1), dtype="int32")
    for conf, l in zip(confs, lab):
        row = unique_labels.index(l)
        for key in conf:
            confusion_matrix[row, unique_labels.index(key)] += conf[key]
        count[row] += 1
    # normalize per-class rows by their query counts; the background row
    # (label 0, if present) holds the soft-assignment sums un-normalized
    # and reports the background population instead (reference behavior —
    # but do NOT assume label 0 exists in the test split)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r, l in enumerate(unique_labels):
            if l != 0 and count[r] > 0:
                confusion_matrix[r] /= count[r]
    if 0 in unique_labels:
        count[unique_labels.index(0)] = int((labels == 0).sum())
    confusion = {"confusion_matrix": confusion_matrix,
                 "labels": unique_labels}

    denom = len(lab) if lab else float("nan")
    recall = [float(num) / denom for num in num_correct]
    return mAP, mAP_event, mPrec, confusion, count, recall


# ---------------------------------------------------------------------------
# Device version
# ---------------------------------------------------------------------------

_POS_INF = 1e30


def retrieval_metrics(embeddings: torch.Tensor, labels,
                      ks: Iterable[int] = (1, 2, 4, 8, 16, 32),
                      alpha: float = 0.5):
    """Vectorised leave-one-out metrics on the embeddings' device.

    Returns (mAP, mPrec@alpha, {k: recall@k}) as Python floats; NaN when no
    query is valid (foreground with at least one same-class other), as the
    NumPy oracle's mean of an empty list.
    """
    ks = tuple(ks)
    emb = embeddings.float()
    dev = emb.device
    labels = torch.as_tensor(np.asarray(labels).reshape(-1)).to(dev)
    n = labels.shape[0]
    with torch.no_grad():
        dist = pairwise_distance(emb, emb, "euclidean")
        dist = dist + torch.eye(n, device=dev) * _POS_INF  # exclude self

        order = torch.argsort(dist, dim=1, stable=True)[:, : n - 1]
        rel = (labels[order] == labels[:, None]).float()      # [N, N-1]
        cum = torch.cumsum(rel, dim=1)
        ranks = torch.arange(1, n, dtype=torch.float32, device=dev)[None, :]
        n_pos = rel.sum(1)
        ap = (cum / ranks * rel).sum(1) / torch.clamp(n_pos, min=1.0)

        valid = ((labels > 0) & (n_pos > 0)).float()
        n_valid = valid.sum()
        denom = n_valid if n_valid > 0 else torch.tensor(float("nan"))
        mAP = (ap * valid).sum() / denom

        recalls = [((rel[:, :k].sum(1) > 0).float() * valid).sum() / denom
                   for k in ks]

        # mPrec@alpha as the reference's break-on-equality loop: stop at the
        # first index where the cumulative query-class count equals
        # floor(alpha * n_pos); if never reached, run to the end
        target = torch.floor(alpha * n_pos)
        hit = cum == target[:, None]
        first = torch.argmax(hit.int(), dim=1)
        i_break = torch.where(hit.any(1), first,
                              torch.full_like(first, n - 2))
        prec = cum[torch.arange(n, device=dev), i_break] / (i_break + 1.0)
        mPrec = (prec * valid).sum() / denom

    return (float(mAP), float(mPrec),
            {k: float(r) for k, r in zip(ks, recalls)})
