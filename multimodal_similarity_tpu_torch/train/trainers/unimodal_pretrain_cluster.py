"""K-means pseudo-labels from pretrained embeddings
(``scripts/unimodal_pretrain.sh``, ``MODE=cluster``), the second link of
the pretrain chain.

Every train session's events, sampled at their TSN centre frames, are
embedded by the ``Seq2seqTSN`` of a ``unimodal_pretrain_sae`` checkpoint
(``--model_path``, eval mode), clustered into 20 with the port's k-means
(``ops/kmeans.py``: ``n_init`` 20, k-means++ seeded from ``--seed``, on the
run's device), and the 100 rows nearest each centre are kept as
high-confidence pseudo-labelled training data (the validation sessions'
20 nearest, for validation).  Writes ``train_data.pkl`` and
``val_data.pkl`` ({feats [N, emb] f32, labels [N, 1] int32, sessions,
boundaries}, as the JAX trainer does) and ``kmeans_model.pkl``, which
holds the port's centres and inertia as plain values where the JAX
trainer pickles a scikit-learn object (ROADMAP D4).  No CUDA kernel of
``csrc/`` is on this path.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.unimodal_pretrain_cluster --DATA_ROOT <dir> --feat sensors --emb_dim 128 --model_path <sae ckpt>
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import functools
import os
import pickle
import sys
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import (
    load_data_and_label, prepare_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.models import Seq2seqTSN
from multimodal_similarity_tpu_torch.ops.kmeans import KMeans
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint

NUM_CLUSTER = 20
NUM_INIT = 20
NUM_HIGH = 100
NUM_HIGH_VAL = 20


def embed_sessions(model, dataset, prep, device: torch.device,
                   chunk: int = 256):
    """Each session's events through ``model`` in eval mode -> (hidden
    [N, emb] f32, session ids, boundaries)."""
    model.eval()
    feats, sessions, eids = [], [], []
    with torch.no_grad():
        for row in dataset:
            session_id = os.path.basename(row[-1]).split("_")[0]
            eve, _, bou = load_data_and_label(row[0], row[-1], prep)
            for lo in range(0, eve.shape[0], chunk):
                hidden, _ = model(torch.from_numpy(
                    eve[lo:lo + chunk]).to(device))
                feats.append(hidden.cpu().numpy())
            sessions.extend([session_id] * eve.shape[0])
            eids.extend(bou)
    return np.concatenate(feats, axis=0), sessions, eids


def high_confidence(embeddings, kmeans, sessions, eids, num_high):
    """The ``num_high`` rows nearest each centre, cluster by cluster ->
    (feats, labels [N, 1] int32, sessions, boundaries)."""
    cluster_idx = kmeans.predict(embeddings)
    cluster_dist = kmeans.transform(embeddings)
    feat, label, ses, out_eids = [], [], [], []
    for i in range(NUM_CLUSTER):
        idx = np.where(cluster_idx == i)[0]
        dist = cluster_dist[idx, i]
        idx = idx[np.argsort(dist)[:num_high]]
        temp = embeddings[idx]
        feat.append(temp)
        label.append(i * np.ones((temp.shape[0], 1), dtype="int32"))
        for j in idx:
            ses.append(sessions[j])
            out_eids.append(eids[j])
    return (np.concatenate(feat, axis=0), np.concatenate(label, axis=0),
            ses, out_eids)


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def run(cfg: TrainConfig, result_dir: Optional[str] = None,
        device=None) -> str:
    """Cluster on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for); returns the result dir
    (default ``<dirname(model_path)>/kmeans_<timestamp>``)."""
    if not cfg.model_path:
        raise ValueError("--model_path (pretrained seq2seq) is required")
    device = resolve_device(device)
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    train_set = prepare_dataset(cfg.feature_root, cfg.train_session, feat,
                                cfg.label_root, cfg.label_type)
    val_set = prepare_dataset(cfg.feature_root, cfg.val_session, feat,
                              cfg.label_root, cfg.label_type)
    prep = functools.partial(tsn_prepare_input_test, cfg.num_seg)

    model = Seq2seqTSN(n_seg=cfg.num_seg,
                       n_input=cfg.feat_dim.get(feat, (8,))[-1],
                       emb_dim=cfg.emb_dim, reverse=cfg.reverse).to(device)
    load_checkpoint(cfg.model_path, model)

    emb, sessions, eids = embed_sessions(model, train_set, prep, device)
    kmeans = KMeans(NUM_CLUSTER, n_init=NUM_INIT, seed=cfg.seed,
                    device=device).fit(emb)
    if not cfg.silent_mode:
        sizes = np.bincount(kmeans.labels_, minlength=NUM_CLUSTER)
        print(f"[{cfg.name}] k-means on {emb.shape[0]} embeddings: inertia "
              f"{kmeans.inertia_:.4f}, cluster sizes {sizes.tolist()}")

    if result_dir is None:
        result_dir = os.path.join(
            os.path.dirname(cfg.model_path),
            "kmeans_" + datetime.now().strftime("%Y%m%d-%H%M%S"))
    os.makedirs(result_dir, exist_ok=True)
    _dump(os.path.join(result_dir, "kmeans_model.pkl"), kmeans.state())
    for name, (e, s, b), num_high in (
            ("train_data.pkl", (emb, sessions, eids), NUM_HIGH),
            ("val_data.pkl", embed_sessions(model, val_set, prep, device),
             NUM_HIGH_VAL)):
        feats, labels, ses, bounds = high_confidence(e, kmeans, s, b,
                                                     num_high)
        _dump(os.path.join(result_dir, name),
              {"feats": feats, "labels": labels, "sessions": ses,
               "boundaries": bounds})
    return result_dir


def main(argv=None):
    """The CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    run(TrainConfig.parse(rest), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
