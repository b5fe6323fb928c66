"""Export a trained checkpoint and a session split into a saved
``RetrievalIndex``.

Embeds the split's events (test-time TSN centre frames) with the encoder of
a port checkpoint (``--variable_name`` picks a scope), in chunks on the
device, and saves an f32 or (``--int8_gallery``) int8 index with each
event's session, label and frame boundaries as its metadata.  A server then
calls ``RetrievalIndex.load`` and serves top-k with no model.  The index is
Euclidean: ``EvalConfig`` has no ``--metric``.

Run:  python -m multimodal_similarity_tpu_torch.eval.export_index --DATA_ROOT <dir> --model_path <ckpt> --network convrtsn --index_dir <dir> [--int8_gallery] [--index_split test] ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    load_validation_set, prepare_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.eval.evaluate_model import load_params
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.serving import RetrievalIndex
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)


def run(cfg: EvalConfig, index_dir: str, int8_gallery: bool = False,
        split: str = "test", data=None):
    """Embed the split's sessions (or ``data``, (feats, labels, sessions,
    boundaries)) and save the index; returns its path."""
    device = resolve_device(cfg.device)
    feat = cfg.feat if isinstance(cfg.feat, str) else cfg.feat[0]
    if data is None:
        sessions = {"train": cfg.train_session, "val": cfg.val_session,
                    "test": cfg.test_session, "all": cfg.all_session}[split]
        dataset = prepare_dataset(cfg.feature_root, sessions, feat,
                                  cfg.label_root, cfg.label_type)
        feats, labels, sess, bound = load_validation_set(
            dataset, functools.partial(tsn_prepare_input_test, cfg.num_seg),
            transfer=cfg.transfer)
    else:
        feats, labels, sess, bound = data

    model = load_params(
        build_encoder(cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
                      n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w,
                      n_C=cfg.n_C),
        restore_encoder_params(cfg.model_path, cfg.variable_name), device)
    embeddings = embed_in_chunks(
        make_embed_fn(model, normalized=cfg.normalized), feats,
        device).cpu().numpy()
    labels = np.asarray(labels).reshape(-1)
    metadata = [
        {"session": s, "label": int(l), "start": int(b[0]), "end": int(b[1])}
        for s, l, b in zip(sess, labels, bound)]
    # EvalConfig has no --metric: the JAX CLI's fallback, Euclidean
    index = RetrievalIndex(emb_dim=embeddings.shape[1],
                           metric=getattr(cfg, "metric", "euclidean"),
                           int8_gallery=int8_gallery, device=device)
    index.add(embeddings, metadata)
    path = index.save(index_dir)
    print(f"[export_index] {len(index)} events -> {path} "
          f"({'int8' if int8_gallery else 'f32'} gallery, "
          f"emb_dim {embeddings.shape[1]})")
    return path


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argparse.ArgumentParser(add_help=False)
    # not required=True: --help must reach EvalConfig's parser below
    extra.add_argument("--index_dir", type=str, default="")
    extra.add_argument("--int8_gallery", action="store_true")
    extra.add_argument("--index_split", type=str, default="test",
                       choices=("train", "val", "test", "all"))
    ns, rest = extra.parse_known_args(argv)
    if "--help" in rest or "-h" in rest:
        print("export_index extras: --index_dir DIR (required), "
              "--int8_gallery, --index_split {train,val,test,all}\n"
              "plus every EvalConfig flag:")
    elif not ns.index_dir:
        extra.error("the following arguments are required: --index_dir")
    cfg = EvalConfig.parse(rest)
    run(cfg, ns.index_dir, int8_gallery=ns.int8_gallery,
        split=ns.index_split)


if __name__ == "__main__":
    main(sys.argv[1:])
