"""Late-fusion evaluation: the core embedding concatenated with an
auxiliary embedding, each l2-normalised, before the leave-one-out
retrieval evaluation.

The auxiliary half is the sensors RTSN tower (emb_dim 32) of a
``pddm_model`` checkpoint (``--sensors_path``, its ``encoder`` group) on the
real sensor features, or with ``--use_output`` the regression head of a
``cross_prediction`` checkpoint (``--sensors_path``) on that checkpoint's
own encoder: sensors predicted from the video alone.  The core comes from
``--model_path`` (``--variable_name`` picks a scope).  Embeds in chunks on
the device.

Run:  python -m multimodal_similarity_tpu_torch.eval.evaluate_late_fusion --DATA_ROOT <dir> --model_path <ckpt> --sensors_path <ckpt> --network convrtsn --feat resnet,sensors --emb_dim 128 ...
(``--device cpu`` runs on the CPU; the default is ``cuda``.)
"""

from __future__ import annotations

import functools
import sys

import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.data import (
    load_validation_set, prepare_multimodal_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.eval.evaluate_model import load_params
from multimodal_similarity_tpu_torch.eval.metrics import evaluate
from multimodal_similarity_tpu_torch.models import (
    BRANCH_EMB_DIM, RTSN, OutputLayer, build_encoder)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)


def run(cfg: EvalConfig, sensors_n_input: int = 8):
    """Late-fusion evaluation of ``cfg`` on the test sessions; returns the
    metrics and the fused ``embeddings``."""
    device = resolve_device(cfg.device)
    feats_list = cfg.feat if isinstance(cfg.feat, list) else \
        ["resnet", "sensors"]
    test_set = prepare_multimodal_dataset(
        cfg.feature_root, cfg.test_session, feats_list, cfg.label_root,
        cfg.label_type)
    prep = functools.partial(tsn_prepare_input_test, cfg.num_seg)
    feats, labels, _, _ = load_validation_set(
        [[r[0], r[-1]] for r in test_set], prep, transfer=cfg.transfer)

    def encoder():
        return build_encoder(cfg.network, num_seg=cfg.num_seg,
                             emb_dim=cfg.emb_dim, n_input=cfg.n_input,
                             n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C)

    core = load_params(encoder(), restore_encoder_params(
        cfg.model_path, cfg.variable_name), device)
    if cfg.use_output:
        # the cross-predicted half derives from the video alone: the second
        # modality is not loaded
        cp_enc = load_params(encoder(), restore_encoder_params(
            cfg.sensors_path, subkey="encoder"), device)
        head_params = restore_encoder_params(cfg.sensors_path,
                                             subkey="head")
        fc = head_params["fc.weight"]
        cp_head = load_params(OutputLayer(fc.shape[1], fc.shape[0]),
                              head_params, device)

        aux = nn.Sequential(cp_enc, nn.ReLU(), cp_head)
        aux_feats = feats
    else:
        aux_feats, _, _, _ = load_validation_set(
            [[r[1], r[-1]] for r in test_set], prep, transfer=cfg.transfer)
        aux = load_params(
            RTSN(n_seg=cfg.num_seg, emb_dim=BRANCH_EMB_DIM,
                 n_input=sensors_n_input),
            restore_encoder_params(cfg.sensors_path, subkey="encoder"),
            device)
    embeddings = torch.cat(
        [embed_in_chunks(make_embed_fn(core), feats, device),
         embed_in_chunks(make_embed_fn(aux), aux_feats, device)],
        dim=1).cpu().numpy()
    mAP, mAP_event, mPrec, confusion, count, recall = evaluate(
        embeddings, labels)
    print("late fusion: mAP = %.4f  mPrec@0.5 = %.4f  Recall@1 = %.4f"
          % (mAP, mPrec, recall[0]))
    return {"mAP": mAP, "mAP_event": mAP_event, "mPrec": mPrec,
            "recall": recall, "embeddings": embeddings}


def main(argv=None):
    run(EvalConfig.parse(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
