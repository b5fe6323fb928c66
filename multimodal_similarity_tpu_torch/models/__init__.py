"""Model zoo: the temporal encoders, the pretraining autoencoders
(Seq2seqTSN, SAE), the CUB heads and tower, the pair heads (PairSim,
PairSim2, PDDM) and their all-pairs scorers, and the feature-extraction
towers (InceptionResNetV2, InceptionV1) with slim checkpoint grafting.

``build_encoder`` mirrors the reference trainers' ``--network`` dispatch.
"""

from __future__ import annotations

from multimodal_similarity_tpu_torch.models.encoders import (
    BRANCH_EMB_DIM, RTSN, SAE, TSN, ConvBiRTSN, ConvEmbed, ConvLSTM,
    ConvRTSN, ConvTSN, ConvTSNClassifier, CUBLayer, Dropout, OutputLayer,
    Seq2seqTSN)
from multimodal_similarity_tpu_torch.models.heads import (
    PDDM, PairSim, PairSim2, score_all_pairs, score_all_pairs_sym, score_rows)
from multimodal_similarity_tpu_torch.models.inception_resnet_v2 import (
    N_PIPELINE_UNITS, InceptionResNetV2)
from multimodal_similarity_tpu_torch.models.inception_v1 import InceptionV1
from multimodal_similarity_tpu_torch.models.inception_v2 import (
    ENDPOINT_CHANNELS, InceptionV2, graft_slim_npz, graft_slim_variables)
from multimodal_similarity_tpu_torch.models.lstm import (
    LSTM, BiLSTM, TFLSTMCell)


def build_encoder(network: str, *, num_seg: int = 3, emb_dim: int = 128,
                  n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                  n_C: int = 20, max_time: int = 90, keep_prob: float = 1.0,
                  generator=None, dropout_generator=None):
    """Encoder factory keyed by the reference's --network flag values.

    ``generator`` draws the initial weights (on the CPU);
    ``dropout_generator`` draws the dropout masks and must live on the
    device the model runs on."""
    rngs = dict(generator=generator, dropout_generator=dropout_generator)
    if network == "tsn":
        return TSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                   keep_prob=keep_prob, **rngs)
    if network == "rtsn":
        return RTSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                    keep_prob=keep_prob, **rngs)
    if network == "convrtsn":
        return ConvRTSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                        n_h=n_h, n_w=n_w, n_C=n_C, keep_prob=keep_prob,
                        **rngs)
    if network == "convtsn":
        return ConvTSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                       n_h=n_h, n_w=n_w, n_C=n_C, generator=generator)
    if network == "convbirtsn":
        return ConvBiRTSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                          n_h=n_h, n_w=n_w, n_C=n_C, keep_prob=keep_prob,
                          **rngs)
    if network == "convlstm":
        return ConvLSTM(max_time=max_time, emb_dim=emb_dim, n_input=n_input,
                        n_h=n_h, n_w=n_w, n_C=n_C, generator=generator)
    raise NotImplementedError(f"unknown network: {network}")


__all__ = ["BRANCH_EMB_DIM", "TSN", "RTSN", "ConvEmbed", "ConvTSN",
           "ConvTSNClassifier", "ConvRTSN", "ConvBiRTSN",
           "ConvLSTM", "Seq2seqTSN", "SAE", "OutputLayer", "CUBLayer",
           "Dropout", "LSTM", "BiLSTM",
           "TFLSTMCell", "PDDM", "PairSim", "PairSim2", "score_all_pairs",
           "score_rows", "score_all_pairs_sym", "InceptionV2",
           "ENDPOINT_CHANNELS", "graft_slim_variables", "graft_slim_npz",
           "InceptionResNetV2", "InceptionV1", "N_PIPELINE_UNITS",
           "build_encoder"]
