"""Model zoo: the temporal encoders ported so far.

``build_encoder`` mirrors the reference trainers' ``--network`` dispatch.
"""

from __future__ import annotations

from multimodal_similarity_tpu_torch.models.encoders import (
    RTSN, ConvEmbed, ConvRTSN, Dropout)
from multimodal_similarity_tpu_torch.models.lstm import LSTM, TFLSTMCell

# networks of the JAX package's build_encoder still to port, and the
# ROADMAP slice that ports each
_NOT_PORTED = {"tsn": 3, "convtsn": 3, "convbirtsn": 3, "convlstm": 3}


def build_encoder(network: str, *, num_seg: int = 3, emb_dim: int = 128,
                  n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                  n_C: int = 20, keep_prob: float = 1.0,
                  generator=None, dropout_generator=None):
    """Encoder factory keyed by the reference's --network flag values.

    ``generator`` draws the initial weights (on the CPU);
    ``dropout_generator`` draws the dropout masks and must live on the
    device the model runs on."""
    rngs = dict(generator=generator, dropout_generator=dropout_generator)
    if network == "rtsn":
        return RTSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                    keep_prob=keep_prob, **rngs)
    if network == "convrtsn":
        return ConvRTSN(n_seg=num_seg, emb_dim=emb_dim, n_input=n_input,
                        n_h=n_h, n_w=n_w, n_C=n_C, keep_prob=keep_prob,
                        **rngs)
    if network in _NOT_PORTED:
        raise NotImplementedError(
            f"network {network!r} is not ported yet (ROADMAP slice "
            f"{_NOT_PORTED[network]})")
    raise NotImplementedError(f"unknown network: {network}")


__all__ = ["RTSN", "ConvEmbed", "ConvRTSN", "Dropout", "LSTM", "TFLSTMCell",
           "build_encoder"]
