"""Temporal encoders (``torch.nn``).

Counterparts of the JAX package's ``models/encoders.py``, the two
pretraining autoencoders (``Seq2seqTSN``, ``SAE``) included: the 1x1 "conv"
embedding is a Linear over the channel axis, the LSTM is the hand-written
TF cell (models/lstm.py), and dropout sits where the reference put it (input
dropout on the recurrent encoders, plain dropout in the MLPs).  Inputs keep
the JAX layout ``[B, S, ...]`` with channels last, and are cast to the
weights' type on entry: bf16 or dequantized int8 features reach the same
f32 math as flax's type promotion gives them.  Weights are Xavier-uniform
with zero bias, as ``tf.contrib.layers.xavier_initializer`` in the
reference.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from multimodal_similarity_tpu_torch.models.lstm import LSTM, BiLSTM

Generator = Optional[torch.Generator]


def dense(in_features: int, out_features: int,
          generator: Generator = None) -> nn.Linear:
    """Linear layer with Xavier-uniform weight and zero bias."""
    layer = nn.Linear(in_features, out_features)
    nn.init.xavier_uniform_(layer.weight, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class Dropout(nn.Module):
    """Inverted dropout drawing its mask from an explicit generator, which
    must live on the inputs' device (``None``: the global generator).

    Inside ``global_rows(b, rows)`` the forward runs on rows ``rows`` of a
    batch of ``b`` rows (one rank's share of a data-parallel batch): each
    mask is drawn for the whole batch and this share's rows kept, so the
    ranks together draw what one device would."""

    # (batch rows, this share's rows) while ``global_rows`` is open
    batch_rows: Optional[Tuple[int, slice]] = None

    def __init__(self, rate: float, generator: Generator = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    @staticmethod
    @contextlib.contextmanager
    def global_rows(b: int, rows: slice):
        Dropout.batch_rows = (b, rows)
        try:
            yield
        finally:
            Dropout.batch_rows = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        shape, keep_rows = x.shape, None
        if Dropout.batch_rows is not None:
            # a batch row is ``per`` leading rows of x here (a flattened
            # [rows x segments] layer keeps a row's segments together)
            b, rows = Dropout.batch_rows
            per = x.shape[0] // max(rows.stop - rows.start, 1)
            shape = (b * per,) + x.shape[1:]
            keep_rows = slice(rows.start * per, rows.stop * per)
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.rate
        if keep_rows is not None:
            keep = keep[keep_rows]
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class TSN(nn.Module):
    """2-layer MLP per segment, mean-pooled over segments."""

    def __init__(self, n_seg: int = 3, emb_dim: int = 128, n_input: int = 8,
                 keep_prob: float = 1.0, generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.n_seg, self.emb_dim, self.n_input = n_seg, emb_dim, n_input
        self.fc1 = dense(n_input, emb_dim, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.fc2 = dense(emb_dim, emb_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(self.fc1.weight.dtype)
        h = torch.relu(self.fc1(x.reshape(b * self.n_seg, self.n_input)))
        h = self.fc2(self.dropout(h))
        return h.reshape(b, self.n_seg, self.emb_dim).mean(dim=1)


# the emb_dim of the sensors and segment RTSN towers that the multimodal
# trainers and late-fusion evaluation pair with the video encoder
BRANCH_EMB_DIM = 32


class RTSN(nn.Module):
    """Linear embed + LSTM over segments, last output."""

    def __init__(self, n_seg: int = 3, emb_dim: int = 128, n_input: int = 8,
                 keep_prob: float = 1.0, generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.n_seg, self.emb_dim, self.n_input = n_seg, emb_dim, n_input
        self.fc1 = dense(n_input, emb_dim, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.lstm = LSTM(emb_dim, emb_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(self.fc1.weight.dtype)
        h = torch.relu(self.fc1(x.reshape(b * self.n_seg, self.n_input)))
        h = self.dropout(h.reshape(b, self.n_seg, self.emb_dim))
        outputs, _ = self.lstm(h)
        return outputs[:, -1]


class ConvEmbed(nn.Module):
    """relu(1x1 conv) channel embedding: [..., n_h, n_w, n_input] ->
    [..., n_h * n_w * n_C]."""

    def __init__(self, n_input: int = 1536, n_C: int = 20,
                 generator: Generator = None):
        super().__init__()
        self.conv1x1 = dense(n_input, n_C, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1x1.weight.dtype)
        return torch.relu(self.conv1x1(x)).flatten(-3)


class ConvTSN(nn.Module):
    """1x1 conv embed + FC, mean over segments (no dropout, as in the
    reference)."""

    def __init__(self, n_seg: int = 3, n_C: int = 20, emb_dim: int = 256,
                 n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                 generator: Generator = None):
        super().__init__()
        self.embed = ConvEmbed(n_input, n_C, generator)
        self.fc = dense(n_h * n_w * n_C, emb_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.embed(x)).mean(dim=1)


class ConvTSNClassifier(nn.Module):
    """ConvTSN with a per-segment softmax head averaged over segments;
    returns (feat, logits): the segment mean of the FC output, and the
    segment mean of the head over dropout(relu(FC output))."""

    def __init__(self, n_seg: int = 3, n_C: int = 20, emb_dim: int = 256,
                 n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                 n_output: int = 11, keep_prob: float = 1.0,
                 generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.embed = ConvEmbed(n_input, n_C, generator)
        self.fc = dense(n_h * n_w * n_C, emb_dim, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.head = dense(emb_dim, n_output, generator)

    def forward(self, x: torch.Tensor):
        h = self.fc(self.embed(x))                       # [B, S, emb]
        logits = self.head(self.dropout(torch.relu(h))).mean(dim=1)
        return h.mean(dim=1), logits


class ConvRTSN(nn.Module):
    """1x1 conv embed + LSTM over segments: the reference's video encoder."""

    def __init__(self, n_seg: int = 3, n_C: int = 20, emb_dim: int = 128,
                 n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                 keep_prob: float = 1.0, generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.embed = ConvEmbed(n_input, n_C, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.lstm = LSTM(n_h * n_w * n_C, emb_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.embed(x))                  # [B, S, h*w*C]
        outputs, _ = self.lstm(h)
        return outputs[:, -1]


class ConvBiRTSN(nn.Module):
    """1x1 conv embed + bidirectional LSTM (emb_dim / 2 a direction),
    both directions' outputs at the last step."""

    def __init__(self, n_seg: int = 3, n_C: int = 20, emb_dim: int = 128,
                 n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                 keep_prob: float = 1.0, generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.embed = ConvEmbed(n_input, n_C, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.bilstm = BiLSTM(n_h * n_w * n_C, emb_dim // 2,
                             generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bilstm(self.dropout(self.embed(x)))[:, -1]


class ConvLSTM(nn.Module):
    """1x1 conv embed + LSTM over whole frame sequences; the output at
    each sequence's true last frame, ``seq_len - 1``."""

    def __init__(self, max_time: int, n_C: int = 20, emb_dim: int = 128,
                 n_input: int = 1536, n_h: int = 8, n_w: int = 8,
                 generator: Generator = None):
        super().__init__()
        self.max_time = max_time
        self.embed = ConvEmbed(n_input, n_C, generator)
        self.lstm = LSTM(n_h * n_w * n_C, emb_dim, generator=generator)

    def forward(self, x: torch.Tensor, seq_len: torch.Tensor
                ) -> torch.Tensor:
        outputs, _ = self.lstm(self.embed(x))            # [B, T, emb]
        idx = (seq_len.to(torch.int64) - 1).reshape(-1, 1, 1)
        return outputs.gather(
            1, idx.expand(-1, 1, outputs.shape[-1]))[:, 0]


def _xavier(rows: int, cols: int, generator: Generator) -> nn.Parameter:
    """A raw [rows, cols] weight, Xavier-uniform (symmetric in the fans, so
    the flax [in, out] layout keeps its limit)."""
    w = torch.empty(rows, cols)
    nn.init.xavier_uniform_(w, generator=generator)
    return nn.Parameter(w)


def _zeros(size: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(size))


class Seq2seqTSN(nn.Module):
    """LSTM encoder-decoder autoencoder over TSN segments, for unsupervised
    pretraining; returns (hidden [B, emb], x_recon [B, n_seg, n_input]).

    ``reverse`` flips the segment order on entry.  Each segment goes
    through relu(x W_encode + b_encode) and dropout into the encoder LSTM,
    whose last output is the embedding; the decoder LSTM runs on zero
    inputs from the encoder's final state, and each of its outputs goes
    through relu(. W_decode1 + b_decode1), then the tied W_encode^T +
    b_decode2.  The raw weights are ``[in, out]`` parameters named as the
    flax ones (``convert.py`` maps them without a transpose)."""

    def __init__(self, n_seg: int, n_input: int = 8, emb_dim: int = 128,
                 reverse: bool = False, keep_prob: float = 1.0,
                 generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.n_seg, self.n_input, self.emb_dim = n_seg, n_input, emb_dim
        self.reverse = reverse
        self.W_encode = _xavier(n_input, emb_dim, generator)
        self.b_encode = _zeros(emb_dim)
        self.W_decode1 = _xavier(emb_dim, emb_dim, generator)
        self.b_decode1 = _zeros(emb_dim)
        self.b_decode2 = _zeros(n_input)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.encoder = LSTM(emb_dim, emb_dim, generator=generator)
        self.decoder = LSTM(n_input, emb_dim, generator=generator)

    def forward(self, x: torch.Tensor):
        x = x.to(self.W_encode.dtype)
        if self.reverse:
            x = x.flip(1)
        b = x.shape[0]
        h = torch.relu(x.reshape(-1, self.n_input) @ self.W_encode
                       + self.b_encode)
        h = self.dropout(h.reshape(b, self.n_seg, self.emb_dim))
        enc_out, enc_state = self.encoder(h)
        dec_out, _ = self.decoder(
            x.new_zeros((b, self.n_seg, self.n_input)), enc_state)
        hd = torch.relu(dec_out.reshape(-1, self.emb_dim) @ self.W_decode1
                        + self.b_decode1)
        x_recon = hd @ self.W_encode.T + self.b_decode2
        return enc_out[:, -1], x_recon.reshape(b, self.n_seg, self.n_input)


class SAE(nn.Module):
    """2-layer tied-weight autoencoder on flat [B, n_input] rows; returns
    (hidden [B, emb], x_recon [B, n_input]): hidden = relu(x W_1 + b_1) W_2
    + b_2, x_recon = relu(hidden W_2^T + b_3) W_1^T + b_4."""

    def __init__(self, n_input: int = 8, emb_dim: int = 128,
                 generator: Generator = None):
        super().__init__()
        self.W_1 = _xavier(n_input, emb_dim, generator)
        self.b_1 = _zeros(emb_dim)
        self.W_2 = _xavier(emb_dim, emb_dim, generator)
        self.b_2 = _zeros(emb_dim)
        self.b_3 = _zeros(emb_dim)
        self.b_4 = _zeros(n_input)

    def forward(self, x: torch.Tensor):
        x = x.to(self.W_1.dtype)
        hidden = torch.relu(x @ self.W_1 + self.b_1) @ self.W_2 + self.b_2
        h_recon = torch.relu(hidden @ self.W_2.T + self.b_3)
        return hidden, h_recon @ self.W_1.T + self.b_4


class OutputLayer(nn.Module):
    """2-layer FC projection head, dropout after the first layer's relu."""

    def __init__(self, n_input: int, n_output: int, keep_prob: float = 1.0,
                 generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.fc = dense(n_input, n_output, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.out = dense(n_output, n_output, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.fc.weight.dtype)
        return self.out(self.dropout(torch.relu(self.fc(x))))


class CUBLayer(nn.Module):
    """1-layer FC projection head with input dropout (the CUB track's
    head over 1024-d image features)."""

    def __init__(self, n_input: int, n_output: int, keep_prob: float = 1.0,
                 generator: Generator = None,
                 dropout_generator: Generator = None):
        super().__init__()
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.fc = dense(n_input, n_output, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.dropout(x.to(self.fc.weight.dtype)))
