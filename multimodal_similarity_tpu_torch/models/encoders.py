"""Temporal encoders (``torch.nn``).

Counterparts of the JAX package's ``models/encoders.py``: the 1x1 "conv"
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

from typing import Optional

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
    must live on the inputs' device (``None``: the global generator)."""

    def __init__(self, rate: float, generator: Generator = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
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
