"""Pipeline-parallel backbone inference over a unit-segmented trunk.

The port of the JAX package's ``parallel/pipeline.py``.  The trunk's
sequential units (``model.units``, an ``nn.ModuleList``; the
Inception-ResNet-v2 trunk has 44) are split into contiguous stages; each
stage is a copy of its run of units placed on its own ``torch.device``,
with its own CUDA stream there, so each device holds only its stage's
weights and the microbatches in flight.  A microbatch's activation passes
from stage to stage by a ``non_blocking`` copy (none when two stages
share a device), ordered by an event recorded on the producing stage's
stream; the host issues every (stage, microbatch) without waiting, so
while stage s runs microbatch m, stage s - 1 runs microbatch m + 1, and
the one synchronisation is the final readback.  An optional
``preprocess`` (uint8 frames -> resize -> scale) runs inside stage 0, so
raw bytes are what crosses the host link.

Stages may repeat a device (``devices=[cuda:0, cuda:0]``): the pipeline
then shares its card, a stream a stage, with whatever else runs there.
With ``devices=None`` the stages take the visible CUDA devices, one each,
and asking for more stages than there are raises.  On the CPU
(``devices=["cpu", ...]``) the stages run in turn.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def split_units_balanced(costs: Sequence[float],
                         n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous partition of units into ``n_stages`` ranges minimizing
    the maximum per-stage cost (the pipeline's steady-state step time is
    its slowest stage): the linear-partition DP of the JAX function, with
    its tie rule, so the bounds are the same."""
    n = len(costs)
    if not 1 <= n_stages <= n:
        raise ValueError(f"need 1 <= n_stages <= {n}, got {n_stages}")
    prefix = np.concatenate([[0.0], np.cumsum(np.asarray(costs, float))])
    # dp[s][i] = best max-stage-cost splitting units[:i] into s stages
    dp = np.full((n_stages + 1, n + 1), np.inf)
    cut = np.zeros((n_stages + 1, n + 1), np.int64)
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                c = max(dp[s - 1][j], prefix[i] - prefix[j])
                if c < dp[s][i]:
                    dp[s][i], cut[s][i] = c, j
    bounds, i = [], n
    for s in range(n_stages, 0, -1):
        j = int(cut[s][i])
        bounds.append((j, i))
        i = j
    return bounds[::-1]


def profile_unit_costs(model: nn.Module, n_units: int,
                       input_shape: Sequence[int],
                       microbatch: int = 1) -> List[float]:
    """Per-unit FLOP counts: each unit run once, in turn, on a zero
    ``[microbatch, *input_shape]`` input on the model's device, under
    ``torch.utils.flop_counter.FlopCounterMode``.  That counts the
    convolutions' and products' FLOPs only, where the JAX function reads
    XLA's cost analysis of each compiled unit, so the absolute numbers
    differ between the two packages; a stage split needs only their
    ratios."""
    from torch.utils.flop_counter import FlopCounterMode
    param = next(model.parameters())
    h = torch.zeros((microbatch,) + tuple(input_shape), dtype=param.dtype,
                    device=param.device)
    costs = []
    with torch.no_grad():
        for u in range(n_units):
            counter = FlopCounterMode(display=False)
            with counter:
                h = model.units[u](h)
            costs.append(float(counter.get_total_flops()))
    return costs


# Per-unit FLOP costs for the stock Inception-ResNet-v2 trunk at 299x299,
# relative to the stem (the JAX package's table, from XLA's cost analysis;
# 32.3 GFLOP a frame in all).  Only the ratios matter for the stage
# balance, and they hardly depend on the input size (every unit scales
# with the same spatial map).
INCEPTION_RESNET_V2_UNIT_COSTS: List[float] = (
    [1.0, 0.2526] + [0.1174] * 10 + [1.1854] + [0.2924] * 20
    + [0.5139] + [0.0876] * 9 + [0.2266])


class _Stage(nn.Module):
    """A contiguous run of units (and, on stage 0, the preprocessing)."""

    def __init__(self, units: Sequence[nn.Module],
                 preprocess: Optional[Callable] = None):
        super().__init__()
        self.units = nn.ModuleList(units)
        self.preprocess = preprocess

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.preprocess is not None:
            h = self.preprocess(h)
        for unit in self.units:
            h = unit(h)
        return h


class PipelinedBackbone:
    """Stage-split inference over ``model.units`` (eval mode, no grad).

    ``input_shape`` is one input row as ``__call__`` takes it (for the
    feature extractor, a uint8 frame [H, W, 3] that ``preprocess`` turns
    into the trunk's input).  Stage ``s`` holds a copy of units
    ``stage_ranges[s]`` on ``devices[s]``; ``model`` itself is not moved.
    The units must cover the model's parameters and buffers and share
    none, or the constructor raises, as the JAX one does for variables
    that are missing, claimed twice or left over.  The constructor runs
    one microbatch of zeros through the stages to learn each boundary's
    shape.
    """

    def __init__(self, model: nn.Module, n_units: int,
                 input_shape: Sequence[int], n_stages: Optional[int] = None,
                 devices: Optional[Sequence] = None, microbatch: int = 8,
                 unit_costs: Optional[Sequence[float]] = None,
                 stage_ranges: Optional[Sequence[Tuple[int, int]]] = None,
                 preprocess: Optional[Callable] = None,
                 input_dtype: torch.dtype = torch.float32):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if n_stages is not None:
                if n_stages > len(devices):
                    # refuse to collapse silently: a one-card host asked
                    # for a 4-stage pipeline would otherwise measure a
                    # layout that never existed
                    raise ValueError(
                        f"pipeline needs {n_stages} devices but only "
                        f"{len(devices)} are visible — pass fewer stages "
                        f"(or devices= explicitly)")
                devices = devices[:n_stages]
        self.devices = [torch.device(d) for d in devices]
        n_stages = len(self.devices)
        if n_stages < 1:
            raise ValueError("need at least one device")
        if len(model.units) != n_units:
            raise ValueError(f"the model has {len(model.units)} units, not "
                             f"{n_units}")
        self.microbatch = int(microbatch)
        if stage_ranges is None:
            costs = (list(unit_costs) if unit_costs is not None
                     else [1.0] * n_units)
            if len(costs) != n_units:
                raise ValueError(
                    f"unit_costs has {len(costs)} entries, trunk has "
                    f"{n_units} units")
            stage_ranges = split_units_balanced(costs, n_stages)
        self.stage_ranges = [tuple(r) for r in stage_ranges]
        if (len(self.stage_ranges) != n_stages
                or self.stage_ranges[0][0] != 0
                or self.stage_ranges[-1][1] != n_units
                or any(a[1] != b[0] for a, b in zip(self.stage_ranges,
                                                    self.stage_ranges[1:]))):
            raise ValueError(
                f"stage ranges {self.stage_ranges} do not tile "
                f"[0, {n_units}) over {n_stages} devices")
        self._check_cover(model)

        self.stages: List[_Stage] = []
        self.streams: List[Optional[torch.cuda.Stream]] = []
        for s, (lo, hi) in enumerate(self.stage_ranges):
            dev = self.devices[s]
            units = [copy.deepcopy(model.units[u]) for u in range(lo, hi)]
            stage = _Stage(units, preprocess if s == 0 else None)
            self.stages.append(stage.to(dev).eval())
            self.streams.append(torch.cuda.Stream(dev)
                                if dev.type == "cuda" else None)
        h = torch.zeros((self.microbatch,) + tuple(input_shape),
                        dtype=input_dtype)
        self.boundary_shapes = [tuple(h.shape)]
        with torch.no_grad():
            for s, stage in enumerate(self.stages):
                h = stage(h.to(self.devices[s]))
                self.boundary_shapes.append(tuple(h.shape))
            if self.devices[-1].type == "cuda":
                torch.cuda.synchronize(self.devices[-1])

    @staticmethod
    def _check_cover(model: nn.Module) -> None:
        owner = {}
        for u, unit in enumerate(model.units):
            for t in list(unit.parameters()) + list(unit.buffers()):
                if id(t) in owner and owner[id(t)] != u:
                    raise ValueError(
                        f"unit {u} re-claims a tensor of unit "
                        f"{owner[id(t)]} — units are not disjoint")
                owner[id(t)] = u
        left = [n for n, t in list(model.named_parameters())
                + list(model.named_buffers()) if id(t) not in owner]
        if left:
            raise ValueError(f"parameters and buffers not claimed by any "
                             f"stage: {left[:3]}")

    def stage_parameter_counts(self) -> List[int]:
        """Each stage's parameter and buffer elements (the JAX count of
        its ``params`` and ``batch_stats`` leaves)."""
        return [sum(t.numel() for t in list(st.parameters())
                    + list(st.buffers())) for st in self.stages]

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """Stream ``frames`` [B, *input_shape] through the stages; returns
        the last stage's output as f32 numpy."""
        n = frames.shape[0]
        if n == 0:
            return np.zeros((0,) + tuple(self.boundary_shapes[-1][1:]),
                            np.float32)
        mb = self.microbatch
        pad = (-n) % mb
        if pad:
            frames = np.concatenate(
                [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.devices[0].type == "cuda":
            host = host.pin_memory()
        outs = []
        with torch.no_grad():
            for i in range(0, host.shape[0], mb):
                outs.append(self._issue(host[i:i + mb]))
            last = self.devices[-1]
            if last.type == "cuda":
                current = torch.cuda.current_stream(last)
                for h, event in outs:
                    current.wait_event(event)
                    h.record_stream(current)
            out = torch.cat([h for h, _ in outs]).float().cpu()
        return out.numpy()[:n]

    def _issue(self, x: torch.Tensor):
        """One microbatch through every stage, issued without a wait:
        (the output, the event after it on the last stage's stream)."""
        event = None
        h = x
        for s, stage in enumerate(self.stages):
            dev, stream = self.devices[s], self.streams[s]
            if stream is None:
                h = stage(h.to(dev))
                continue
            with torch.cuda.stream(stream):
                if event is not None:
                    stream.wait_event(event)
                    h.record_stream(stream)
                h = stage(h.to(dev, non_blocking=True))
                nxt = self.devices[s + 1] if s + 1 < len(self.stages) \
                    else None
                if nxt is not None and nxt != dev:
                    # a copy to another card runs on this stream, after
                    # the stage; the next stage waits for the event
                    h = h.to(nxt, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        return h, event

