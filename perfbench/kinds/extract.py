"""Closed-loop per-frame feature extraction: one caller hands a batch of
uint8 frames to the callable of ``slim_backbone`` and waits for the
features on the host before it hands the next.

Parameters: ``frames_per_call``, ``frame_hw`` (the camera's height and
width), ``pool_calls`` (distinct batches made at set-up and cycled) and
``sampled_calls`` (calls of the window whose features are checked, drawn
from the seed).  The configuration gives the ``backbone`` and its
``image_size``.  Weights come from the seed on the device; no checkpoint
is read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import Reservoir, sub_seed
from perfbench.reference import inception_resnet_v2 as ref_trunk


class State:
    pass


def _frames(run) -> torch.Tensor:
    """The pool of frame batches [pool, B, H, W, 3] uint8 on the device."""
    p = run.params
    h, w = p["frame_hw"]
    g = torch.Generator(device=run.device).manual_seed(sub_seed(run.seed, 0))
    return torch.randint(0, 256, (p["pool_calls"], p["frames_per_call"], h,
                                  w, 3), generator=g, device=run.device,
                         dtype=torch.uint8)


def _weights(run):
    return ref_trunk.make_weights(sub_seed(run.seed, 1), run.device)


def setup(run):
    from multimodal_similarity_tpu_torch.preprocess.features import (
        slim_backbone)
    cfg = run.config
    st = State()
    st.run = run
    embed = slim_backbone(cfg["backbone"], image_size=cfg["image_size"],
                          device=run.device)
    weights = _weights(run)
    embed.model.load_state_dict(weights, strict=True)
    del weights
    st.embed = embed
    st.pool = _frames(run).cpu().numpy()
    for i in range(2):
        embed(st.pool[i % len(st.pool)])
    st.kept = Reservoir(run.params["sampled_calls"], sub_seed(run.seed, 2))
    return st


def window(st, seconds):
    run = st.run
    embed, pool, spans = st.embed, st.pool, run.spans
    run.synchronize()
    t0 = time.perf_counter()
    i = frames = 0
    while time.perf_counter() - t0 < seconds:
        with spans("slim_backbone.embed_fn"):
            out = embed(pool[i % len(pool)])
        frames += out.shape[0]
        st.kept.add((i % len(pool), out))
        i += 1
    window_s = time.perf_counter() - t0
    run.window_s = window_s
    run.counters.update(attempted=i, failed=0, calls=i, frames=frames)
    run.log(f"{i} batches, {frames} frames in {window_s:.3f} s")
    return {"extract_frames_per_s": frames / window_s}


def outputs(st):
    return list(st.kept.items)


def release(st):
    st.embed = None


class _Reference:
    def __init__(self, run, control):
        self.weights = _weights(run)
        self.frames = _frames(run)
        self.size = run.config["image_size"]
        self.control = control

    def features(self, pool_i: int) -> torch.Tensor:
        return ref_trunk.features(self.weights, self.frames[pool_i],
                                  self.size, self.control)


def reference(run, got):
    return _Reference(run, control=False)


def control(run, got):
    ref = _Reference(run, control=True)
    return [(i, ref.features(i).cpu().numpy()) for i, _ in got]


def compare(run, got, want):
    """``feature_gap``: the widest |returned - reference| over the checked
    batches, over the reference's largest magnitude."""
    if not got:
        return {"feature_gap": float("inf")}
    gap = 0.0
    for pool_i, out in got:
        ref = want.features(pool_i)
        out = torch.as_tensor(np.asarray(out), device=ref.device)
        if out.shape != ref.shape:
            return {"feature_gap": float("inf")}
        gap = max(gap, float((out - ref).abs().max()
                             / ref.abs().max().clamp(min=1e-30)))
    return {"feature_gap": gap}
