"""Model FLOPs from the configurations' shapes, the same whatever
implements them, and the peak they are held to.

A product of an [m, k] by a [k, n] operand counts 2 m k n; element-wise
work is not counted; recomputation is not counted."""

from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM, dense TF32 tensor-core rate (data sheet, 700 W): the
# fastest rate at which the card multiplies f32 operands
PEAK_FLOPS = 494.7e12


def convrtsn_forward(c: dict) -> float:
    """One event through ConvRTSN: the 1x1 channel embedding of each
    segment's map, then the LSTM over the segments."""
    hw = c["n_h"] * c["n_w"]
    e = c["emb_dim"]
    embed = 2 * hw * c["n_input"] * c["n_C"]
    lstm = 2 * (hw * c["n_C"] + e) * 4 * e
    return c["num_seg"] * (embed + lstm)


def rtsn_forward(c: dict, dim: int) -> float:
    """One event through a branch's RTSN: the input embedding of each
    segment, then the LSTM."""
    b = c["branch_emb_dim"]
    return c["num_seg"] * (2 * dim * b + 2 * (2 * b) * 4 * b)


def pddm_pair(c: dict) -> float:
    """One pair through a PDDM head: u, v, the joint layer, the score."""
    b = c["branch_emb_dim"]
    return 2 * (b * b + b * b + 2 * b * b + b * 2)


def flagship_step(c: dict) -> float:
    """One fused cached step of the flagship: the eval embedding of the
    budget, the semi-hard miner's anchor distances, both branches over the
    budget, PDDM over the hard anchors' rows, and the forward and backward
    (2x forward) of the mined rows."""
    n = c["event_per_batch"]
    t = c["triplet_per_batch"]
    pairs = -(-t // c["num_negative"])
    hard, struct = t, t // 2
    rows = 3 * (t + hard + struct)
    return (n * convrtsn_forward(c)
            + 2 * pairs * n * c["emb_dim"]
            + n * (rtsn_forward(c, c["sensors_dim"])
                   + rtsn_forward(c, c["segment_dim"]))
            + 2 * hard * n * pddm_pair(c)
            + 3 * rows * convrtsn_forward(c))


def retrieval_call(c: dict, p: dict) -> float:
    """One query call: the [Q, d] x [d, N] product."""
    return 2.0 * p["queries_per_call"] * p["gallery_rows"] * c["emb_dim"]


def trunk_frame(size: int) -> float:
    """One frame through the Inception-ResNet-v2 trunk at ``size`` x
    ``size``: its convolutions' products, shapes taken from a pass of the
    reference trunk on the meta device."""
    from perfbench.reference import inception_resnet_v2 as irv2
    weights = {}
    for key, cin, cout, k, _, _, bn in irv2.conv_shapes():
        weights[key + ".weight"] = torch.empty(cout, cin, *k, device="meta")
        for leaf in ((("_BatchNorm.bias", "_BatchNorm.running_mean",
                       "_BatchNorm.running_var") if bn else (".bias",))):
            weights[key + leaf] = torch.empty(cout, device="meta")
    record = []
    irv2.Trunk(weights, record=record)(
        torch.empty(1, 3, size, size, device="meta"))
    return float(sum(2 * math.prod(shape) for shape in record))
