#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_similarity_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no error is caught):
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every CUDA kernel from ``multimodal_similarity_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. batch-hard kernels: K1 (``batch_hard_stats_idx``) and K2
   (``batch_hard_stats``) against their plain PyTorch version on the card,
   and K3 (``batch_hard_tri_idx``, ``batch_hard_tri``) against K1/K2 bit for
   bit (bf16 on the tensor cores, f32 on FMA), at the trainer's shape
   (N=512, d=128) in bf16 and f32, on exact small-integer inputs (values
   and winner columns bit-equal, the lowest-column tie rule exercised), at
   ragged N and d with a valid mask and 64-bit labels on both tile edges
   of K3 in each type, at bf16 depths TMA needs padded (d=90, 100; exact
   and float), on an operand view whose base is not 16-byte aligned, on
   rows with no valid negative, at N=8192 with d=128 and d=1024, and at the
   validation shape on the trained model's embeddings; the gradient through
   the autograd wrapper against a dense autograd oracle; kernel, plain,
   library (``torch.matmul``) and bound times;
4. the K1-vs-K3 timing grid (N x d in bf16) that sets ``use_triangular``,
   with the plain version's and the library product's times at its largest
   cell (N=16384, d=1024);
5. the fused-mining path at the kernel sweep's shapes (N=8192 and 16384,
   d=1024, bf16): ``batch_hard_fused`` forward and backward with
   algo="tri", "row" and "auto" (loss, stats and gradient bit-equal), the
   no-grad stats through both kernels, launch counts; then the mining-call
   time of each entry point per ``algo``;
6. K7 (``sqdist``, f32 on 3xTF32 tensor cores) against its plain version
   at three shapes and a ragged one TMA needs padded (777x501x90),
   duplicate rows included; kernel, plain, library and bound times; the
   public ``sqdist`` at the three shapes as its path, with its launch
   count;
7. lifted kernels: K4 (``lifted_fwd``), K5 (``lifted_bwd``) and K6
   (``lifted_fwd_tri``; all three f32 on 3xTF32 tensor cores, bf16 on FMA)
   against their plain PyTorch versions on the card, at the trainer's
   shape (N=512, d=128) in f32 and bf16, unnormalised inputs for K4/K5,
   ragged N and d with a valid mask and 64-bit labels, f32 depths TMA
   needs padded (d=90, bounded and not), inputs exact in TF32, rows with
   no valid negative, N=8192 and N=16384 with d=128, K5 after both
   forwards and at d=1536 (bounded, after K4 and K6) and 2048 (12 and 16
   chunks of its 128 gradient columns), and the gradient through
   ``lifted_loss_fused`` against dense autograd (bounded and not); kernel,
   plain, library and bound times, K4's, K5's and K6's launches apart, and
   K5 and K6 bit-identical from call to call;
8. trainer: the port's batch-hard trainer, ConvRTSN at full width (3 TSN
   segments of 8x8x1536 resnet maps, n_C=20, emb_dim=128, class-balanced
   batch 512, event budget 1000, 3 sessions per batch, Adam eps=0.1) on a
   synthetic Honda directory with random weights, 2 epochs; asserts finite
   losses, one winner-tracking batch-hard launch per optimizer step and a
   stats-only one per validation (K3 or K1/K2, as ``use_triangular`` picks
   at each shape), and the device retrieval metrics against the NumPy
   oracle;
9. the lifted trainer at the same width on the same directory: 2 epochs
   normalised (one K6 launch per step and per validation, one K5 launch per
   step, no K4), then 1 epoch with ``--no_normalized`` (K4 in place of K6),
   with the same metric checks, and a step breakdown of each trainer.
Then a ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is visible or the port's package is not beside this script.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "batch_hard_stats_idx": "multimodal_similarity_tpu_torch/csrc/batch_hard.cu",
    "batch_hard_stats": "multimodal_similarity_tpu_torch/csrc/batch_hard.cu",
    "lifted_fwd": "multimodal_similarity_tpu_torch/csrc/lifted.cu",
    "lifted_bwd": "multimodal_similarity_tpu_torch/csrc/lifted.cu",
    "lifted_fwd_tri": "multimodal_similarity_tpu_torch/csrc/lifted.cu",
    "batch_hard_tri_idx": "multimodal_similarity_tpu_torch/csrc/batch_hard.cu",
    "batch_hard_tri": "multimodal_similarity_tpu_torch/csrc/batch_hard.cu",
    "sqdist": "multimodal_similarity_tpu_torch/csrc/distance.cu",
}
REPLACES = {
    "batch_hard_stats_idx":
        "multimodal_similarity_tpu/ops/pallas/batch_hard.py:110",
    "batch_hard_stats":
        "multimodal_similarity_tpu/ops/pallas/batch_hard.py:151",
    "lifted_fwd": "multimodal_similarity_tpu/ops/pallas/lifted.py:85",
    "lifted_bwd": "multimodal_similarity_tpu/ops/pallas/lifted.py:126",
    "lifted_fwd_tri": "multimodal_similarity_tpu/ops/pallas/lifted_tri.py:93",
    "batch_hard_tri_idx":
        "multimodal_similarity_tpu/ops/pallas/batch_hard_tri.py:123",
    "batch_hard_tri": "multimodal_similarity_tpu/ops/pallas/batch_hard_tri.py:91",
    "sqdist": "multimodal_similarity_tpu/ops/pallas/distance.py:23",
}
BATCH_HARD = ("batch_hard_stats_idx", "batch_hard_stats", "batch_hard_tri_idx",
              "batch_hard_tri")
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12   # f32 outside the tensor cores: the epilogues
# products per second by operand type: bf16 on the tensor cores; f32-grade
# products at the 3xTF32 rate, three TF32 products each at 495 TFLOP/s, the
# least time the card can take for them (the f32 K4 runs so).  Epilogues
# stay at the f32 rate.
PRODUCT_OPS_PER_S = {"bf16": 989e12, "f32": 495e12 / 3}
# f32 epilogue operations per (row, column) pair: norm add, -2x fused
# subtract, clamp, the positive and negative selects, the max and min
# compares and the negative-count add
EPILOGUE_OPS = 8
# the lifted kernels' f32 epilogue operations per pair they visit, beside
# their exponentials (counted apart, at the SFU rate):
#  K4: norm add, -2x fused subtract, clamp, label compare, the v_pos
#      select and penalty, v_neg, the two max compares, the two exp
#      arguments and sum adds, the negative-count add: 14
#  K5, per ordered pair and direction: norm add, fused subtract, clamp,
#      label compare, select, exp argument, the g multiply and the add
#      into C, the rowsum add: 9
#  K6, per visited pair: norm add, fused subtract, clamp, label compare,
#      the P and Ng selects, exp argument, and six weighted adds (three
#      per side): 13
LIFTED_EPILOGUE_OPS = {"lifted_fwd": 14, "lifted_bwd": 18,
                       "lifted_fwd_tri": 13}
# special-function units: 16 results per SM per clock (Hopper), times the
# SMs and the card's maximum SM clock read from nvidia-smi
SFU_PER_SM_CLOCK = 16
MARGIN = 0.2


def fail(msg):
    raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters=20, warmup=3):
    """Per call, back to back, host work included: CUDA events around
    ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps=10, iters=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times between CUDA events, so no host work shows."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return call_ms(graph.replay, iters=iters, warmup=1) / reps


def bound(n, d, precision, with_idx, triangular=False):
    """(bound_ms, bound_by): each input read once, each output written
    once; the products at the operand type's product rate and the epilogue
    at the f32 peak.  The triangular walk (K3) needs the products of the upper
    triangle alone, n (n + 1) / 2 pairs, and both sides' epilogue: the same
    n^2 pair epilogues as the row walk."""
    esize = 2 if precision == "bf16" else 4
    # operand, sq, sq_pen, valid (f32), labels (int64); fp, cn, nc (+ idx)
    nbytes = n * d * esize + n * (4 * 3 + 8) + n * 4 * (5 if with_idx else 3)
    t_bytes = nbytes / HBM_BYTES_PER_S
    products = (n * (n + 1) if triangular else 2.0 * n * n) * d
    t_ops = (products / PRODUCT_OPS_PER_S[precision]
             + EPILOGUE_OPS * n * n / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sm_count():
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def make_case(n, d, kind, gen, n_classes=7, invalid_frac=0.0,
              label_offset=0):
    import torch
    labels = torch.randint(0, n_classes, (n,), generator=gen)
    if kind == "int":
        # small integers: every product and sum is exact in f32 and bf16,
        # so any summation order gives bit-equal distances and ties
        emb = torch.randint(-3, 4, (n, d), generator=gen).float()
    elif kind == "tf32":
        # sixteenths of small integers: exact in TF32 (lo = 0), products
        # and sums exact in f32, distances at most 18 at d=128
        emb = torch.randint(-3, 4, (n, d), generator=gen).float() / 16
    else:
        centers = torch.randn(n_classes, d, generator=gen)
        emb = centers[labels] + 0.8 * torch.randn(n, d, generator=gen)
        emb = emb / emb.norm(dim=1, keepdim=True)
    valid = (torch.rand(n, generator=gen) >= invalid_frac).float()
    return (emb.cuda(), (labels + label_offset).cuda(), valid.cuda())


def check_case(name, n, d, precision, kind, gen, **kw):
    return check_inputs(name, *make_case(n, d, kind, gen, **kw), precision,
                        exact=kind == "int")


def check_inputs(name, emb, labels, valid, precision, exact=False):
    """K1 and K2 against the plain version on the same card inputs, and K3
    (idx and not) against K1 and K2, bit for bit; returns (operands,
    max_abs_err)."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands, stats_kernel, stats_plain)
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri import (
        tri_stats_kernel, tri_tile)
    ops = prep_operands(emb, labels, valid, precision)
    n, d = ops.opd.shape
    k1 = stats_kernel(ops, True)
    k2 = stats_kernel(ops, False)
    p1 = stats_plain(ops, True)
    torch.cuda.synchronize()
    # f32 summation-order error over unit-norm rows is ~d * 2^-24; exact
    # inputs leave no error at all
    tol = 0.0 if exact else 1e-4 * max(1.0, d / 128)
    fp_k, cn_k, nc_k, fpi_k, cni_k = k1
    fp_p, cn_p, nc_p, fpi_p, cni_p = p1
    sentinel = cn_p >= 0.5e30
    if not torch.equal(sentinel, cn_k >= 0.5e30):
        fail(f"{name}: no-negative rows differ")
    err = max(float((fp_k - fp_p).abs().max()),
              float((cn_k - cn_p)[~sentinel].abs().max())
              if (~sentinel).any() else 0.0)
    if not err <= tol:
        fail(f"{name}: K1 max_abs_err {err} > {tol}")
    if not torch.equal(nc_k, nc_p):
        fail(f"{name}: negative counts differ")
    # K2 runs the same arithmetic without the winner columns
    for a, b, what in ((k2[0], fp_k, "fp"), (k2[1], cn_k, "cn"),
                       (k2[2], nc_k, "nc")):
        if not torch.equal(a, b):
            fail(f"{name}: K2 {what} differs from K1")
    # winner columns: exact where the winner is clear; a mismatch is
    # allowed only for a near-tie within tol in the plain distances
    mism = 0
    for ik, ip in ((fpi_k, fpi_p), (cni_k, cni_p)):
        rows = torch.nonzero(ik != ip).flatten()
        mism += rows.numel()
        if rows.numel() and tol == 0.0:
            fail(f"{name}: {rows.numel()} winner columns differ on exact "
                 "inputs")
        if rows.numel():
            # the kernel's own distance formula on the tied rows
            opd = ops.opd.float()
            dist = (ops.sq[rows, None] + ops.sq_pen[None, :]
                    - 2.0 * (opd[rows] @ opd.T)).clamp(min=0.0)
            gap = (dist.gather(1, ik[rows, None].long())
                   - dist.gather(1, ip[rows, None].long())).abs()
            if float(gap.max()) > 2 * tol:
                fail(f"{name}: winner columns differ beyond a near-tie "
                     f"(gap {float(gap.max())})")
    # K3 keeps K1's product chain and epilogue: every output bit-equal
    k3 = tri_stats_kernel(ops, True)
    k3n = tri_stats_kernel(ops, False)
    torch.cuda.synchronize()
    for got, want, kname in ((k3, k1, "batch_hard_tri_idx"),
                             (k3n, k2, "batch_hard_tri")):
        for a, b, what in zip(got, want, ("fp", "cn", "nc", "fpi", "cni")):
            if not torch.equal(a, b):
                fail(f"{name}: {kname} {what} differs from the row kernel "
                     f"({int((a != b).sum())} rows)")
    print(f"[kernels] {name}: N={n} d={d} {precision} "
          f"{'exact' if exact else 'float'} "
          f"max_abs_err={err:.3g} (tol {tol:.3g}) nc exact, "
          f"winner mismatches {mism} (near-ties); K3 (tile "
          f"{tri_tile(n, sm_count(), precision == 'bf16')}) bit-equal to "
          f"K1/K2, "
          f"{int(sentinel.sum())} no-negative rows", flush=True)
    return ops, err


def check_unaligned(gen):
    """K1/K2 and K3 on a bf16 operand view whose base is 2 bytes past a
    16-byte boundary (the wrappers copy it for TMA), bit-equal to the same
    kernels on the aligned operand."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands, stats_kernel)
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri import (
        tri_stats_kernel)
    ops = prep_operands(*make_case(1000, 72, "float", gen, invalid_frac=0.1),
                        "bf16")
    flat = torch.empty(ops.opd.numel() + 1, dtype=ops.opd.dtype,
                       device=ops.opd.device)
    view = flat[1:].view(ops.opd.shape)
    view.copy_(ops.opd)
    if view.data_ptr() % 16 == 0:
        fail("unaligned: the view is 16-byte aligned")
    moved = ops._replace(opd=view)
    for kernel in (stats_kernel, tri_stats_kernel):
        for with_idx in (True, False):
            want = kernel(ops, with_idx)
            got = kernel(moved, with_idx)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    fail(f"unaligned: {kernel.__name__} (with_idx="
                         f"{with_idx}) differs on the unaligned view")
    print(f"[kernels] unaligned-view: N=1000 d=72 bf16, operand base at "
          f"{view.data_ptr() % 16} bytes past 16: K1/K2 and K3 bit-equal "
          f"to the aligned operand", flush=True)


def time_case(name, ops, precision):
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        stats_kernel, stats_plain)
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri import (
        tri_stats_kernel)
    n, d = ops.opd.shape
    lib_ms = device_ms(lambda: torch.matmul(ops.opd, ops.opd.T))
    rows = {}
    for kname, kernel, with_idx in (
            ("batch_hard_stats_idx", stats_kernel, True),
            ("batch_hard_stats", stats_kernel, False),
            ("batch_hard_tri_idx", tri_stats_kernel, True),
            ("batch_hard_tri", tri_stats_kernel, False)):
        # in turns: plain, kernel, kernel, plain
        p_a = device_ms(lambda: stats_plain(ops, with_idx))
        k_a = device_ms(lambda: kernel(ops, with_idx))
        k_b = device_ms(lambda: kernel(ops, with_idx))
        p_b = device_ms(lambda: stats_plain(ops, with_idx))
        b_ms, b_by = bound(n, d, precision, with_idx,
                           triangular=kernel is tri_stats_kernel)
        rows[kname] = {"ms": min(k_a, k_b), "plain_ms": min(p_a, p_b),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib_ms,
                       "call_ms": call_ms(lambda: kernel(ops, with_idx))}
        print(f"[timing] {name} {kname}: N={n} d={d} {precision} "
              + json.dumps(rows[kname]), flush=True)
    return rows


def check_gradient(gen):
    import torch
    from multimodal_similarity_tpu_torch.ops.distances import (
        pairwise_distance)
    from multimodal_similarity_tpu_torch.ops.kernels import batch_hard_fused
    from multimodal_similarity_tpu_torch.ops.losses import batch_hard
    emb, labels, _ = make_case(512, 128, "float", gen)
    e1 = emb.clone().requires_grad_(True)
    loss_k = batch_hard_fused(e1, labels, "soft", True, precision="f32")[0]
    loss_k.backward()
    e2 = emb.clone().requires_grad_(True)
    loss_d = batch_hard(pairwise_distance(e2, e2), labels, "soft", True)[0]
    loss_d.backward()
    torch.cuda.synchronize()
    gmax = float(e2.grad.abs().max())
    err = float((e1.grad - e2.grad).abs().max())
    # f32 sum-order differences between the two distance products only
    tol = 1e-4 * gmax + 1e-7
    print(f"[kernels] gradient through the autograd wrapper (K1 + "
          f"winner-pair scatter) vs dense autograd: loss "
          f"{loss_k.item():.6f} vs {loss_d.item():.6f}, max_abs_err "
          f"{err:.3g} (tol {tol:.3g})", flush=True)
    if not (abs(loss_k.item() - loss_d.item()) <= 1e-5 and err <= tol):
        fail("gradient through the kernel disagrees with dense autograd")


def kernel_phase():
    import torch
    gen = torch.Generator().manual_seed(0)
    for precision in ("bf16", "f32"):
        ops, err = check_case(f"slice-{precision}", 512, 128, precision,
                              "float", gen)
        rows = time_case(f"slice-{precision}", ops, precision)
        if precision == "bf16":  # the trainer's shape and precision
            main, main_err = rows, err
    for precision in ("bf16", "f32"):
        check_case(f"exact-{precision}", 512, 128, precision, "int", gen)
    check_case("ragged-valid-int64", 1000, 72, "f32", "float", gen,
               invalid_frac=0.1, label_offset=2 ** 40)
    check_case("ragged-valid-exact", 777, 128, "bf16", "int", gen,
               invalid_frac=0.2, label_offset=2 ** 33)
    # bf16 at a depth that is not a multiple of 8 (padded for TMA): ragged
    # rows, columns and k-slice, K3's 128-wide tiles at N=4500
    check_case("ragged-valid-exact-wide", 4500, 100, "bf16", "int", gen,
               invalid_frac=0.2, label_offset=2 ** 33)
    # ragged rows and depth on the f32 K3's 32-wide tiles (the f32 case
    # above takes its 64-wide tiles at N=1000)
    check_case("ragged-valid-exact-tri32", 700, 90, "f32", "int", gen,
               invalid_frac=0.2, label_offset=2 ** 35)
    check_inputs("no-valid-negative", *no_negative_case(300, 100, gen),
                 "f32")
    # more bf16 depths that TMA needs padded, exact and float, on K3's
    # 64-wide (N=777) and 128-wide (N=4500) tiles; then an operand whose
    # base is not 16-byte aligned
    check_case("ragged-d90-exact", 777, 90, "bf16", "int", gen,
               invalid_frac=0.2, label_offset=2 ** 34)
    check_case("ragged-d90-float", 777, 90, "bf16", "float", gen,
               invalid_frac=0.2, label_offset=2 ** 34)
    check_case("ragged-d100-float", 4500, 100, "bf16", "float", gen,
               invalid_frac=0.2, label_offset=2 ** 33)
    check_unaligned(gen)
    for d in (128, 1024):
        ops, _ = check_case(f"large-d{d}", 8192, d, "bf16", "float", gen,
                            n_classes=64)
        time_case(f"large-d{d}", ops, "bf16")
        k3_combine_cost(ops)
    check_gradient(gen)
    return main, main_err


def random_operands(n, d, precision, seed, n_classes=64):
    """Clustered unit-norm rows from a seed, on the card: the operands of
    the timing grid and the mining path."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands)
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, n_classes, (n,), generator=gen)
    centers = torch.randn(n_classes, d, generator=gen)
    emb = centers[labels] + 0.8 * torch.randn(n, d, generator=gen)
    emb = (emb / emb.norm(dim=1, keepdim=True)).cuda()
    labels = labels.cuda()
    valid = torch.ones(n).cuda()
    return emb, labels, prep_operands(emb, labels, valid, precision)


GATE_NS = (16, 32, 64, 128, 256, 512, 2048, 4096, 8192, 16384)
GATE_DS = (128, 512, 1024)


def gate_grid():
    """K1 against K3 (and K2 against K3 without winners) in bf16 over
    GATE_NS x GATE_DS, device time in turns (row, tri, tri, row): the
    measurements that set ``use_triangular``.  Prints each cell with the
    gate's choice beside the faster kernel."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import use_triangular
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        stats_kernel)
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri import (
        tri_stats_kernel)
    sms = sm_count()
    agree = total = 0
    for n in GATE_NS:
        for d in GATE_DS:
            _, _, ops = random_operands(n, d, "bf16", seed=n + d)
            cell = {}
            for with_idx, tag in ((True, "idx"), (False, "noidx")):
                r_a = device_ms(lambda: stats_kernel(ops, with_idx))
                t_a = device_ms(lambda: tri_stats_kernel(ops, with_idx))
                t_b = device_ms(lambda: tri_stats_kernel(ops, with_idx))
                r_b = device_ms(lambda: stats_kernel(ops, with_idx))
                cell[tag] = (min(r_a, r_b), min(t_a, t_b))
            gate = use_triangular(n, d, sms)
            faster = cell["idx"][1] < cell["idx"][0]
            b_ms = bound(n, d, "bf16", True, triangular=True)[0]
            agree += gate == faster
            total += 1
            print(f"[gate] N={n} d={d} bf16: K1 {cell['idx'][0]:.5f} ms, "
                  f"K3 idx {cell['idx'][1]:.5f} ms (x"
                  f"{cell['idx'][0] / cell['idx'][1]:.3f}); K2 "
                  f"{cell['noidx'][0]:.5f} ms, K3 {cell['noidx'][1]:.5f} ms "
                  f"(x{cell['noidx'][0] / cell['noidx'][1]:.3f}); K3 idx "
                  f"bound {b_ms:.5f} ms; gate "
                  f"{'tri' if gate else 'row'}, faster "
                  f"{'tri' if faster else 'row'}", flush=True)
            del ops
            torch.cuda.empty_cache()
    print(f"[gate] use_triangular picks the faster winner-tracking kernel "
          f"in {agree} of {total} cells", flush=True)


def gate_corner_times():
    """K1/K2's plain version and the library product (one
    ``torch.matmul``) at the grid's largest cell, N=16384, d=1024 bf16, the
    kernel table's last column of K1-K3 (CUDA-graph replay of 3 calls,
    plain and library in turns)."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        stats_plain)
    n, d = GATE_NS[-1], GATE_DS[-1]
    _, _, ops = random_operands(n, d, "bf16", seed=n + d)
    times = {}
    calls = {"plain_idx": lambda: stats_plain(ops, True),
             "plain_noidx": lambda: stats_plain(ops, False),
             "library": lambda: torch.matmul(ops.opd, ops.opd.T)}
    for key in list(calls) + list(calls)[::-1]:
        t = device_ms(calls[key], reps=3, iters=3)
        times[key] = min(times.get(key, t), t)
    print(f"[gate] N={n} d={d} bf16 plain and library ms "
          + json.dumps(times), flush=True)
    del ops
    torch.cuda.empty_cache()


MINING_NS, MINING_D = (8192, 16384), 1024


def mining_path():
    """The fused-mining entry points at the kernel sweep's shapes
    (bench.py:312-314: N=8192 and 16384, d=1024, bf16, 64 classes), every
    launch count set to 0 just before and read just after: forward and
    backward through ``batch_hard_fused`` with algo="tri" and "row" (loss,
    stats and gradient equal), the no-grad stats through both, and
    algo="auto".  Returns the launch counts."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, batch_hard_fused, fused_batch_hard_stats,
        reset_launch_counts, use_triangular)
    sms = sm_count()
    want = dict.fromkeys(BATCH_HARD, 0)
    reset_launch_counts()
    for n in MINING_NS:
        emb, labels, _ = random_operands(n, MINING_D, "bf16", seed=n)
        res = {}
        t0 = time.time()
        # the winner scatter (index_add_) takes its deterministic CUDA
        # path here, so equal winners give bit-equal gradients
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for algo in ("tri", "row", "auto"):
                e = emb.clone().requires_grad_(True)
                out = batch_hard_fused(e, labels, "soft", True,
                                       precision="bf16", algo=algo)
                out[0].backward()
                res[algo] = (out[0].detach(), out[4].detach(),
                             out[5].detach(), e.grad)
        finally:
            torch.use_deterministic_algorithms(False)
        with torch.no_grad():
            ng = {algo: fused_batch_hard_stats(emb, labels, None, "bf16",
                                               algo)
                  for algo in ("tri", "row")}
        torch.cuda.synchronize()
        wall = time.time() - t0
        tri = use_triangular(n, MINING_D, sms)
        want["batch_hard_tri_idx"] += 1 + tri
        want["batch_hard_stats_idx"] += 1 + (not tri)
        want["batch_hard_tri"] += 1
        want["batch_hard_stats"] += 1
        for algo in ("row", "auto"):
            for a, b, what in zip(res["tri"], res[algo],
                                  ("loss", "fp", "cn", "grad")):
                if not torch.equal(a, b):
                    fail(f"mining N={n}: {what} through algo='tri' differs "
                         f"from algo='{algo}' (max "
                         f"{float((a - b).abs().max()):.3g})")
        for a, b in zip(ng["tri"], ng["row"]):
            if not torch.equal(a, b):
                fail(f"mining N={n}: no-grad stats differ between tri and "
                     "row")
        grad = res["tri"][3]
        if not (bool(torch.isfinite(grad).all()) and
                math.isfinite(res["tri"][0].item())):
            fail(f"mining N={n}: non-finite loss or gradient")
        print(f"[mining] N={n} d={MINING_D} bf16: loss {res['tri'][0].item():.6f} "
              f"equal through tri, row and auto (auto took "
              f"{'K3' if tri else 'K1'}); stats, winners' gradient "
              f"(max |grad| {float(grad.abs().max()):.3g}) and no-grad "
              f"stats bit-equal; {wall:.2f} s", flush=True)
        del emb, res, ng
        torch.cuda.empty_cache()
    launches = {k: LAUNCHES[k] for k in BATCH_HARD}
    expect_launches("mining", launches, want)
    return launches


def mining_times():
    """The mining-call time (PERF.md section 2) at MINING_NS x MINING_D in
    bf16, per ``algo``: one ``batch_hard_fused`` forward and backward, and
    one no-grad ``fused_batch_hard_stats``, per call with the host work
    included (CUDA events around 20 back-to-back calls, the lower of two
    runs in turns).  Runs after the mining path's launch counts are
    read."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import (
        batch_hard_fused, fused_batch_hard_stats)
    times = {}
    algos = ("tri", "row", "auto")
    for n in MINING_NS:
        emb, labels, _ = random_operands(n, MINING_D, "bf16", seed=n)
        row = {algo: {"fwd_bwd_ms": math.inf, "no_grad_ms": math.inf}
               for algo in algos}
        # in turns (tri, row, auto, auto, row, tri), the lower of the two
        for algo in algos + algos[::-1]:
            def fwd_bwd():
                e = emb.detach().requires_grad_(True)
                batch_hard_fused(e, labels, "soft", True, precision="bf16",
                                 algo=algo)[0].backward()

            def no_grad():
                with torch.no_grad():
                    fused_batch_hard_stats(emb, labels, None, "bf16", algo)
            for key, fn in (("fwd_bwd_ms", fwd_bwd), ("no_grad_ms", no_grad)):
                row[algo][key] = min(row[algo][key], call_ms(fn, iters=20))
        times[n] = row
        print(f"[mining] call_ms N={n} d={MINING_D} bf16 " + json.dumps(row),
              flush=True)
        del emb
        torch.cuda.empty_cache()
    return times


def sqdist_bound(n, m, d):
    """(bound_ms, bound_by, counts): the f32 inputs read once and the
    [N, M] output written once, against the products at the 3xTF32 rate
    plus the norms and 4 epilogue operations per output (the norm add, the
    fused -2x subtract, the clamp, the store's address) at the f32 rate."""
    nbytes = 4 * (n * d + m * d + n * m)
    products = 2.0 * n * m * d
    ops = products + 2.0 * (n + m) * d + 4.0 * n * m
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (products / PRODUCT_OPS_PER_S["f32"]
             + (ops - products) / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            {"bytes": nbytes, "flop": ops})


SQDIST_SHAPES = ((70, 50, 24), (1000, 777, 100), (8192, 8192, 128))
# checked beside them: ragged N and M at a depth TMA needs padded
SQDIST_CHECKS = ((777, 501, 90),) + SQDIST_SHAPES


def sqdist_operands(n, m, d, seed):
    """Unit-norm rows from a seed, on the card; b's first rows repeat a's,
    so the clamp at 0 is exercised on exact duplicates."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(n, d, generator=gen)
    b = torch.randn(m, d, generator=gen)
    dup = min(n, m) // 4
    b[:dup] = a[:dup]
    a = a / a.norm(dim=1, keepdim=True)
    b = b / b.norm(dim=1, keepdim=True)
    return a.cuda(), b.cuda(), dup


def sqdist_phase():
    """K7 against its plain version at SQDIST_CHECKS (within 1e-4: f32
    summation order and 3xTF32 products over unit-norm rows; never
    negative; duplicate rows at distance under 1e-5), timed at the largest
    with the library product; then the path: the public ``sqdist`` at
    every shape of SQDIST_SHAPES, counts set to 0 just before.  Returns
    (timing row, max_abs_err, launches)."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts, sqdist)
    from multimodal_similarity_tpu_torch.ops.kernels.distance import (
        sqdist_kernel, sqdist_plain)
    worst = 0.0
    for n, m, d in SQDIST_CHECKS:
        a, b, dup = sqdist_operands(n, m, d, seed=n + m + d)
        k = sqdist_kernel(a, b)
        p = sqdist_plain(a, b)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        diag = float(k.diagonal()[:dup].max())
        if tuple(k.shape) != (n, m) or not bool(torch.isfinite(k).all()):
            fail(f"sqdist {n}x{m}x{d}: shape {tuple(k.shape)} or non-finite")
        if not (err <= 1e-4 and bool((k >= 0).all()) and diag <= 1e-5):
            fail(f"sqdist {n}x{m}x{d}: max_abs_err {err} (tol 1e-4), min "
                 f"{float(k.min())}, duplicate-row distance {diag}")
        worst = max(worst, err)
        print(f"[sqdist] N={n} M={m} d={d}: max_abs_err={err:.3g} (tol "
              f"1e-4), min {float(k.min()):.3g}, {dup} duplicate rows at "
              f"most {diag:.3g} apart", flush=True)
        if (n, m, d) == SQDIST_SHAPES[-1]:
            lib = device_ms(lambda: torch.matmul(a, b.T))
            p_a = device_ms(lambda: sqdist_plain(a, b))
            k_a = device_ms(lambda: sqdist_kernel(a, b))
            k_b = device_ms(lambda: sqdist_kernel(a, b))
            p_b = device_ms(lambda: sqdist_plain(a, b))
            b_ms, b_by, counts = sqdist_bound(n, m, d)
            row = {"ms": min(k_a, k_b), "plain_ms": min(p_a, p_b),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                   "call_ms": call_ms(lambda: sqdist_kernel(a, b))}
            print(f"[timing] sqdist N={n} M={m} d={d} f32 "
                  + json.dumps(row) + " counts " + json.dumps(counts),
                  flush=True)
        del a, b, k, p
        torch.cuda.empty_cache()
    operands = [sqdist_operands(*shape, seed=sum(shape))[:2]
                for shape in SQDIST_SHAPES]
    reset_launch_counts()
    outs = [sqdist(a, b) for a, b in operands]
    torch.cuda.synchronize()
    launches = LAUNCHES["sqdist"]
    if launches != len(SQDIST_SHAPES) or any(
            tuple(o.shape) != (a.shape[0], b.shape[0])
            for o, (a, b) in zip(outs, operands)):
        fail(f"sqdist path: {launches} launches or wrong output shapes")
    print(f"[sqdist] path: the public sqdist at {len(SQDIST_SHAPES)} shapes, "
          f"{launches} K7 launches", flush=True)
    return row, worst, launches


def sfu_rate():
    """Exponentials per second: SFU_PER_SM_CLOCK x SMs x the maximum SM
    clock that nvidia-smi reports."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout
    mhz = float(out.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_SM_CLOCK * sms * mhz * 1e6, sms, mhz


def lifted_counts(ops):
    """(positive pairs, valid negative pairs) over the ordered pairs of
    this input: the entries whose exponential is not a constant."""
    valid = ops.valid > 0
    same = (ops.labels[:, None] == ops.labels[None, :]) & valid[None, :]
    n_pos = int(same.sum()) - int(valid.sum())
    n_neg = int(((~same) & valid[None, :]).sum())
    return n_pos, n_neg


def lifted_bound(kname, ops, precision, sfu):
    """(bound_ms, bound_by, counts): each input read once and each output
    written once at the HBM rate, against the products at the operand
    type's product rate plus the f32 epilogue at the f32 peak plus the
    exponentials and logs at the SFU rate."""
    n, d = ops.opd.shape
    esize = 2 if precision == "bf16" else 4
    n_pos, n_neg = lifted_counts(ops)
    side = 4 * 3 + 8          # sq, sq_pen, valid (f32), labels (int64)
    if kname == "lifted_fwd":
        nbytes = n * d * esize + n * side + 3 * n * 4
        products = 2.0 * n * n * d
        pairs = n * n
        exps = n_pos + n_neg + 2 * n          # + the two logs per row
    elif kname == "lifted_fwd_tri":
        nbytes = n * d * esize + n * (side - 4) + 3 * n * 4
        products = 1.0 * n * n * d            # the upper triangle
        pairs = n * (n + 1) / 2
        exps = (n_pos + n_neg) / 2 + 2 * n    # each pair once, + the logs
    else:  # lifted_bwd
        # + fp, cn, g_fp, g_cn in; the [N, d] f32 gradient out
        nbytes = n * d * esize + n * (side + 4 * 4) + n * d * 4
        products = 4.0 * n * n * d            # the tile, then C @ E
        pairs = n * n
        exps = 2 * (n_pos + n_neg)            # C_ij and C_ji
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (products / PRODUCT_OPS_PER_S[precision]
             + LIFTED_EPILOGUE_OPS[kname] * pairs / F32_OPS_PER_S
             + exps / sfu)
    counts = {"bytes": nbytes, "products_flop": products,
              "epilogue_ops": LIFTED_EPILOGUE_OPS[kname] * pairs,
              "exp_log": exps}
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", counts)


def lifted_calls(ops):
    """Each lifted kernel and its plain version as zero-argument calls on
    the same operands, the backward's fp, cn and cotangents fixed."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        lifted_bwd_kernel, lifted_bwd_plain, lifted_fwd_kernel,
        lifted_fwd_plain)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import (
        lifted_fwd_tri_kernel, lifted_fwd_tri_plain)
    n = ops.sq.shape[0]
    fp, cn, _ = lifted_fwd_plain(ops, MARGIN)
    gen = torch.Generator(device=ops.sq.device).manual_seed(n)
    g_fp = torch.rand(n, generator=gen, device=ops.sq.device) / n
    g_cn = torch.rand(n, generator=gen, device=ops.sq.device) / n
    return {
        "lifted_fwd": (lambda: lifted_fwd_kernel(ops, MARGIN),
                       lambda: lifted_fwd_plain(ops, MARGIN)),
        "lifted_fwd_tri": (lambda: lifted_fwd_tri_kernel(ops, MARGIN),
                           lambda: lifted_fwd_tri_plain(ops, MARGIN)),
        "lifted_bwd": (lambda: lifted_bwd_kernel(ops, fp, cn, g_fp, g_cn,
                                                 MARGIN),
                       lambda: lifted_bwd_plain(ops, fp, cn, g_fp, g_cn,
                                                MARGIN)),
    }


def check_lifted(name, emb, labels, valid, precision, bounded=True):
    """K4, K5 (after K4 and, when ``bounded``, after K6) and K6 (when
    ``bounded``: l2-normalised inputs) against their plain versions on the
    same card inputs.  Returns (operands, {kernel: max_abs_err})."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        lifted_bwd_kernel, lifted_bwd_plain, lifted_fwd_kernel,
        lifted_fwd_plain)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import (
        lifted_fwd_tri_kernel, lifted_fwd_tri_plain)
    ops = prep_operands(emb, labels, valid, precision)
    n, d = ops.opd.shape
    # f32 summation-order error of logsumexps of distances over N columns
    # (kernel and plain sum the same rounded bf16 operands alike); the
    # gradient's tolerance scales with its largest entry
    tol = 1e-4 * max(1.0, d / 128)
    errs = {}
    forwards = [("lifted_fwd", lifted_fwd_kernel, lifted_fwd_plain)]
    if bounded:
        forwards.append(("lifted_fwd_tri", lifted_fwd_tri_kernel,
                         lifted_fwd_tri_plain))
    gen = torch.Generator(device=emb.device).manual_seed(n + d)
    g_fp = torch.rand(n, generator=gen, device=emb.device) - 0.3
    g_cn = torch.rand(n, generator=gen, device=emb.device) - 0.3
    bwd_err = 0.0
    for kname, kernel, plain in forwards:
        fp_k, cn_k, nc_k = kernel(ops, MARGIN)
        fp_p, cn_p, nc_p = plain(ops, MARGIN)
        torch.cuda.synchronize()
        for t, what in ((fp_k, "fp"), (cn_k, "cn"), (nc_k, "nc")):
            if not bool(torch.isfinite(t).all()):
                fail(f"{name}: {kname} {what} not finite")
        if not torch.equal(nc_k, nc_p):
            fail(f"{name}: {kname} negative counts differ")
        # the row kernel's no-negative sentinel: cn = -1e30 exactly
        sentinel = cn_p <= -0.5e30
        if not torch.equal(sentinel, cn_k <= -0.5e30):
            fail(f"{name}: {kname} no-negative rows differ")
        if sentinel.any() and not bool((cn_k[sentinel] == -1e30).all()):
            fail(f"{name}: {kname} sentinel cn is not -1e30")
        err = max(float((fp_k - fp_p).abs().max()),
                  float((cn_k - cn_p)[~sentinel].abs().max())
                  if (~sentinel).any() else 0.0)
        if not err <= tol:
            fail(f"{name}: {kname} max_abs_err {err} > {tol}")
        errs[kname] = err
        # K5 after this forward, on its own fp and cn
        g_k = lifted_bwd_kernel(ops, fp_k, cn_k, g_fp, g_cn, MARGIN)
        g_p = lifted_bwd_plain(ops, fp_k, cn_k, g_fp, g_cn, MARGIN)
        torch.cuda.synchronize()
        gmax = float(g_p.abs().max())
        gerr = float((g_k - g_p).abs().max())
        gtol = tol * max(gmax, 1.0)
        if not (bool(torch.isfinite(g_k).all()) and gerr <= gtol):
            fail(f"{name}: lifted_bwd after {kname} max_abs_err {gerr} > "
                 f"{gtol}")
        bwd_err = max(bwd_err, gerr)
        print(f"[lifted] {name}: N={n} d={d} {precision} {kname} "
              f"max_abs_err={err:.3g} (tol {tol:.3g}), nc exact, "
              f"{int(sentinel.sum())} sentinel rows; lifted_bwd after it "
              f"max_abs_err={gerr:.3g} (tol {gtol:.3g}, max |grad| "
              f"{gmax:.3g})", flush=True)
    errs["lifted_bwd"] = bwd_err
    return ops, errs


def time_lifted(name, ops, precision, sfu,
                kernels=("lifted_fwd", "lifted_fwd_tri", "lifted_bwd")):
    """Kernel, plain (in turns: plain, kernel, kernel, plain), library and
    bound times of the named lifted kernels (K4, K6, K5) on these
    operands."""
    import torch
    n, d = ops.opd.shape
    opd = ops.opd
    coef = torch.rand(n, n, device=opd.device).to(opd.dtype)
    lib = {"fwd": device_ms(lambda: torch.matmul(opd, opd.T)),
           "bwd": device_ms(lambda: (torch.matmul(opd, opd.T),
                                     torch.matmul(coef, opd),
                                     torch.matmul(coef.T, opd)))}
    del coef
    rows = {}
    for kname, (kernel, plain) in lifted_calls(ops).items():
        if kname not in kernels:
            continue
        p_a = device_ms(plain)
        k_a = device_ms(kernel)
        k_b = device_ms(kernel)
        p_b = device_ms(plain)
        b_ms, b_by, counts = lifted_bound(kname, ops, precision, sfu)
        rows[kname] = {
            "ms": min(k_a, k_b), "plain_ms": min(p_a, p_b), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib["bwd" if kname == "lifted_bwd" else "fwd"],
            "call_ms": call_ms(kernel)}
        print(f"[timing] {name} {kname}: N={n} d={d} {precision} "
              + json.dumps(rows[kname]) + " counts " + json.dumps(counts),
              flush=True)
        torch.cuda.empty_cache()
    return rows


def check_lifted_gradient(gen, bounded):
    """The gradient of ``lifted_loss_fused`` (K6 or K4, then K5) against
    dense autograd of the port's dense ``lifted_loss``."""
    import torch
    from multimodal_similarity_tpu_torch.ops.distances import (
        pairwise_distance)
    from multimodal_similarity_tpu_torch.ops.kernels import lifted_loss_fused
    from multimodal_similarity_tpu_torch.ops.losses import lifted_loss
    emb, labels, _ = make_case(512, 128, "float", gen)
    e1 = emb.clone().requires_grad_(True)
    loss_k = lifted_loss_fused(e1, labels, MARGIN, True, precision="f32",
                               bounded=bounded)[0]
    loss_k.backward()
    e2 = emb.clone().requires_grad_(True)
    loss_d = lifted_loss(pairwise_distance(e2, e2), labels, MARGIN, True)[0]
    loss_d.backward()
    torch.cuda.synchronize()
    gmax = float(e2.grad.abs().max())
    err = float((e1.grad - e2.grad).abs().max())
    # f32 sum-order differences: the JAX package's kernel-test tolerance
    tol = 1e-3 * gmax + 1e-7
    lerr = abs(loss_k.item() - loss_d.item())
    print(f"[lifted] gradient through lifted_loss_fused (bounded="
          f"{bounded}: {'K6' if bounded else 'K4'} + K5) vs dense autograd: "
          f"loss {loss_k.item():.6f} vs {loss_d.item():.6f}, max_abs_err "
          f"{err:.3g} (tol {tol:.3g})", flush=True)
    if not (lerr <= 1e-4 * max(1.0, abs(loss_d.item())) and err <= tol):
        fail(f"lifted gradient (bounded={bounded}) disagrees with dense "
             "autograd")


def pass_times(call, keys, calls=20):
    """Device time per call of each kernel whose name contains one of
    ``keys``, from a torch.profiler trace of ``calls`` calls, or None when
    the trace has no device time for one of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.key_averages():
        for key in keys:
            if key in evt.key:
                us = max(getattr(evt, attr, 0) or 0 for attr in (
                    "self_device_time_total", "self_cuda_time_total",
                    "device_time_total", "cuda_time_total"))
                per[key] = per.get(key, 0.0) + us / calls / 1e3
    if len(per) == len(keys) and all(v > 0 for v in per.values()):
        return per
    return None


def k6_combine_cost(ops):
    """f32 K6's two launches apart (the tile walk, which splits its operand
    itself, and the ascending-order combine of its partials)."""
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        sm_count as device_sms)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import (
        lifted_fwd_tri_kernel, tri_cols)
    keys = ("lifted_tri_tc", "lifted_tri_combine")
    per = pass_times(lambda: lifted_fwd_tri_kernel(ops, MARGIN), keys)
    n, d = ops.opd.shape
    cols = tri_cols(n, device_sms(ops.opd.device))
    if per:
        print(f"[lifted] K6 f32 at N={n} d={d} (64 x {cols} work items): "
              f"tile walk {per[keys[0]]:.5f} ms, combine {per[keys[1]]:.5f} "
              f"ms, both {per[keys[0]] + per[keys[1]]:.5f} ms per call "
              "(torch.profiler device time)", flush=True)
    else:
        print(f"[lifted] K6 f32 at N={n} d={d}: launches not timed apart (no "
              "device time in the profiler trace)", flush=True)


def k4_combine_cost(ops):
    """f32 K4's two launches apart (the 3xTF32 tile walk and the
    ascending-order combine of its column ranges)."""
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        sm_count as device_sms)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        fwd_split, lifted_fwd_kernel)
    keys = ("lifted_fwd_tc", "lifted_fwd_combine")
    per = pass_times(lambda: lifted_fwd_kernel(ops, MARGIN), keys)
    n, d = ops.opd.shape
    split = fwd_split(n, device_sms(ops.opd.device))
    if per:
        print(f"[lifted] K4 f32 at N={n} d={d} ({split} column ranges): "
              f"tile walk {per[keys[0]]:.5f} ms, combine "
              f"{per[keys[1]]:.5f} ms, both {per[keys[0]] + per[keys[1]]:.5f}"
              " ms per call (torch.profiler device time)", flush=True)
    else:
        print(f"[lifted] K4 f32 at N={n} d={d}: launches not timed apart (no "
              "device time in the profiler trace)", flush=True)


def k5_launch_cost(ops):
    """f32 K5's launches apart: the 3xTF32 tile walk and, where it has
    more than one column range, the ascending-order combine."""
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        sm_count as device_sms)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import bwd_grid
    n, d = ops.opd.shape
    ranges, chunks = bwd_grid(n, d, device_sms(ops.opd.device))
    keys = ("lifted_bwd_tc",) + (("lifted_bwd_combine",) if ranges > 1
                                 else ())
    per = pass_times(lifted_calls(ops)["lifted_bwd"][0], keys)
    if per:
        print(f"[lifted] K5 f32 at N={n} d={d} ({ranges} column ranges, "
              f"{chunks} chunks): "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in per.items())
              + f", all {sum(per.values()):.5f} ms per call (torch.profiler "
              "device time)", flush=True)
    else:
        print(f"[lifted] K5 f32 at N={n} d={d}: launches not timed apart (no "
              "device time in the profiler trace)", flush=True)


def deterministic(ops, kname, tag):
    """Two calls of a lifted kernel on the same inputs give the same bits
    (no float atomics: each partial written once, added in a fixed
    order)."""
    import torch
    call = lifted_calls(ops)[kname][0]
    first, second = call(), call()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    torch.cuda.synchronize()
    n, d = ops.opd.shape
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            fail(f"{tag} at N={n} d={d}: two calls differ in "
                 f"{int((a != b).sum())} entries")
    print(f"[lifted] {tag} {ops.opd.dtype} at N={n} d={d}: two calls "
          "bit-identical", flush=True)


def k3_combine_cost(ops):
    """K3's two launches apart (the tile walk and the ascending-order
    combine), with winners."""
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri import (
        tri_stats_kernel)
    keys = ("batch_hard_tri_tc", "batch_hard_tri_combine")
    per = pass_times(lambda: tri_stats_kernel(ops, True), keys)
    n, d = ops.opd.shape
    if per:
        print(f"[timing] K3 idx at N={n} d={d}: tile walk "
              f"{per[keys[0]]:.5f} ms, combine {per[keys[1]]:.5f} ms per "
              "call (torch.profiler device time)", flush=True)
    else:
        print(f"[timing] K3 idx at N={n} d={d}: combine cost not measured "
              "(no device time in the profiler trace)", flush=True)


def no_negative_case(n, d, gen):
    """Two classes, the second all invalid: every first-class row has no
    valid negative.  Labels offset by 2^40."""
    import torch
    emb = torch.randn(n, d, generator=gen)
    emb = emb / emb.norm(dim=1, keepdim=True)
    labels = (torch.arange(n) >= n // 3).long() + 2 ** 40
    valid = (labels == 2 ** 40).float()
    return emb.cuda(), labels.cuda(), valid.cuda()


def lifted_kernel_phase(sfu):
    """K4, K5 and K6 against their plain versions.  Returns the timing
    rows and errors at the trainer's shape (N=512, d=128, f32) and the
    timing rows at N=8192."""
    import torch
    gen = torch.Generator().manual_seed(1)
    for precision in ("f32", "bf16"):
        ops, errs = check_lifted(f"slice-{precision}",
                                 *make_case(512, 128, "float", gen),
                                 precision)
        if precision == "f32":  # the trainer's shape and precision
            main_rows = time_lifted("slice-f32", ops, "f32", sfu)
            main_errs = errs
            k6_combine_cost(ops)
            k4_combine_cost(ops)
            k5_launch_cost(ops)
            deterministic(ops, "lifted_bwd", "K5")
            deterministic(ops, "lifted_fwd_tri", "K6")
    emb, labels, valid = make_case(512, 128, "float", gen)
    check_lifted("unnormalised-x3", emb * 3.0, labels, valid, "f32",
                 bounded=False)
    # N=1000: not a multiple of K4's 64-row blocks and 64-column tiles
    check_lifted("ragged-valid-int64", *make_case(
        1000, 72, "float", gen, invalid_frac=0.1, label_offset=2 ** 40),
        "f32")
    # f32 K4 at a depth TMA needs padded (90 -> 92), unnormalised, with
    # invalid rows
    emb, labels, valid = make_case(777, 90, "float", gen, invalid_frac=0.2,
                                   label_offset=2 ** 36)
    check_lifted("ragged-d90-unnormalised", emb * 3.0, labels, valid, "f32",
                 bounded=False)
    # f32 K6 at the same padded depth on unit rows, ragged N, a valid mask
    check_lifted("ragged-d90-unit", emb, labels, valid, "f32")
    # exact in TF32 and f32: the distances carry no error, only the
    # exponentials do
    check_lifted("exact-tf32", *make_case(512, 128, "tf32", gen,
                                          invalid_frac=0.1), "f32",
                 bounded=False)
    check_lifted("ragged-valid-int64-bf16", *make_case(
        777, 100, "float", gen, invalid_frac=0.2, label_offset=2 ** 33),
        "bf16")
    check_lifted("no-valid-negative", *no_negative_case(300, 100, gen),
                 "f32")
    ops, _ = check_lifted("large-d128", *make_case(
        8192, 128, "float", gen, n_classes=64), "f32")
    large_rows = time_lifted("large-d128", ops, "f32", sfu)
    k6_combine_cost(ops)
    k4_combine_cost(ops)
    k5_launch_cost(ops)
    deterministic(ops, "lifted_bwd", "K5")
    deterministic(ops, "lifted_fwd_tri", "K6")
    del ops
    torch.cuda.empty_cache()
    ops, _ = check_lifted("large-n16384", *make_case(
        16384, 128, "float", gen, n_classes=64), "f32")
    time_lifted("large-n16384", ops, "f32", sfu)
    k6_combine_cost(ops)
    k4_combine_cost(ops)
    k5_launch_cost(ops)
    del ops
    torch.cuda.empty_cache()
    # K5 over 12 and 16 chunks of 128 gradient columns, after K4 (and K6
    # at d=1536: the f32 K6 over 48 k-slices)
    for d in (1536, 2048):
        ops, _ = check_lifted(f"deep-d{d}", *make_case(
            1000, d, "float", gen, invalid_frac=0.1), "f32",
            bounded=d == 1536)
        time_lifted(f"deep-d{d}", ops, "f32", sfu, kernels=("lifted_bwd",))
        k5_launch_cost(ops)
    for bounded in (True, False):
        check_lifted_gradient(gen, bounded)
    return main_rows, main_errs, large_rows


def write_synthetic(root):
    from multimodal_similarity_tpu_torch.data import generate_synthetic_honda
    t0 = time.time()
    generate_synthetic_honda(root, n_sessions=10, frames_per_session=240,
                             modal_dims={"resnet": (8, 8, 1536)}, seed=0)
    print(f"[trainer] synthetic Honda dir (10 sessions x 240 frames of "
          f"8x8x1536) written in {time.time() - t0:.1f} s", flush=True)


def full_width_cfg(root, name, **kw):
    """The configuration of scripts/train_base_model.sh:5-11: ConvRTSN on
    8x8x1536 resnet maps, 3 TSN segments, n_C=20, emb_dim=128, balanced
    batch 512, event budget 1000, 3 sessions per batch, Adam, lr 1e-2,
    keep_prob 0.5, alpha 0.2; 2 epochs unless ``kw`` says otherwise."""
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    args = dict(
        DATA_ROOT=root, name=name, feat="resnet", network="convrtsn",
        n_input=1536, n_h=8, n_w=8, n_C=20, emb_dim=128, num_seg=3,
        batch_size=512, event_per_batch=1000, sess_per_batch=3,
        label_num=93, max_epochs=2, static_epochs=1000, learning_rate=1e-2,
        keep_prob=0.5, optimizer="ADAM", alpha=0.2, lambda_l2=0.0,
        log_flush_every=1)
    args.update(kw)
    return TrainConfig(**args).resolve()


def drive_trainer(root, tag, train_fn, cfg):
    """One trainer run, every launch count set to 0 just before it and read
    just after; finite losses, and the device retrieval metrics of the
    trained model against the NumPy oracle.  Returns (result, launches,
    validations, experiment, validation embeddings, labels)."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.eval.metrics import (
        evaluate_simple, retrieval_metrics)
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    from multimodal_similarity_tpu_torch.train.steps import (
        embed_in_chunks, make_embed_fn)
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)

    reset_launch_counts()
    t0 = time.time()
    res = train_fn(cfg, result_dir=os.path.join(root, f"result_{tag}"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)

    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    vals = [r for r in recs if "val_mAP" in r]
    # with a readback every step, consecutive records are a step apart
    gaps = [b["time"] - a["time"] for a, b in zip(steps, steps[1:])]
    for r, gap in zip(steps, [None] + gaps):
        print(f"[{tag}] step {r['step']} loss {r['loss']:.6f} active "
              f"{r['active_count']:.3f} step_time_s "
              f"{'first' if gap is None else f'{gap:.4f}'}", flush=True)
    for r in vals:
        print(f"[{tag}] step {r['step']} val_mAP {r['val_mAP']:.6f} "
              f"val_loss {r['val_loss']:.6f}", flush=True)
    print(f"[{tag}] {res.step} steps, {len(vals)} validations in "
          f"{wall:.1f} s; launches {json.dumps(launches)}", flush=True)
    if res.step < cfg.max_epochs or not steps:
        fail(f"{tag}: trainer took {res.step} steps")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"{tag}: non-finite training loss")
    if len(vals) != cfg.max_epochs or \
            not all(math.isfinite(r["val_mAP"]) and math.isfinite(
                r["val_loss"]) for r in vals):
        fail(f"{tag}: {len(vals)} validations, or a non-finite val mAP or "
             "loss")

    # outputs: the device retrieval metrics against the NumPy oracle on the
    # trained model's validation embeddings
    exp = HondaExperiment(cfg, result_dir=os.path.join(root, f"check_{tag}"))
    exp.close()
    emb = embed_in_chunks(make_embed_fn(res.model, cfg.normalized),
                          exp.val_feats, torch.device("cuda"))
    if tuple(emb.shape) != (exp.val_feats.shape[0], cfg.emb_dim) or \
            not bool(torch.isfinite(emb).all()):
        fail(f"{tag}: validation embeddings {tuple(emb.shape)} not finite "
             "or of the wrong shape")
    labels = exp.val_labels.reshape(-1)
    dev = retrieval_metrics(emb, labels)
    ref = evaluate_simple(emb.cpu().numpy(), labels)
    print(f"[{tag}] val metrics device (mAP, mPrec, R@1) "
          f"{dev[0]:.6f} {dev[1]:.6f} {dev[2][1]:.6f} vs NumPy oracle "
          f"{ref[0]:.6f} {ref[1]:.6f} {ref[2]:.6f}", flush=True)
    if not np.allclose([dev[0], dev[1], dev[2][1]], list(ref), atol=2e-3):
        fail(f"{tag}: device retrieval metrics disagree with the NumPy "
             "oracle")
    if abs(dev[0] - vals[-1]["val_mAP"]) > 1e-6:
        fail(f"{tag}: val mAP of the trained model differs from the "
             "trainer's")
    return res, launches, len(vals), exp, emb, torch.from_numpy(
        labels.astype(np.int64)).cuda()


def expect_launches(tag, launches, want):
    for name, count in want.items():
        if launches[name] != count:
            fail(f"{tag}: {name} launches {launches[name]} != {count}")
    print(f"[{tag}] launch counts as expected: {json.dumps(want)}",
          flush=True)


def trainer_phase(root):
    """The batch-hard trainer, then the lifted trainer normalised and not;
    returns each kernel's launches from the run whose path takes it."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import use_triangular
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard, base_model_lifted)

    write_synthetic(root)
    cfg = full_width_cfg(root, "smoke_convrtsn")
    res, bh, n_val, exp, emb, labels = drive_trainer(
        root, "trainer", base_model_batchhard.train, cfg)
    # the loss takes algo="auto": each call's kernel follows the gate at
    # its shape (a step's batch, then the whole validation set)
    want = dict.fromkeys(BATCH_HARD, 0)
    tri_step = use_triangular(cfg.batch_size, cfg.emb_dim, sm_count())
    tri_val = use_triangular(emb.shape[0], cfg.emb_dim, sm_count())
    want["batch_hard_tri_idx" if tri_step else "batch_hard_stats_idx"] += \
        res.step
    want["batch_hard_tri" if tri_val else "batch_hard_stats"] += n_val
    expect_launches("trainer", bh, {
        **want, "lifted_fwd": 0, "lifted_bwd": 0, "lifted_fwd_tri": 0,
        "sqdist": 0})
    # K1/K2 at the validation shape the main path gave K2, on its inputs
    check_inputs("validation-shape", emb, labels,
                 torch.ones(emb.shape[0]).cuda(), "bf16")
    step_breakdown("trainer", exp, res, cfg, "batchhard")

    cfg = full_width_cfg(root, "smoke_lifted")
    res, lt, n_val, exp, emb, labels = drive_trainer(
        root, "lifted", base_model_lifted.train, cfg)
    expect_launches("lifted", lt, {
        "lifted_fwd_tri": res.step + n_val, "lifted_bwd": res.step,
        "lifted_fwd": 0, "sqdist": 0, **dict.fromkeys(BATCH_HARD, 0)})
    # K4/K5/K6 at the validation shape the main path gave K6, on its inputs
    check_lifted("validation-shape", emb, labels,
                 torch.ones(emb.shape[0]).cuda(), "f32")
    step_breakdown("lifted", exp, res, cfg, "lifted")

    cfg = full_width_cfg(root, "smoke_lifted_raw", normalized=False,
                         max_epochs=1)
    res, raw, n_val, _, emb, labels = drive_trainer(
        root, "lifted-no-normalized", base_model_lifted.train, cfg)
    expect_launches("lifted-no-normalized", raw, {
        "lifted_fwd": res.step + n_val, "lifted_bwd": res.step,
        "lifted_fwd_tri": 0})
    check_lifted("validation-shape-unnormalised", emb, labels,
                 torch.ones(emb.shape[0]).cuda(), "f32", bounded=False)
    return {**{k: bh[k] for k in BATCH_HARD},
            "lifted_fwd_tri": lt["lifted_fwd_tri"],
            "lifted_bwd": lt["lifted_bwd"],
            "lifted_fwd": raw["lifted_fwd"]}


def step_breakdown(tag, exp, res, cfg, loss_kind):
    """Where one full-width step's time goes, each part timed alone on the
    host clock: loading a session batch, the balanced selection and gather,
    the upload, and the device step (forward, loss kernels, backward,
    Adam), each ending in a synchronise."""
    import random

    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.ops.mining import (
        select_batch_balanced)
    from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
        import make_balanced_batch_step

    t0 = time.perf_counter()
    batches = exp.loader.epoch(max_batches=1)
    batch = next(batches)
    batches.close()
    t1 = time.perf_counter()
    idx = select_batch_balanced(batch["labels"][:batch["num_events"]],
                                cfg.batch_size, rng=random.Random(0))
    events = batch["events"][idx]
    labels = batch["labels"][idx].astype(np.int64)
    t2 = time.perf_counter()
    ev = torch.from_numpy(events).cuda()
    lab = torch.from_numpy(labels).cuda()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    step = make_balanced_batch_step(res.model, res.optimizer, cfg, loss_kind)
    step(ev, lab, cfg.learning_rate)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    for _ in range(3):
        step(ev, lab, cfg.learning_rate)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    parts = {"load_batch_s": t1 - t0, "select_gather_s": t2 - t1,
             "upload_s": t3 - t2, "device_step_s": (t5 - t4) / 3,
             "upload_bytes": int(events.nbytes)}
    print(f"[{tag}] step breakdown {json.dumps(parts)}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "multimodal_similarity_tpu_torch")):
        print("chip_smoke: the multimodal_similarity_tpu_torch package is "
              "not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # full-f32 products and convolutions in the references: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    from multimodal_similarity_tpu_torch.ops.kernels._build import build
    t0 = time.time()
    logs = build()
    print(f"[build] {len(logs)} CUDA source(s) built in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"[build] {name}: {line.strip()}")

    # K2 and K3 are held bit-equal to K1, so all carry K1's error
    main_rows, main_err = kernel_phase()
    gate_grid()
    gate_corner_times()
    mining = mining_path()
    mining_times()
    sq_row, sq_err, sq_launches = sqdist_phase()
    sfu, sms, mhz = sfu_rate()
    print(f"[lifted] SFU rate {sfu:.4g} exp/s ({SFU_PER_SM_CLOCK} per SM "
          f"per clock x {sms} SMs x {mhz:.0f} MHz max SM clock)", flush=True)
    lifted_rows, lifted_errs, _ = lifted_kernel_phase(sfu)
    main_rows.update(lifted_rows, sqdist=sq_row)
    errs = {**dict.fromkeys(BATCH_HARD, main_err), **lifted_errs,
            "sqdist": sq_err}

    scratch = os.path.join(HERE, "_build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        launches = trainer_phase(root)
    # a batch-hard kernel the trainer's gate did not take is counted on the
    # mining path, which runs every one of them
    for name in BATCH_HARD:
        path = "trainer" if launches[name] else "mining"
        launches[name] = launches[name] or mining[name]
        print(f"[launches] {name}: {launches[name]} on the {path} path",
              flush=True)
    launches["sqdist"] = sq_launches

    kernels = []
    for name in REPLACES:
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], **main_rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
