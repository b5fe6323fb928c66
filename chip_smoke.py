#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_similarity_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no error is caught):
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every CUDA kernel from ``multimodal_similarity_tpu_torch/csrc``;
3. kernels: K1 (``batch_hard_stats_idx``) and K2 (``batch_hard_stats``)
   against their plain PyTorch version on the card, at the trainer's shape
   (N=512, d=128) in bf16 and f32, on exact small-integer inputs (values and
   winner columns bit-equal, the lowest-column tie rule exercised), at
   ragged N and d with a valid mask and 64-bit labels on both CTA sizes, at
   N=8192 with d=128 and d=1024, and at the validation shape on the
   trained model's embeddings; the gradient through the autograd wrapper
   against a dense autograd oracle; kernel, plain, library
   (``torch.matmul``) and bound times;
4. trainer: the port's batch-hard trainer, ConvRTSN at full width (3 TSN
   segments of 8x8x1536 resnet maps, n_C=20, emb_dim=128, class-balanced
   batch 512, event budget 1000, 3 sessions per batch, Adam eps=0.1) on a
   synthetic Honda directory with random weights, 2 epochs; asserts finite
   losses, one K1 launch per optimizer step and a K2 launch per validation,
   and the device retrieval metrics against the NumPy oracle.
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
SOURCE = "multimodal_similarity_tpu_torch/csrc/batch_hard.cu"
REPLACES = {
    "batch_hard_stats_idx":
        "multimodal_similarity_tpu/ops/pallas/batch_hard.py:110",
    "batch_hard_stats":
        "multimodal_similarity_tpu/ops/pallas/batch_hard.py:151",
}
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# f32 epilogue operations per (row, column) pair: norm add, -2x fused
# subtract, clamp, the positive and negative selects, the max and min
# compares and the negative-count add
EPILOGUE_OPS = 8


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


def bound(n, d, precision, with_idx):
    """(bound_ms, bound_by): each input read once, each output written
    once; the products at the operand type's peak and the epilogue at the
    f32 peak."""
    esize = 2 if precision == "bf16" else 4
    # operand, sq, sq_pen, valid (f32), labels (int64); fp, cn, nc (+ idx)
    nbytes = n * d * esize + n * (4 * 3 + 8) + n * 4 * (5 if with_idx else 3)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2.0 * n * n * d / PEAK_OPS_PER_S[precision]
             + EPILOGUE_OPS * n * n / PEAK_OPS_PER_S["f32"])
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_case(n, d, kind, gen, n_classes=7, invalid_frac=0.0,
              label_offset=0):
    import torch
    labels = torch.randint(0, n_classes, (n,), generator=gen)
    if kind == "int":
        # small integers: every product and sum is exact in f32 and bf16,
        # so any summation order gives bit-equal distances and ties
        emb = torch.randint(-3, 4, (n, d), generator=gen).float()
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
    """K1 and K2 against the plain version on the same card inputs; returns
    (operands, max_abs_err)."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands, stats_kernel, stats_plain)
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
    print(f"[kernels] {name}: N={n} d={d} {precision} "
          f"{'exact' if exact else 'float'} "
          f"max_abs_err={err:.3g} (tol {tol:.3g}) nc exact, "
          f"winner mismatches {mism} (near-ties)", flush=True)
    return ops, err


def time_case(name, ops, precision):
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        stats_kernel, stats_plain)
    n, d = ops.opd.shape
    lib_ms = device_ms(lambda: torch.matmul(ops.opd, ops.opd.T))
    rows = {}
    for kname, with_idx in (("batch_hard_stats_idx", True),
                            ("batch_hard_stats", False)):
        # in turns: plain, kernel, kernel, plain
        p_a = device_ms(lambda: stats_plain(ops, with_idx))
        k_a = device_ms(lambda: stats_kernel(ops, with_idx))
        k_b = device_ms(lambda: stats_kernel(ops, with_idx))
        p_b = device_ms(lambda: stats_plain(ops, with_idx))
        b_ms, b_by = bound(n, d, precision, with_idx)
        rows[kname] = {"ms": min(k_a, k_b), "plain_ms": min(p_a, p_b),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib_ms,
                       "call_ms": call_ms(lambda: stats_kernel(ops,
                                                               with_idx))}
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
    # ragged rows, columns and depth on the 32-row CTAs (N/32 >= the SMs)
    check_case("ragged-valid-exact-wide", 4500, 100, "bf16", "int", gen,
               invalid_frac=0.2, label_offset=2 ** 33)
    for d in (128, 1024):
        ops, _ = check_case(f"large-d{d}", 8192, d, "bf16", "float", gen,
                            n_classes=64)
        time_case(f"large-d{d}", ops, "bf16")
    check_gradient(gen)
    return main, main_err


def write_synthetic(root):
    from multimodal_similarity_tpu_torch.data import generate_synthetic_honda
    t0 = time.time()
    generate_synthetic_honda(root, n_sessions=10, frames_per_session=240,
                             modal_dims={"resnet": (8, 8, 1536)}, seed=0)
    print(f"[trainer] synthetic Honda dir (10 sessions x 240 frames of "
          f"8x8x1536) written in {time.time() - t0:.1f} s", flush=True)


def trainer_phase(root):
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    from multimodal_similarity_tpu_torch.eval.metrics import (
        evaluate_simple, retrieval_metrics)
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    from multimodal_similarity_tpu_torch.train.steps import (
        embed_in_chunks, make_embed_fn)
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)

    write_synthetic(root)
    cfg = TrainConfig(
        DATA_ROOT=root, name="smoke_convrtsn", feat="resnet",
        network="convrtsn", n_input=1536, n_h=8, n_w=8, n_C=20,
        emb_dim=128, num_seg=3, batch_size=512, event_per_batch=1000,
        sess_per_batch=3, label_num=93, max_epochs=2, static_epochs=1000,
        learning_rate=1e-2, keep_prob=0.5, optimizer="ADAM", alpha=0.2,
        lambda_l2=0.0, log_flush_every=1).resolve()
    reset_launch_counts()
    t0 = time.time()
    res = base_model_batchhard.train(cfg, result_dir=os.path.join(
        root, "result"))
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
        print(f"[trainer] step {r['step']} loss {r['loss']:.6f} active "
              f"{r['active_count']:.3f} step_time_s "
              f"{'first' if gap is None else f'{gap:.4f}'}", flush=True)
    for r in vals:
        print(f"[trainer] step {r['step']} val_mAP {r['val_mAP']:.6f} "
              f"val_loss {r['val_loss']:.6f}", flush=True)
    print(f"[trainer] {res.step} steps, {len(vals)} validations in "
          f"{wall:.1f} s; launches {json.dumps(launches)}", flush=True)
    if res.step < 2 or not steps:
        fail(f"trainer took {res.step} steps")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail("non-finite training loss")
    if launches["batch_hard_stats_idx"] != res.step:
        fail(f"K1 launches {launches['batch_hard_stats_idx']} != "
             f"optimizer steps {res.step}")
    if launches["batch_hard_stats"] != len(vals) or not vals:
        fail(f"K2 launches {launches['batch_hard_stats']} != "
             f"validations {len(vals)}")
    if not all(math.isfinite(r["val_mAP"]) for r in vals):
        fail("non-finite val mAP")

    # outputs: the device retrieval metrics against the NumPy oracle on the
    # trained model's validation embeddings
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    exp = HondaExperiment(cfg, result_dir=os.path.join(root, "check"))
    exp.close()
    emb = embed_in_chunks(make_embed_fn(res.model, cfg.normalized),
                          exp.val_feats, torch.device("cuda"))
    if tuple(emb.shape) != (exp.val_feats.shape[0], cfg.emb_dim) or \
            not bool(torch.isfinite(emb).all()):
        fail(f"validation embeddings {tuple(emb.shape)} not finite or of "
             "the wrong shape")
    labels = exp.val_labels.reshape(-1)
    # K1/K2 at the validation shape the main path gave K2, on its inputs
    check_inputs("validation-shape", emb, torch.from_numpy(
        labels.astype(np.int64)).cuda(), torch.ones(emb.shape[0]).cuda(),
        "bf16")
    dev = retrieval_metrics(emb, labels)
    ref = evaluate_simple(emb.cpu().numpy(), labels)
    print(f"[trainer] val metrics device (mAP, mPrec, R@1) "
          f"{dev[0]:.6f} {dev[1]:.6f} {dev[2][1]:.6f} vs NumPy oracle "
          f"{ref[0]:.6f} {ref[1]:.6f} {ref[2]:.6f}", flush=True)
    if not np.allclose([dev[0], dev[1], dev[2][1]], list(ref), atol=2e-3):
        fail("device retrieval metrics disagree with the NumPy oracle")
    if abs(dev[0] - vals[-1]["val_mAP"]) > 1e-6:
        fail("val mAP of the trained model differs from the trainer's")
    step_breakdown(exp, res, cfg)
    return launches


def step_breakdown(exp, res, cfg):
    """Where one full-width step's time goes, each part timed alone on the
    host clock: loading a session batch, the balanced selection and gather,
    the upload, and the device step (forward, stats kernel, backward,
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
    step = make_balanced_batch_step(res.model, res.optimizer, cfg, "soft")
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
    print(f"[trainer] step breakdown {json.dumps(parts)}", flush=True)


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
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # K2 is held bit-equal to K1, so both carry K1's error
    main_rows, main_err = kernel_phase()

    scratch = os.path.join(HERE, "_build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        launches = trainer_phase(root)

    kernels = []
    for name in ("batch_hard_stats_idx", "batch_hard_stats"):
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": main_err, **main_rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
