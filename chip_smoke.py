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
   with the same metric checks, and a step breakdown of each trainer
   ending in its steady state (20 consecutive loader draws through the
   trainer's own feed source, on a second, 40-session directory);
10. the device feed: pinned-ring uploads of f32, bf16 and int8 batches
   against the host rows over more batches than the ring holds, a shape
   change and a failed copy raising in the consumer; then the fused
   semi-hard step at bench.py's shape (1024 events, ConvRTSN emb_dim 256,
   100 triplets) in events per second per feature type (run before 8);
11. the semi-hard triplet trainer (``base_model``) at the width of
   scripts/train_base_model.sh on the same directory: 2 epochs with the
   fused device miner in f32, 1 epoch each with --bf16_features,
   --int8_features and ``--triplet_select facenet_host``; finite losses,
   the metric checks, no launch of any ``csrc/`` kernel, the f32 run's
   step breakdown, and each run's steady state;
12. the CUB track at the scripts' widths on synthetic data from seed
   12345: ``base_model_CUB`` and ``pddm_CUB`` (100 steps each on 1024-d
   features and 312-d attributes, 100 classes x 59 images a split),
   ``base_CUB --network inception_v2`` on 224 crops of 256 x 256 images
   (20 steps with the semi-hard triplet loss, then 10 with ``--loss
   batchhard``: one K1 launch a step and no other kernel), and
   ``debug_CUB`` (2 steps); finite losses, the metrics against the NumPy
   oracle, InceptionV2 and the triplet, n-pairs and cluster losses on the
   card against the CPU, K1 at the path's shape (N=32, d=64, bf16) against
   its plain version with its times, and the steady step of
   ``base_model_CUB`` and of each ``base_CUB`` loss beside its device time
   (profiler and CUDA events) and idle share (the semi-hard miner ranks
   labels on the device since the F3 fix, so ``base_model_CUB``'s step
   has no readback inside; scripts/f3_probe.py times it and the fused step
   against another tree in turns);
13. the single-modality pair trainers at the scripts' widths, 1 epoch
   each with random weights: ``pddm_model`` on sensors (8,) and on segment
   (357,) (scripts/train_pddm.sh: RTSN, emb_dim 32, 200 triplets, budget
   1000, 3 sessions a batch, mining on the all-pairs PDDM matrix),
   ``multitask_model`` at ConvRTSN full width (emb_dim 128, lambda_ver
   0.1, keep_prob 0.5) and ``pairsim_model`` on sensors (emb_dim 128,
   batch 128, one negative, hard passes from epoch 0); finite losses, no
   launch of any ``csrc/`` kernel on any of the four runs, the metrics
   against the NumPy oracle, the PDDM similarity matrix of the validation
   set and PairSim's validation pair probabilities on the card against the
   CPU (PAIR_PROB_TOL), val_mAP_PDDM and val_acc recomputed from the CPU's
   (PAIR_METRIC_TOL), Adam's step count against the steps plus the hard
   passes, and the steady step of ``pddm_model`` and ``multitask_model``
   (``steady_step``, with the feed wait and the time in steps);
14. the multimodal flagship at the width of
   scripts/train_multimodal_model.sh (ConvRTSN on 8x8x1536 resnet maps,
   emb_dim 128, sensors (8,) and segment (357,) branches restored from
   phase 13's ``pddm_model`` checkpoints, budget 1000, 3 sessions a batch,
   200 triplets, 5 negatives, --label_num 9, lambda_multimodal 0.1,
   keep_prob 0.5, --no_joint), random core weights, 1 epoch each:
   ``multimodal_model`` on the host miners, with --device_mining in f32
   and with --int8_features, ``multimodal_model_hardonly``, and
   ``multimodal_model_weak --multimodal_select confidence``, then the host
   path and --device_mining again with the branches' PDDM output layers
   scaled and shifted (PDDM_SCALE, PDDM_SHIFT) so that the structure term
   fires, on the trainers' directory with sensors and segment features
   written beside its resnet maps; finite losses, hard triplets on every
   flagship path and structure triplets on the scaled runs, no launch of
   any ``csrc/`` kernel, the metrics against the NumPy oracle, the fused
   PDDM similarity of a batch on the card against the CPU (PAIR_PROB_TOL),
   the structure miner on the card against the CPU on the same similarity
   and Gumbel draws (index-equal), and the steady step of the host path
   and of --device_mining on a directory whose batches fill the 1000-event
   budget with real events (``write_full_budget``, kept for phase 15);
15. slice 6a at the scripts' widths on phase 14's three-modality
   directory, 1 epoch each with random weights: ``multitask_dcca`` and
   ``multitask_cross_prediction`` (ConvRTSN emb_dim 128, sensors and
   segment RTSN towers of emb_dim 32 restored from phase 13's checkpoints
   and frozen, 200 triplets, --label_num 9, lambda_multimodal 0.1),
   ``modality_hallucination`` and ``modality_hallucination_weak``
   (--label_num 93), ``cross_prediction`` (resnet -> mean-pooled sensors)
   and ``base_model_classifier`` (ConvTSN, emb_dim 256, 7 outputs);
   finite losses, the DCCA term in [-64, 0), the MSE and hallucination
   terms positive, the frozen towers unchanged and the core moved, no
   launch of any ``csrc/`` kernel, val mAP and val accuracy against the
   NumPy oracle, ``dcca_loss`` card vs CPU on the trained core's
   unsupervised embeddings of a full batch (600 x 128 against 600 x 32;
   DCCA_* tolerances) with its time, ``evaluate_model`` (the DCCA core,
   and --use_output on the classifier) and ``evaluate_late_fusion`` (phase
   13's sensors checkpoint, and --use_output on the cross_prediction one)
   over the full-budget directory's 340 test events on the card against
   the CPU (embeddings EVAL_EMB_RTOL, metrics PAIR_METRIC_TOL), and the
   steady step of ``multitask_dcca``, ``modality_hallucination`` and
   ``cross_prediction`` on the full-budget directory;
16. the native host data path and slice 6b: the native TSN gather
   (``native_gather_segments`` and ``load_data_and_label``, built with
   g++ before phase 8, whose loaders all take it) against NumPy indexing
   and the per-event Python loop, bit for bit, train-time (generator state
   included) and test-time, on a full-budget session, and both paths'
   times on one session and a 3-session batch; the unsupervised pretrain
   chain at scripts/unimodal_pretrain.sh's widths on the full-budget
   directory's sensors: ``unimodal_pretrain_sae`` (Seq2seqTSN, emb_dim 128,
   1 epoch), ``unimodal_pretrain_cluster`` (the port's k-means, 20
   clusters, n_init 20; the stored inertia against NumPy on the CPU's
   embeddings) and ``unimodal_pretrain_pairsim`` (2 epochs; val_acc
   against the CPU head); ``base_model_tf`` at base_model's width on
   TFRecords written from the trainers' directory (a native-parsed batch
   against the Python parse, the metrics against the NumPy oracle, the
   steady step); no launch of any ``csrc/`` kernel;
17. slice 7 (serving) with no launch of any ``csrc/`` kernel:
   ``EmbeddingService`` at ConvRTSN full width (phase 15's hallucination
   core) on requests of 256 events, f32, int8 quantized on the host and
   int8 quantized beforehand (ms a request), card vs CPU on 32 events;
   ``RetrievalIndex`` on random unit rows of width 256 with Q = 1024,
   top-10: the dense path at 65,536 rows, the chunked path at 400,000 (7
   chunks; also squared Euclidean) and the int8 gallery at both, each with
   its one-time upload, device bytes, warm query time and queries a second,
   f32 results against a float64 top-k on the card, int8 top-10 overlap at
   least 0.95 with it, 256 queries card vs CPU, and the f32 products
   unchanged with TF32 switched on; ``export_index`` (phase 13's sensors
   ``pddm_model`` encoder, f32 and int8) on the full-budget test session,
   loaded and queried on the card against the CPU's, a second save
   byte-equal; ``evaluate_baseline`` (mean and max),
   ``evaluate_hallucination`` (phase 15's checkpoint), ``evaluate_pairsim``
   and ``check_inconsistent`` (phase 13's ``pairsim_model``, and the PDDM
   head of its sensors ``pddm_model``) card vs CPU on the same 340 events,
   ``analysis`` on an ``evaluate_model`` results.pkl; ``python3 -m
   multimodal_similarity_tpu_torch`` (listing, ``eval.analysis``, and
   ``preprocess.frames --help``) in subprocesses;
18. slice 8a, the device feature cache (``cache_phase``): on the
   full-budget directory the default ``--device_cache_gb`` 6.0 declines
   with the reference's notice and CACHE_GB builds (a decline fails the
   run), with the build's time, resident bytes and estimate; one plan
   gathered on the card and from a CPU copy of the resident arrays under
   the same uniforms (TSN q, scale, labels, mask bit-equal; the
   mean-pooled modality within CACHE_MEAN_RTOL); the fused cached
   semi-hard step against the two-call path (``epoch_batches``, then the
   plain step; CACHE_TWO_CALL_RTOL); the steady windows of the cached
   batch-hard step (K=1 and K=4) and the cached flagship
   ``--device_mining`` step, each with its device busy time and idle
   share, beside the streamed windows of the same steps; one epoch each of ``base_model_batchhard --device_cache
   --steps_per_dispatch 4``, ``base_model_lifted --device_cache`` and its
   ``--no_normalized`` through ``train``, each with its kernel launches
   (K3 or K1 a step; K6 and K5; K4 and K5) and a cache gather a step; on
   the 10-session directory one epoch each of ``base_model``,
   ``multitask_model``, ``pddm_model``, ``cross_prediction`` (mean-pooled
   target) and ``unimodal_pretrain_sae`` with --device_cache, with no
   ``csrc/`` launch;
19. run control and the process group (``run_control_phase``):
   ``base_model_batchhard --profile_dir --profile_steps 3`` for one epoch
   on the 40-session directory at base_model's width (the trace holds one
   ``batch_hard_tri_tc`` a profiled step; its five longest device
   operations, and the step interval inside the window and after it);
   ``--watchdog_secs 2`` with the second step stalled 4 s (thread dump,
   stop, checkpoint of step 2, a ``--model_path`` rerun from step 3); a
   SIGTERM to ``python -m multimodal_similarity_tpu_torch
   train.base_model_batchhard --device cuda`` after two logged steps (rc
   0, the preemption line, the checkpoint of that step); then a one-rank
   NCCL group (``init_method=file://``): the batch-hard ring's stats,
   winners and loss gradient against f32 K1 and the lifted ring's against
   K4 and K5 at N=1024, d=256, each ring's forward plus backward time
   beside the kernel path's, ``make_dp_triplet_step`` against the fused
   semi-hard step at base_model's width (loss and parameters rtol 1e-5),
   and ``sync_should_stop``'s all-reduce over NCCL;
20. slice 8c-ii on a one-rank NCCL group (``sharded_phase``), with no
   launch of any ``csrc/`` kernel: ``RetrievalIndex`` on the mesh at phase
   17's sizes against the index without one (f32 and int8 at 65,536 rows
   index-equal, distances within SH_INDEX_RTOL; f32 at 400,000 rows by
   ``same_topk``), each query's ms beside the unsharded one's; the
   full-budget train sessions cached over the mesh and without it
   (resident arrays and the first epoch's plans bit-equal, both build
   times); the fused flagship step at train_multimodal_model.sh's width
   on a full-budget batch and the cached flagship for two 2-step windows,
   on the mesh and without it (loss and parameters within SH_STEP_RTOL,
   ms a draw of each); then removes the full-budget directory and prints
   each phase's native gathers and deferrals (phases 8-15, 17 and 21
   must have gathered natively);
21. slice 9, per-frame feature extraction (``features_phase``), with no
   launch of any ``csrc/`` kernel outside its training epoch: the
   Inception-ResNet-v2 trunk (54,276,192 parameters) and InceptionV1 at
   full width from a seeded generator, a 2-image batch at 299 / 224 on the
   card against the CPU forward of the same weights (TOWER_RTOL, TF32
   off); a slim checkpoint made from the seed grafted onto the card trunk
   (every parameter and running statistic); ``slim_backbone`` on seeded
   uint8 frames at the Honda camera's 720 x 1280 (the antialiased resize
   to 299 on the card), 2 frames against the CPU's, then ms a batch of 32
   and frames a second with TF32 off and on; ``PipelinedBackbone`` in 2
   stages on ``cuda:0`` twice (microbatch 8) against the single stage
   (PIPE_RTOL) with its frames a second, and 2 stages with
   ``devices=None`` raising on one card; the resnet .npy of a synthetic
   Honda directory (3 sessions x 240 frames) written by
   ``extract_sessions`` from seeded frames, then one epoch of
   ``base_model_batchhard`` at full width on them with its K3 launches;
   ``preprocess.segmentation``, ``preprocess.sensors`` and
   ``tools.import_tf1`` through ``python3 -m
   multimodal_similarity_tpu_torch`` on seed-made inputs, each output held
   to the function run in-process.
Then a ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is visible or the port's package is not beside this script.
"""

import contextlib
import functools
import json
import math
import os
import pickle
import shutil
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


def write_synthetic(root, n_sessions=10):
    from multimodal_similarity_tpu_torch.data import generate_synthetic_honda
    t0 = time.time()
    generate_synthetic_honda(root, n_sessions=n_sessions,
                             frames_per_session=240,
                             modal_dims={"resnet": (8, 8, 1536)}, seed=0)
    print(f"[trainer] synthetic Honda dir ({n_sessions} sessions x 240 "
          f"frames of 8x8x1536) written in {time.time() - t0:.1f} s",
          flush=True)


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


def drive_trainer(root, tag, train_fn, cfg, expect_val_loss=True,
                  encoder=lambda model: model):
    """One trainer run, every launch count set to 0 just before it and read
    just after; finite losses (a finite validation loss too, unless the
    trainer logs none), and the device retrieval metrics of the trained
    model's ``encoder`` against the NumPy oracle.  Returns (result,
    launches, validations, experiment, validation embeddings, labels)."""
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
    for r in steps:
        extra = "".join(f" {k} {r[k]:.3f}" for k in ("active_count",
                                                     "triplet_num") if k in r)
        print(f"[{tag}] step {r['step']} loss {r['loss']:.6f}{extra}",
              flush=True)
    for r in vals:
        print(f"[{tag}] step {r['step']} val_mAP {r['val_mAP']:.6f}"
              + (f" val_loss {r['val_loss']:.6f}" if "val_loss" in r
                 else ""), flush=True)
    print(f"[{tag}] {res.step} steps, {len(vals)} validations in "
          f"{wall:.1f} s; launches {json.dumps(launches)}", flush=True)
    if res.step < cfg.max_epochs or not steps:
        fail(f"{tag}: trainer took {res.step} steps")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"{tag}: non-finite training loss")
    if len(vals) != cfg.max_epochs or \
            not all(math.isfinite(r["val_mAP"]) for r in vals):
        fail(f"{tag}: {len(vals)} validations, or a non-finite val mAP")
    if expect_val_loss and not all(
            math.isfinite(r.get("val_loss", math.nan)) for r in vals):
        fail(f"{tag}: a validation without a finite val_loss")

    # outputs: the device retrieval metrics against the NumPy oracle on the
    # trained model's validation embeddings
    exp = HondaExperiment(cfg, result_dir=os.path.join(root, f"check_{tag}"),
                          supports_int8=True)
    exp.close()
    emb = embed_in_chunks(make_embed_fn(encoder(res.model), cfg.normalized),
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


def trainer_phase(root, steady_root):
    """The batch-hard trainer, then the lifted trainer normalised and not;
    returns each kernel's launches from the run whose path takes it.  The
    step breakdowns read ``steady_root``."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import use_triangular
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard, base_model_lifted)

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
    exp = steady_experiment(steady_root, "trainer")
    step_breakdown("trainer", exp, cfg,
                   *balanced_parts(res, exp, cfg, "batchhard"))

    cfg = full_width_cfg(root, "smoke_lifted")
    res, lt, n_val, exp, emb, labels = drive_trainer(
        root, "lifted", base_model_lifted.train, cfg)
    expect_launches("lifted", lt, {
        "lifted_fwd_tri": res.step + n_val, "lifted_bwd": res.step,
        "lifted_fwd": 0, "sqdist": 0, **dict.fromkeys(BATCH_HARD, 0)})
    # K4/K5/K6 at the validation shape the main path gave K6, on its inputs
    check_lifted("validation-shape", emb, labels,
                 torch.ones(emb.shape[0]).cuda(), "f32")
    exp = steady_experiment(steady_root, "lifted")
    step_breakdown("lifted", exp, cfg,
                   *balanced_parts(res, exp, cfg, "lifted"))

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


def balanced_parts(res, exp, cfg, loss_kind):
    """(device keys, selection, step, the trainer's feed source) of the
    class-balanced trainers for ``step_breakdown``."""
    import random

    from multimodal_similarity_tpu_torch.ops.mining import (
        select_batch_balanced)
    from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
        import balanced_batches, make_balanced_batch_step

    def select(batch):
        idx = select_batch_balanced(batch["labels"][:batch["num_events"]],
                                    cfg.batch_size, rng=random.Random(0))
        return {"events": batch["events"], "labels": batch["labels"],
                "rows": idx}

    step = make_balanced_batch_step(res.model, res.optimizer, cfg, loss_kind)
    return (("events", "labels"), select,
            lambda b: step(b["events"], b["labels"], cfg.learning_rate),
            balanced_batches(exp, cfg.batch_size, random.Random(0)))


def base_model_parts(res, exp, cfg):
    """(device keys, selection, step, the trainer's feed source) of the
    semi-hard trainer for ``step_breakdown`` and ``steady_step``: the
    whole budget batch goes up; the trainer's own step runner mines."""
    import random

    import torch
    from multimodal_similarity_tpu_torch.train.trainers.base_model import (
        budget_batches, make_step_runner)

    mine_rng = random.Random(0)
    keys, run = make_step_runner(
        cfg, res.model, res.optimizer, torch.device("cuda"),
        torch.Generator(device="cuda").manual_seed(0), mine_rng)
    return (keys, lambda batch: batch,
            lambda b: run(b, cfg.learning_rate),
            budget_batches(exp, cfg, mine_rng))


STEADY_WARM, STEADY_DRAWS = 3, 20


def steady_experiment(steady_root, tag, **kw):
    """The session loader of ``full_width_cfg(..., **kw)`` on the larger
    directory the steady-state windows read (8 batches an epoch, where the
    trainers' directory gives 2: the loader's prefetch thread starts anew
    each epoch, so 2-batch epochs would time its refill, not its pace)."""
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    exp = HondaExperiment(full_width_cfg(steady_root, f"steady_{tag}", **kw),
                          result_dir=os.path.join(steady_root, f"r_{tag}"),
                          supports_int8=True)
    exp.close()
    return exp


def _overlap(spans, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in spans)


def steady_step(tag, cfg, device_keys, step, source, warm=STEADY_WARM,
                draws=STEADY_DRAWS):
    """The trainer's step time at its steady state: the trainer's own feed
    source (fresh loader batches, epoch after epoch, and its selection or
    random miner) on the feed thread through ``device_prefetch`` with the
    config's feature casts, its step on the main thread with a readback of
    each step's loss (as the trainer at log_flush_every=1, and a finite
    check).  After ``warm`` loader draws (the feed's fill), a window of
    ``draws`` consecutive draws on the host clock, synchronised at both
    ends; a draw the miner finds nothing in takes no optimizer step and
    stays in the window.  Within the window it also sums the main thread's
    wait for the feed, its time in the steps, and the feed thread's wait
    for its source (the loader and the selection).  Returns those, each
    over the window's draws, as ``step_s``, ``feed_wait_s``,
    ``in_step_s`` and ``source_wait_s``, and the window's optimizer steps
    as ``steps``."""
    import torch
    from multimodal_similarity_tpu_torch.data.device_feed import (
        device_prefetch, feature_keys)

    source_spans, wait_spans, step_spans = [], [], []

    def timed(items):
        """``items`` on the feed thread, each wait for one recorded; closed
        with the stream."""
        try:
            while True:
                t = time.perf_counter()
                try:
                    item = next(items)
                except StopIteration:
                    return
                source_spans.append((t, time.perf_counter()))
                yield item
        finally:
            items.close()

    stream = device_prefetch(timed(source), "cuda", device_keys,
                             **feature_keys(cfg))
    steps = 0
    try:
        for draw in range(warm + draws):
            if draw == warm:
                torch.cuda.synchronize()
                t0, steps = time.perf_counter(), 0
            ta = time.perf_counter()
            batch = next(stream)
            tb = time.perf_counter()
            aux = None if batch is None else step(batch)
            if aux is not None:
                if not math.isfinite(float(aux["loss"])):
                    fail(f"{tag}: non-finite loss in the steady-state "
                         "window")
                steps += 1
            wait_spans.append((ta, tb))
            step_spans.append((tb, time.perf_counter()))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        stream.close()
    if not steps:
        fail(f"{tag}: no optimizer step in the steady-state window")
    n = draws
    out = {"steps": steps, "step_s": (t1 - t0) / n,
           "feed_wait_s": _overlap(wait_spans, t0, t1) / n,
           "in_step_s": _overlap(step_spans, t0, t1) / n,
           "source_wait_s": _overlap(source_spans, t0, t1) / n}
    print(f"[{tag}] steady state: {n} consecutive loader draws "
          f"({steps} optimizer steps) in {t1 - t0:.4f} s after "
          f"{warm} warm-up draws; a draw (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()
                      if k != "steps"), flush=True)
    return out


def step_breakdown(tag, exp, cfg, device_keys, select, step, source):
    """Where one full-width step's time goes, each part timed alone on the
    host clock: loading a session batch; the selection; for each feature
    type (f32, bf16, int8) staging a batch into the feed's pinned ring (the
    row gather, plus the cast or the quantizing), once on a fresh loader
    batch (its pages first touched) and once more on the same batch, and
    its upload (side-stream copy to its event); the device step (ending in
    a synchronise); and, for the record of the serial loop the feed
    replaced, a NumPy row gather and a pageable upload of the f32 events.
    ``steady_*`` are the trainer's steady state with the feed overlapped
    (``steady_step``), which it returns.  ``exp`` is the steady-state
    directory's experiment."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.data.device_feed import BatchPlacer

    def load():
        batches = exp.loader.epoch(max_batches=1)
        try:
            return next(batches)
        finally:
            batches.close()

    t0 = time.perf_counter()
    batch = load()
    t1 = time.perf_counter()
    item = select(batch)
    t2 = time.perf_counter()
    parts = {"load_batch_s": t1 - t0, "select_s": t2 - t1}
    placed = {}
    for feat, casts in (("f32", {}), ("bf16", {"bf16_keys": ("events",)}),
                        ("int8", {"int8_keys": ("events",)})):
        placer = BatchPlacer("cuda", device_keys, **casts)
        placer.place(item)                   # allocates the pinned ring
        fresh = select(load())
        torch.cuda.synchronize()
        ta = time.perf_counter()
        bufs, slot = placer.stage(fresh)
        tb = time.perf_counter()
        out, event = placer.upload(fresh, bufs, slot)
        event.synchronize()
        tc = time.perf_counter()
        placer.stage(fresh)
        td = time.perf_counter()
        parts[f"stage_{feat}_fresh_s"] = tb - ta
        parts[f"stage_{feat}_s"] = td - tc
        parts[f"upload_{feat}_s"] = tc - tb
        parts[f"upload_{feat}_bytes"] = int(sum(
            t.numel() * t.element_size() for v in bufs.values()
            for t in (v.values() if isinstance(v, dict) else (v,))))
        placed[feat] = placer.receive((out, event))
    rows = item.get("rows")
    t3 = time.perf_counter()
    host = batch["events"] if rows is None else batch["events"][rows]
    t4 = time.perf_counter()
    torch.from_numpy(host).cuda()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    parts.update(numpy_gather_s=t4 - t3, pageable_upload_s=t5 - t4)
    step(placed["f32"])
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    for _ in range(3):
        step(placed["f32"])
    torch.cuda.synchronize()
    parts["device_step_s"] = (time.perf_counter() - t6) / 3
    del placed
    steady = steady_step(tag, cfg, device_keys, step, source)
    parts.update({f"steady_{k}": v for k, v in steady.items()})
    print(f"[{tag}] step breakdown {json.dumps(parts)}", flush=True)
    if not all(np.isfinite(v) for k, v in parts.items() if k.endswith("_s")):
        fail(f"{tag}: step breakdown has a non-finite part")
    return steady


def base_model_phase(root, steady_root):
    """The semi-hard triplet trainer at the width of
    scripts/train_base_model.sh:5-11 (event budget 1000, 3 sessions a
    batch, 200 triplets, 5 negatives): 2 epochs with the fused device miner
    in f32, 1 epoch each with --bf16_features, --int8_features and the host
    miner ``facenet_host``; finite losses, the metrics against the NumPy
    oracle, no launch of any kernel of ``csrc/`` (none is on this path);
    a step breakdown of the f32 run, and each run's steady state, both on
    ``steady_root``."""
    from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES
    from multimodal_similarity_tpu_torch.train.trainers import base_model

    runs = (("base-model", {}),
            ("base-model-bf16", {"bf16_features": True, "max_epochs": 1}),
            ("base-model-int8", {"int8_features": True, "max_epochs": 1}),
            ("base-model-facenet-host", {"triplet_select": "facenet_host",
                                         "max_epochs": 1}))
    times = {}
    for tag, kw in runs:
        kw = {"triplet_select": "facenet", "triplet_per_batch": 200,
              "num_negative": 5, **kw}
        cfg = full_width_cfg(root, f"smoke_{tag}", **kw)
        res, launches, _, _, _, _ = drive_trainer(
            root, tag, base_model.train, cfg, expect_val_loss=False)
        expect_launches(tag, launches, dict.fromkeys(LAUNCHES, 0))
        exp = steady_experiment(steady_root, tag, **kw)
        keys, select, step, source = base_model_parts(res, exp, cfg)
        times[tag] = (step_breakdown(tag, exp, cfg, keys, select, step,
                                     source) if tag == "base-model" else
                      steady_step(tag, cfg, keys, step, source))
        del res, step, source
    print(f"[base-model] steady state by feature type and miner (s a "
          f"loader draw) {json.dumps(times)}", flush=True)


def feed_phase():
    """The device feed on the card: the pinned ring's uploads equal the
    host arrays once received, over more batches than the ring holds (and
    still equal at the end, so no buffer was reused early); bf16 batches
    within half a bf16 ulp and int8 batches within scale / 2 (plus f32
    rounding) of the host features; a change of batch shape and a failed
    copy raise in the consumer."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.data.device_feed import (
        DEPTH, device_prefetch)

    rng = np.random.RandomState(0)
    src = rng.randn(160, 3, 8, 8, 1536).astype(np.float32)
    src[:, :, :, :, 7] *= 40.0                # a hot channel
    n_batches = 7                              # ring of DEPTH + 1 = 3
    plan = [{"events": src, "labels": np.arange(160, dtype=np.int32),
             "rows": rng.randint(0, 160, 128)} for _ in range(n_batches)]
    for feat, casts in (("f32", {}), ("bf16", {"bf16_keys": ("events",)}),
                        ("int8", {"int8_keys": ("events",)})):
        kept = []
        t0 = time.perf_counter()
        for b in device_prefetch(iter(plan), "cuda", ("events", "labels"),
                                 **casts):
            kept.append(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        worst = 0.0
        for b, got in zip(plan, kept):
            want = src[b["rows"]]
            if not np.array_equal(got["labels"].cpu().numpy(),
                                  b["labels"][b["rows"]]):
                fail(f"feed {feat}: labels differ after the upload")
            if feat == "f32":
                if not np.array_equal(got["events"].cpu().numpy(), want):
                    fail("feed f32: upload differs from the host rows")
                continue
            if feat == "bf16":
                x = got["events"].float().cpu().numpy()
                bound = np.abs(want) * 2.0 ** -8
            else:
                scale = got["events"]["scale"].cpu().numpy()
                x = got["events"]["q"].float().cpu().numpy() * scale
                # half a step, plus the f32 roundings of x / scale and
                # q * scale (values up to 127 scale)
                bound = np.broadcast_to(scale * (0.5 + 1e-4), want.shape)
            err = np.abs(x - want)
            worst = max(worst, float((err / np.maximum(bound, 1e-30)).max()))
            if np.any(err > bound):
                fail(f"feed {feat}: a value beyond its rounding bound")
        print(f"[feed] {feat}: {n_batches} batches of 128 x 3 x 8x8x1536 "
              f"through a ring of {DEPTH + 1} pinned buffers in "
              f"{wall:.3f} s, "
              + ("equal to the host rows" if feat == "f32" else
                 f"within rounding of the host rows (worst error "
                 f"{worst:.4f} of its bound)"), flush=True)

    def changing():
        for rows in (64, 64, 32):
            yield {"events": src, "rows": np.arange(rows)}

    def raised(stream, skip):
        """The error the feed raises in the consumer after ``skip`` good
        batches, or None."""
        try:
            for _ in range(skip + 1):
                next(stream)
        except Exception as e:  # noqa: BLE001 — any feed error is the check
            return e
        finally:
            stream.close()
        return None

    err = raised(device_prefetch(changing(), "cuda", ("events",)), 2)
    if not isinstance(err, ValueError):
        fail(f"feed: a change of batch shape gave {err!r}, not ValueError")
    print(f"[feed] a change of batch shape raises ValueError: {err}"[:200],
          flush=True)
    bad = f"cuda:{torch.cuda.device_count()}"
    err = raised(device_prefetch(iter(plan[:1]), bad, ("events",)), 0)
    if err is None:
        fail(f"feed: a copy to {bad} did not raise")
    print(f"[feed] a failed copy (to {bad}) raises {type(err).__name__}: "
          f"{str(err).splitlines()[0]}", flush=True)


def fused_step_rates():
    """The fused semi-hard step at bench.py:47-53's shape (1024 events of
    3 x 8x8x1536, ConvRTSN emb_dim 256, 7 classes, 100 triplets, keep_prob
    0.9) with device-resident f32, bf16 and int8 features, each from the
    same initial weights: the first step mines triplets and its loss is
    finite; events per second, best of two rounds of 20 steps (CUDA
    events)."""
    import torch
    from multimodal_similarity_tpu_torch.data.device_feed import (
        quantize_features)
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.steps import (
        make_triplet_train_step)

    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1024
    labels = torch.randint(0, 7, (n,), device="cuda", generator=gen)
    centers = torch.randn((7, 1, 8, 8, 1536), device="cuda", generator=gen)
    x = centers[labels] + torch.randn((n, 3, 8, 8, 1536), device="cuda",
                                      generator=gen)
    q, scale = quantize_features(x)
    feats = {"f32": x, "bf16": x.to(torch.bfloat16),
             "int8": {"q": q, "scale": scale}}
    mask = torch.ones(n, device="cuda")
    rates = {}
    for feat, events in feats.items():
        # the same initial weights for each feature type
        model = build_encoder(
            "convrtsn", num_seg=3, emb_dim=256, n_input=1536, n_h=8, n_w=8,
            n_C=20, keep_prob=0.9, generator=torch.Generator().manual_seed(1),
            dropout_generator=torch.Generator(device="cuda").manual_seed(2)
        ).cuda()
        step = make_triplet_train_step(
            model, build_optimizer("ADAM", model, 0.01),
            triplet_per_batch=100, alpha=0.2,
            generator=torch.Generator(device="cuda").manual_seed(3))
        aux = step(events, labels, mask, 0.01)
        if not math.isfinite(float(aux["loss"])) or \
                float(aux["triplet_num"]) <= 0:
            fail(f"fused step {feat}: loss {float(aux['loss'])}, "
                 f"{float(aux['triplet_num'])} triplets")
        best = min(call_ms(lambda: step(events, labels, mask, 0.01),
                           iters=20, warmup=2) for _ in range(2))
        rates[feat] = n / (best / 1e3)
        print(f"[fused-step] {feat}: {best:.3f} ms a step, "
              f"{rates[feat]:.0f} events/s", flush=True)
    del feats, x
    torch.cuda.empty_cache()
    return rates


# ---------------------------------------------------------------------------
# the CUB track
# ---------------------------------------------------------------------------

CUB_SEED = 12345
CUB_CLASSES, CUB_PER_CLASS = 100, 59        # a split of ~5,900 rows
CUB_IMG_CLASSES, CUB_IMG_PER_CLASS = 100, 8  # 800 training images
CUB_IMG_TEST_CLASSES, CUB_IMG_TEST_PER = 80, 4   # 320 test images
CUB_IMG, CUB_CROP = 256, 224
# training-mode batch norm on the card against the CPU, relative to the
# output's scale: f32 noise of the batch variance through ~70 layers (the
# CPU tests hold the same forward to flax at 2e-3); eval mode has no
# batch statistics and stays within 1e-4
CUB_TRAIN_TOL, CUB_EVAL_TOL = 2e-3, 1e-4


def cub_images():
    """Class-tinted images in [0, 1] from the seed: 100 classes x 8
    training images and 80 other classes x 4 test images of 256 x 256 x 3
    f32 (train labels 0-based, test labels 1-based, as on disk)."""
    import numpy as np
    rng = np.random.default_rng(CUB_SEED)

    def split(n_cls, per, first):
        tint = rng.random((n_cls, 1, 1, 3), dtype=np.float32)
        labels = np.repeat(np.arange(n_cls), per)
        img = rng.random((n_cls * per, CUB_IMG, CUB_IMG, 3),
                         dtype=np.float32)
        img *= 0.5
        for i in range(0, len(img), 64):
            img[i:i + 64] += 0.5 * tint[labels[i:i + 64]]
        return img, labels + first

    img, lab = split(CUB_IMG_CLASSES, CUB_IMG_PER_CLASS, 0)
    img_te, lab_te = split(CUB_IMG_TEST_CLASSES, CUB_IMG_TEST_PER, 1)
    return {"image_train": img, "label_train": lab, "image_test": img_te,
            "label_test": lab_te}


def _oracle_part(emb, labels, queries):
    """``evaluate_simple``'s per-query loop over ``queries``: the lists of
    AP, precision at recall 0.5 and recall@1."""
    import numpy as np
    from multimodal_similarity_tpu_torch.eval.metrics import (
        precision_at_recall, recall_at_K, retrieve_one)
    aps, precs, hits = [], [], []
    for i in queries:
        if labels[i] <= 0:
            continue
        rest = np.delete(labels, i)
        _, order, ap = retrieve_one(emb[i], np.delete(emb, i, 0), labels[i],
                                    rest)
        if np.isnan(ap):
            continue
        aps.append(ap)
        precs.append(precision_at_recall(rest[order], labels[i], 0.5)[0])
        hits.append(recall_at_K(rest[order], labels[i], 1))
    return aps, precs, hits


class OracleChecks:
    """The NumPy oracle (``evaluate_simple``'s per-query loop) for trained
    models' test embeddings, run beside the rest of the phase: at 5,900
    rows one process takes most of a minute, so each set's queries are
    split over a pool of spawned processes (one core left to the main
    thread) as it comes, and ``finish`` waits for them and holds the
    device metrics to the oracle's (2e-3).  ``close`` shuts the pool down
    (queued work cancelled, running work waited for)."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        cores = len(os.sched_getaffinity(0))
        self.workers = max(1, min(8, cores - 1))
        self.pool = ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("spawn"))
        self.pending = []

    def submit(self, tag, emb, labels, dev):
        import numpy as np
        emb = np.array(emb, dtype=np.float64)
        parts = np.array_split(np.arange(len(labels)), self.workers)
        self.pending.append((tag, dev, len(labels), time.time(), [
            self.pool.submit(_oracle_part, emb, labels, q) for q in parts]))

    def finish(self):
        import numpy as np
        for tag, dev, n, t0, futures in self.pending:
            outs = [f.result() for f in futures]
            ref = [float(np.mean(sum((o[k] for o in outs), [])))
                   for k in range(3)]
            print(f"[{tag}] val metrics device (mAP, mPrec, R@1) "
                  f"{dev[0]:.6f} {dev[1]:.6f} {dev[2][1]:.6f} vs NumPy "
                  f"oracle {ref[0]:.6f} {ref[1]:.6f} {ref[2]:.6f} ({n} "
                  f"rows, {self.workers} processes, ready "
                  f"{time.time() - t0:.1f} s after submission)", flush=True)
            if not np.allclose([dev[0], dev[1], dev[2][1]], ref, atol=2e-3):
                fail(f"{tag}: device retrieval metrics disagree with the "
                     "NumPy oracle")

    def close(self):
        self.pool.shutdown(cancel_futures=True)


def drive_cub(root, tag, train_fn, cfg, data, embed, want_steps, want_vals,
              oracle, **kw):
    """One CUB trainer run, every launch count set to 0 just before it and
    read just after: finite losses, the steps and validations asked for,
    and the device retrieval metrics of the trained model's test-split
    embeddings (``embed(result)``) against the trainer's last validation,
    and (through ``oracle``, an OracleChecks) against the NumPy oracle.
    Returns (result, launches)."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.eval.metrics import (
        retrieval_metrics)
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)

    reset_launch_counts()
    t0 = time.time()
    res = train_fn(cfg, data=data,
                   result_dir=os.path.join(root, f"result_{tag}"), **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    vals = [r for r in recs if "val_mAP" in r]
    print(f"[{tag}] {res.step} steps, {len(vals)} validations in "
          f"{wall:.1f} s; losses first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}; last validation "
          + json.dumps({k: v for k, v in vals[-1].items() if k != "time"})
          + f"; launches {json.dumps(launches)}", flush=True)
    if res.step != want_steps or len(losses) != want_steps:
        fail(f"{tag}: {res.step} steps, {len(losses)} losses, not "
             f"{want_steps}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: a non-finite training loss")
    if len(vals) != want_vals or not all(
            math.isfinite(r["val_mAP"]) for r in vals):
        fail(f"{tag}: {len(vals)} validations (not {want_vals}), or a "
             "non-finite val mAP")
    emb = embed(res)
    labels = np.asarray(data["label_test"]).reshape(-1)
    if tuple(emb.shape) != (len(labels), cfg.emb_dim) or \
            not bool(torch.isfinite(emb).all()):
        fail(f"{tag}: test embeddings {tuple(emb.shape)} not finite or of "
             "the wrong shape")
    dev = retrieval_metrics(emb, labels)
    if abs(dev[0] - vals[-1]["val_mAP"]) > 1e-6 or \
            abs(dev[2][1] - vals[-1]["val_recall@1"]) > 1e-6:
        fail(f"{tag}: the trained model's val mAP / R@1 differ from the "
             "trainer's last validation")
    oracle.submit(tag, emb.cpu().numpy(), labels, dev)
    return res, launches


def step_busy_ms(step, calls=5):
    """(device time, device operations) of one step: the summed CUDA
    kernel and copy times of a torch.profiler trace of ``calls`` steps,
    and their count, over the calls; fails when the trace has no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in device)
    if not us > 0:
        fail("step_busy_ms: no device time in the profiler trace")
    return us / calls / 1e3, len(device) / calls


def step_event_ms(step, calls=5, sleep_cycles=int(2e9)):
    """Device time of one step from CUDA events: ``calls`` steps enqueued
    behind a spin kernel of ``sleep_cycles`` clocks, so that the card
    finds them queued and runs them back to back.  Where a step waits for
    the card inside (a readback), the card idles while the host enqueues
    the rest, and that idle time is in this figure too."""
    import torch
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(calls):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def cub_steady(tag, step, sample):
    """The trainer loop's steady state: STEADY_WARM iterations, then
    STEADY_DRAWS consecutive ones on the host clock (each: the host batch
    draw and upload ``sample()``, the step, and the loss readback the
    trainer does), synchronised at both ends; then the device time of the
    step alone on one uploaded batch: the profiler's busy time
    (``step_busy_ms``), which sets the idle share 1 - busy / step, and the
    CUDA events' span of steps enqueued ahead (``step_event_ms``), which
    also holds the card's waits for launches it ran out of."""
    import torch
    for _ in range(STEADY_WARM):
        float(step(*sample())["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEADY_DRAWS):
        loss = float(step(*sample())["loss"])
        if not math.isfinite(loss):
            fail(f"{tag}: non-finite loss in the steady-state window")
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEADY_DRAWS * 1e3
    batch = sample()
    busy, ops = step_busy_ms(lambda: step(*batch))
    events = step_event_ms(lambda: step(*batch))
    out = {"step_ms": step_ms, "device_busy_ms": busy,
           "device_event_ms": events, "idle_share": 1 - busy / step_ms,
           "device_ops": ops}
    print(f"[{tag}] steady state: {STEADY_DRAWS} consecutive steps after "
          f"{STEADY_WARM} warm-up steps, with the per-step loss readback "
          + json.dumps(out), flush=True)
    return out


def cub_losses_on_card(emb, labels, gen):
    """``triplet_semihard_loss``, ``npairs_loss`` and ``cluster_loss`` at
    batch 64 on the card against the CPU on the same inputs (1e-4): a
    class-balanced batch of 64 test embeddings, and 64 (anchor, positive)
    pairs of 64 classes for n-pairs.  Each CPU value must be above 0: the
    hinges of a well-separated batch are all 0, and 0 against 0 would
    check nothing."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.data.cub import sample_cub_batch
    from multimodal_similarity_tpu_torch.ops import losses
    from multimodal_similarity_tpu_torch.train.trainers._cub import (
        class_index)
    classes = class_index(labels)
    idx = sample_cub_batch(classes, 64, gen)
    pairs = np.array([gen.permutation(classes[c])[:2] for c in
                      gen.permutation(sorted(classes))[:64]])
    cases = {
        "triplet_semihard_loss": (losses.triplet_semihard_loss,
                                  (labels[idx], emb[idx], 0.2)),
        "npairs_loss": (losses.npairs_loss,
                        (labels[pairs[:, 0]], emb[pairs[:, 0]],
                         emb[pairs[:, 1]])),
        "cluster_loss": (losses.cluster_loss, (labels[idx], emb[idx])),
    }
    for name, (fn, args) in cases.items():
        host = [torch.from_numpy(np.asarray(a)) if isinstance(
            a, np.ndarray) else a for a in args]
        want = float(fn(*host))
        got = float(fn(*[a.cuda() if torch.is_tensor(a) else a
                         for a in host]))
        print(f"[cub-losses] {name} at batch 64: card {got:.7f} CPU "
              f"{want:.7f}", flush=True)
        if not want > 0:
            fail(f"cub-losses: {name} is {want} on the CPU; the batch "
                 "checks nothing")
        if not (math.isfinite(got) and abs(got - want) <= 1e-4):
            fail(f"cub-losses: {name} on the card {got} vs the CPU {want}")


def inception_on_card(model, images):
    """InceptionV2's pooled output on the card against a CPU copy of the
    same weights on the same centre crops, in eval mode (the trained
    running statistics; CUB_EVAL_TOL of the output's scale) and in
    training mode (CUB_TRAIN_TOL), with the batch statistics that training
    forward moves the running statistics towards (from zero, so the
    buffers hold them times 1 - momentum; CUB_TRAIN_TOL of their scale)."""
    import copy

    import torch
    from multimodal_similarity_tpu_torch.train.trainers.base_CUB import (
        center_crop)
    tower = copy.deepcopy(model.InceptionV2)
    host = copy.deepcopy(tower).cpu()
    x = center_crop(torch.from_numpy(images), CUB_CROP)
    for mode, tol in (("eval", CUB_EVAL_TOL), ("train", CUB_TRAIN_TOL)):
        if mode == "train":
            for m in (tower, host):
                for buf in m.buffers():
                    buf.zero_()
        tower.train(mode == "train")
        host.train(mode == "train")
        with torch.no_grad():
            got = tower(x.cuda()).cpu()
            want = host(x)
        err = float((got - want).abs().max()) / float(want.abs().max())
        line = (f"[inception] {mode} mode, {x.shape[0]} crops of "
                f"{CUB_CROP}: pooled output card vs CPU max error "
                f"{err:.3g} of its scale (tol {tol:g})")
        if mode == "train":
            s_err = max(float((b.cpu() - h).abs().max())
                        / float(h.abs().max())
                        for b, h in zip(tower.buffers(), host.buffers()))
            line += f"; batch statistics max error {s_err:.3g}"
            err = max(err, s_err)
        print(line, flush=True)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            fail(f"inception: {mode} mode differs between card and CPU")


def cub_phase(root):
    """The CUB track at the scripts' widths, random weights from seed
    12345: ``base_model_CUB`` (scripts/train_base_CUB.sh: emb 64, batch
    64, 64 triplets, Adam 1e-3, alpha 0.2) and ``pddm_CUB``
    (scripts/CUB_pddm.sh) on 1024-d features and 312-d attributes of 100
    classes x 59 images a split, 100 steps each; ``base_CUB --network
    inception_v2`` (scripts/CUB_tensorflow.sh: emb 64, batch 32, Adam 1e-3)
    on 224 crops of 256 x 256 images, 20 steps with ``--loss triplet`` and
    10 with ``--loss batchhard`` (one K1 launch a step, nothing else), and
    ``debug_CUB`` (2 steps).  Checks each run's losses and its metrics
    against the NumPy oracle, InceptionV2 and the three losses on the card
    against the CPU, and K1 at the path's shape against its plain version;
    then, with the oracle's processes done, times each trainer's steady
    step.  Returns the batch-hard launches of the ``base_CUB`` path."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    from multimodal_similarity_tpu_torch.data.cub import (
        generate_synthetic_cub, sample_cub_batch)
    from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES
    from multimodal_similarity_tpu_torch.train.steps import (
        embed_in_chunks, make_embed_fn, make_triplet_train_step)
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_CUB, base_model_CUB, debug_CUB, pddm_CUB)
    from multimodal_similarity_tpu_torch.train.trainers._cub import (
        class_index)

    t_phase = time.time()
    feats = generate_synthetic_cub(
        os.path.join(root, "cub"), n_classes=CUB_CLASSES,
        per_class=CUB_PER_CLASS, feat_dim=1024, att_dim=312, seed=CUB_SEED)
    images = cub_images()
    mb = (images["image_train"].nbytes + images["image_test"].nbytes) / 1e6
    print(f"[cub] synthetic data in {time.time() - t_phase:.1f} s: "
          f"features {feats['feat_train'].shape} / "
          f"{feats['feat_test'].shape}, attributes "
          f"{feats['att_train'].shape}, images "
          f"{images['image_train'].shape} / {images['image_test'].shape} "
          f"({mb:.0f} MB f32)", flush=True)
    cuda = torch.device("cuda")
    none = dict.fromkeys(LAUNCHES, 0)
    oracle = OracleChecks()

    def cfg(name, **kw):
        return TrainConfig(name=name, DATA_ROOT=os.path.join(root, "cub"),
                           silent_mode=True, seed=CUB_SEED, emb_dim=64,
                           learning_rate=1e-3, optimizer="ADAM", alpha=0.2,
                           **kw).resolve()

    def feature_embed(key, sub=None):
        def embed(res):
            model = res.model if sub is None else getattr(res.model, sub)
            x = torch.from_numpy(feats[key]).to(cuda)
            return embed_in_chunks(make_embed_fn(model, True), x, cuda)
        return embed

    def image_embed(res):
        embed = make_embed_fn(res.model, True)
        return embed_in_chunks(
            lambda x: embed(base_CUB.center_crop(x, CUB_CROP)),
            images["image_test"], cuda, chunk=64)

    rng = np.random.RandomState(1)
    classes = class_index(feats["label_train"])
    img_classes = class_index(images["label_train"])

    def feature_batch():
        idx = sample_cub_batch(classes, 64, rng)
        return (torch.from_numpy(feats["feat_train"][idx]).to(cuda),
                torch.from_numpy(feats["label_train"][idx] + 1).to(cuda),
                torch.ones(len(idx), device=cuda), 1e-3)

    def image_batch():
        idx = sample_cub_batch(img_classes, 32, rng)
        return (torch.from_numpy(images["image_train"][idx]).to(cuda),
                torch.from_numpy(images["label_train"][idx]).to(cuda),
                1e-3)

    steady = {}             # tag -> (step, batch source), timed last
    path = {}
    try:
        res, launches = drive_cub(
            root, "base-model-CUB", base_model_CUB.train,
            cfg("smoke_base_model_CUB", batch_size=64, max_epochs=100,
                static_epochs=2500, triplet_per_batch=64),
            feats, feature_embed("feat_test"), 100, 5, oracle, device=cuda)
        expect_launches("base-model-CUB", launches, none)
        steady["base_model_CUB"] = (make_triplet_train_step(
            res.model, res.optimizer, triplet_per_batch=64, alpha=0.2,
            generator=torch.Generator(device=cuda).manual_seed(0)),
            feature_batch)

        res, launches = drive_cub(
            root, "pddm-CUB", pddm_CUB.train,
            cfg("smoke_pddm_CUB", batch_size=64, max_epochs=100), feats,
            feature_embed("att_test", "encoder"), 100, 5, oracle,
            device=cuda)
        expect_launches("pddm-CUB", launches, none)
        # its test embeddings are less separated (val mAP about 0.4), so
        # every loss's hinge is active on a batch of them
        cub_losses_on_card(
            feature_embed("att_test", "encoder")(res).cpu().numpy(),
            feats["label_test"], np.random.RandomState(0))

        for loss, steps in (("triplet", 20), ("batchhard", 10)):
            tag = f"base-CUB-inception-{loss}"
            c = cfg(f"smoke_base_CUB_{loss}", network="inception_v2",
                    batch_size=32, max_epochs=steps, loss=loss)
            res, launches = drive_cub(
                root, tag, base_CUB.train, c, images, image_embed, steps, 5,
                oracle, crop=CUB_CROP, device=cuda)
            want = dict(none)
            if loss == "batchhard":
                want["batch_hard_stats_idx"] = steps
                path = {k: launches[k] for k in BATCH_HARD}
            expect_launches(tag, launches, want)
            if loss == "triplet":
                inception_on_card(res.model, images["image_test"][:8])
            else:
                # K1 at the path's shape (N=32, d=64, bf16) on the trained
                # model's embeddings of a batch, against its plain version
                x, labels, _ = image_batch()
                with torch.no_grad():
                    res.model.eval()
                    e = base_CUB.l2_normalize(res.model(
                        base_CUB.center_crop(x, CUB_CROP)))
                ops, _ = check_inputs("base_CUB-shape", e, labels,
                                      torch.ones(len(labels), device=cuda),
                                      "bf16")
                time_case("base_CUB-shape", ops, "bf16")
            steady[f"base_CUB_{loss}"] = (base_CUB.make_cub_step(
                res.model, res.optimizer, c, CUB_CROP,
                torch.Generator(device=cuda).manual_seed(0)), image_batch)

        # debug mode validates after each of its 2 steps
        _, launches = drive_cub(
            root, "debug-CUB", debug_CUB.train,
            cfg("smoke_debug_CUB", network="inception_v2", batch_size=32,
                max_epochs=20, loss="triplet"),
            images, image_embed, 2, 2, oracle, crop=CUB_CROP, device=cuda)
        expect_launches("debug-CUB", launches, none)
        oracle.finish()
    finally:
        oracle.close()

    times = {tag: cub_steady(tag, step, sample)
             for tag, (step, sample) in steady.items()}
    del steady
    torch.cuda.empty_cache()
    print(f"[cub] steady steps (ms) {json.dumps(times)}; CUB phase "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return path


# ---------------------------------------------------------------------------
# the single-modality pair trainers
# ---------------------------------------------------------------------------

PAIR_SESSIONS = 40
# the PDDM similarity matrix and PairSim's pair probabilities on the card
# against the same model on the CPU: f32 products of widths 8-357 in a
# different order, on probabilities in [0, 1]
PAIR_PROB_TOL = 1e-5
# a mAP or an accuracy recomputed from the CPU's values: a near-tie of the
# card's and the CPU's values may swap one ranking or one decision
PAIR_METRIC_TOL = 1e-3


def write_pair_synthetic(root):
    """The pair trainers' modalities, sensors (8,) and segment (357,), on
    PAIR_SESSIONS sessions x 240 frames (24 train sessions: the pddm
    trainers' --label_num 9 takes 3 batches an epoch of them, the steady
    window all 8)."""
    from multimodal_similarity_tpu_torch.data import generate_synthetic_honda
    t0 = time.time()
    generate_synthetic_honda(root, n_sessions=PAIR_SESSIONS,
                             frames_per_session=240,
                             modal_dims={"sensors": (8,), "segment": (357,)},
                             seed=0)
    print(f"[pair] synthetic sensors / segment dir ({PAIR_SESSIONS} "
          f"sessions x 240 frames) written in {time.time() - t0:.1f} s",
          flush=True)


def pair_cfg(root, name, **kw):
    """scripts/train_pddm.sh:4-13 (RTSN, emb_dim 32, 200 triplets, 3
    sessions a batch, event budget 1000, --label_num 9, Adam, lr 1e-2) and
    scripts/train_pairsim_model.sh, as ``kw`` sets them; 1 epoch."""
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    args = dict(DATA_ROOT=root, name=name, network="rtsn", num_seg=3,
                emb_dim=32, triplet_select="facenet", label_num=9,
                max_epochs=1, static_epochs=750, learning_rate=1e-2,
                triplet_per_batch=200, sess_per_batch=3,
                event_per_batch=1000, optimizer="ADAM", log_flush_every=1)
    args.update(kw)
    return TrainConfig(**args).resolve()


def check_pddm_matrix(tag, res, exp, cfg, vals):
    """The PDDM similarity matrix of the validation set on the card against
    the same model on the CPU (PAIR_PROB_TOL), and the trainer's
    val_mAP_PDDM recomputed from the CPU matrix (PAIR_METRIC_TOL)."""
    import copy

    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.train.trainers.pddm_model import (
        mAP_PDDM, pddm_similarity_matrix)
    sim = pddm_similarity_matrix(res.model, exp.val_feats,
                                 torch.device("cuda"), cfg.normalized)
    sim_cpu = pddm_similarity_matrix(copy.deepcopy(res.model).cpu(),
                                     exp.val_feats, torch.device("cpu"),
                                     cfg.normalized)
    n = exp.val_feats.shape[0]
    err = float(np.max(np.abs(sim - sim_cpu)))
    cpu_map = mAP_PDDM(sim_cpu, exp.val_labels)
    print(f"[{tag}] PDDM matrix [{n}, {n}] card vs CPU max |diff| "
          f"{err:.3g}; val_mAP_PDDM trainer {vals[-1]['val_mAP_PDDM']:.6f},"
          f" from the CPU matrix {cpu_map:.6f}", flush=True)
    if sim.shape != (n, n) or not np.isfinite(sim).all() or \
            err > PAIR_PROB_TOL:
        fail(f"{tag}: the PDDM matrix on the card differs from the CPU's")
    if abs(cpu_map - vals[-1]["val_mAP_PDDM"]) > PAIR_METRIC_TOL:
        fail(f"{tag}: val_mAP_PDDM differs from the CPU matrix's")


def check_pairsim(tag, res, cfg, root):
    """``pairsim_model``'s run: finite losses, hard passes taken, Adam's
    step count = the trainer's steps + its hard passes, and its val_acc
    recomputed on the card and on the CPU from the same fixed pairs."""
    import copy

    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    from multimodal_similarity_tpu_torch.train.trainers.pairsim_model import (
        _pad_pairs, evaluate_pairs, random_pairs)
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    hard = [r["negative_count"] for r in recs if "loss" in r]
    vals = [r["val_acc"] for r in recs if "val_acc" in r]
    adam = {int(s["step"]) for s in res.optimizer.state.values()}
    want_adam = res.step + sum(1 for h in hard if h)
    print(f"[{tag}] {res.step} steps, hard pairs a step {hard}, Adam steps "
          f"{sorted(adam)}, val_acc {vals}", flush=True)
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: no or a non-finite training loss")
    if not sum(hard) or adam != {want_adam}:
        fail(f"{tag}: no hard pass, or Adam took {adam} steps, not "
             f"{want_adam}")
    if len(vals) != cfg.max_epochs:
        fail(f"{tag}: {len(vals)} validations")

    exp = HondaExperiment(cfg, result_dir=os.path.join(root, f"check_{tag}"),
                          limit_label_num=False,
                          val_sessions=cfg.val_session[:3])
    exp.close()
    idx, lab = random_pairs(exp.val_labels, 1_000_000, test=True)
    idx, lab, _ = _pad_pairs(idx, lab, len(lab))
    x = torch.from_numpy(exp.val_feats)
    acc, prob = evaluate_pairs(res.model, x.cuda(), idx, lab,
                               torch.device("cuda"))
    acc_cpu, prob_cpu = evaluate_pairs(copy.deepcopy(res.model).cpu(), x,
                                       idx, lab, torch.device("cpu"))
    err = float(np.max(np.abs(prob - prob_cpu)))
    print(f"[{tag}] {len(lab)} validation pairs: val_acc card {acc:.6f}, "
          f"CPU {acc_cpu:.6f}; probabilities max |diff| {err:.3g}",
          flush=True)
    if abs(acc - vals[-1]) > 1e-9 or err > PAIR_PROB_TOL or \
            abs(acc - acc_cpu) > PAIR_METRIC_TOL:
        fail(f"{tag}: val_acc or the pair probabilities differ")


def pair_phase(root, steady_root):
    """The single-modality pair trainers at the scripts' widths:
    ``pddm_model`` on sensors (RTSN, n_input 8) and on segment (n_input
    357), ``multitask_model`` at ConvRTSN full width on ``root``'s resnet
    maps (emb_dim 128, lambda_ver 0.1, keep_prob 0.5, 200 triplets), and
    ``pairsim_model`` on sensors (emb_dim 128, batch_size 128, one
    negative, hard passes from epoch 0), 1 epoch each, with random
    weights.  Checks finite losses, no launch of any ``csrc/`` kernel, the
    metrics against the NumPy oracle, the PDDM matrix and PairSim's pair
    probabilities on the card against the CPU; then the steady step of
    ``pddm_model`` (sensors) and ``multitask_model``.  Returns the last
    checkpoint of each ``pddm_model`` run by modality, and the
    ``pairsim_model`` run's."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    from multimodal_similarity_tpu_torch.train.trainers import (
        multitask_model, pairsim_model, pddm_model)
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    from multimodal_similarity_tpu_torch.train.trainers._loop import (
        loader_batches)

    t_phase = time.time()
    pair_root = os.path.join(root, "pair")
    write_pair_synthetic(pair_root)
    none = dict.fromkeys(LAUNCHES, 0)
    keys = ("events", "labels", "mask")
    steady, ckpts = {}, {}
    for feat, n_input in (("sensors", 8), ("segment", 357)):
        tag = f"pddm-{feat}"
        cfg = pair_cfg(pair_root, f"smoke_{tag}", feat=feat, n_input=n_input)
        res, launches, _, exp, _, _ = drive_trainer(
            pair_root, tag, pddm_model.train, cfg, expect_val_loss=False,
            encoder=lambda m: m.encoder)
        expect_launches(tag, launches, none)
        ckpts[feat] = os.path.join(res.result_dir,
                                   f"{cfg.name}.ckpt-{res.step}")
        vals = [json.loads(line) for line in
                open(os.path.join(res.result_dir, "metrics.jsonl"))]
        check_pddm_matrix(tag, res, exp, cfg,
                          [r for r in vals if "val_mAP_PDDM" in r])
        if feat == "sensors":
            # all 24 train sessions: 8 batches an epoch
            exp = HondaExperiment(
                pair_cfg(pair_root, "steady_pddm", feat=feat,
                         n_input=n_input, label_num=93),
                result_dir=os.path.join(pair_root, "r_steady_pddm"))
            exp.close()
            step = pddm_model.make_pddm_step(
                res.model, res.optimizer, cfg,
                torch.Generator(device="cuda").manual_seed(0))
            steady["pddm_model"] = (cfg, step, loader_batches(exp))

    kw = {"lambda_ver": 0.1, "triplet_select": "facenet",
          "triplet_per_batch": 200, "max_epochs": 1}
    cfg = full_width_cfg(root, "smoke_multitask", **kw)
    res, launches, _, _, _, _ = drive_trainer(
        root, "multitask", multitask_model.train, cfg, expect_val_loss=False,
        encoder=lambda m: m.encoder)
    expect_launches("multitask", launches, none)
    step = multitask_model.make_multitask_step(
        res.model, res.optimizer, cfg,
        torch.Generator(device="cuda").manual_seed(0))
    steady["multitask_model"] = (cfg, step, loader_batches(
        steady_experiment(steady_root, "multitask", **kw)))

    cfg = pair_cfg(pair_root, "smoke_pairsim", feat="sensors", n_input=8,
                   emb_dim=128, batch_size=128, num_negative=1,
                   negative_epochs=0, static_epochs=500)
    reset_launch_counts()
    t0 = time.time()
    res = pairsim_model.train(
        cfg, result_dir=os.path.join(pair_root, "result_pairsim"))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"[pairsim] trained in {time.time() - t0:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    expect_launches("pairsim", launches, none)
    check_pairsim("pairsim", res, cfg, pair_root)
    pairsim_ckpt = os.path.join(res.result_dir,
                                f"{cfg.name}.ckpt-{res.step}")
    del res

    times = {}
    for tag, (cfg, step, source) in steady.items():
        times[tag] = steady_step(
            tag, cfg, keys,
            lambda b, step=step, lr=cfg.learning_rate: step(
                b["events"], b["labels"], b["mask"], lr), source)
    del steady
    torch.cuda.empty_cache()
    print(f"[pair] steady state (s a loader draw) {json.dumps(times)}; pair "
          f"phase {time.time() - t_phase:.1f} s", flush=True)
    return ckpts, pairsim_ckpt


# ---------------------------------------------------------------------------
# the multimodal flagship
# ---------------------------------------------------------------------------

MM_FEATS = "resnet,sensors,segment"
MM_MODALITIES = {"sensors": (8,), "segment": (357,)}
# the scaled runs' PDDM output layers: weights x PDDM_SCALE, the
# similar-class bias moved by PDDM_SHIFT, as tests/test_torch_multimodal.py
# sets them; the pseudo-similarities then spread over [0, 1], where
# one-epoch branches keep them near 0.5 and no far negative (under 0.2)
# exists
PDDM_SCALE, PDDM_SHIFT = 100.0, -3.0
# the steady windows' directory: 12 train, 1 validation and 1 test session
# of FULL_EVENTS events each, so 3 sessions hold 1020 real events and the
# loader subsamples them to the 1000-event budget
FULL_SESSIONS, FULL_EVENTS = (12, 1, 1), 340
# their windows: the loader takes seconds a batch there
FULL_WARM, FULL_DRAWS = 2, 8
# the directory's resnet frames: base_model's width
FULL_RESNET = (8, 8, 1536)


def add_modalities(root):
    """Write sensors (8,) and segment (357,) features beside the resnet
    maps of a synthetic Honda directory, for its sessions and frame labels
    (class centres plus unit noise, seed 1), so that the directory holds
    the flagship's three modalities.  Returns the bytes written."""
    import pickle

    import numpy as np
    from multimodal_similarity_tpu_torch.data import MODALITY_SUFFIX
    t0 = time.time()
    rng = np.random.RandomState(1)
    centers = {m: rng.randn(11, dim[0]) for m, dim in MM_MODALITIES.items()}
    with open(os.path.join(root, "all_session.txt")) as f:
        sessions = f.read().split()
    written = 0
    for sess in sessions:
        with open(os.path.join(root, "labels", f"{sess}_goal.pkl"),
                  "rb") as f:
            frame_labels = pickle.load(f)["label"]
        for m, (dim,) in MM_MODALITIES.items():
            feats = (centers[m][frame_labels]
                     + rng.randn(len(frame_labels), dim)).astype(np.float32)
            np.save(os.path.join(root, "features",
                                 sess + MODALITY_SUFFIX[m]), feats)
            written += feats.nbytes
    print(f"[multimodal] sensors (8,) and segment (357,) features of "
          f"{len(sessions)} sessions written beside the resnet maps of "
          f"{root}: {written} bytes in {time.time() - t0:.2f} s", flush=True)
    return written


def write_full_budget(root):
    """A Honda directory whose 3-session batches fill the flagship's
    1000-event budget with real events: FULL_SESSIONS (train, validation,
    test) sessions of FULL_EVENTS foreground events (raw labels 1-10) of
    MIN_LENGTH + 1 frames, the shortest the loader keeps, each frame a
    resnet 8x8x1536 map, sensors (8,) and segment (357,) features: class
    centres plus unit-normal noise (seed 2).  A resnet frame's noise is
    one of 256 maps drawn once, so that writing costs a gather and an add a
    frame.  Returns the bytes written."""
    import pickle

    import numpy as np
    from multimodal_similarity_tpu_torch.data import (
        MIN_LENGTH, MODALITY_SUFFIX)
    from numpy.lib.format import open_memmap
    t0 = time.time()
    rng = np.random.RandomState(2)
    dims = {"resnet": FULL_RESNET, **MM_MODALITIES}
    centers = {m: rng.randn(11, *d).astype(np.float32)
               for m, d in dims.items()}
    pool = rng.randn(256, *dims["resnet"]).astype(np.float32)
    length = MIN_LENGTH + 1
    sessions = [f"2018{i:08d}" for i in range(sum(FULL_SESSIONS))]
    for sub in ("features", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    written = 0
    for sess in sessions:
        raw = rng.randint(1, 11, size=FULL_EVENTS)
        frame_labels = np.repeat(raw, length)
        frames = frame_labels.shape[0]
        feat = os.path.join(root, "features", sess)
        out = open_memmap(feat + MODALITY_SUFFIX["resnet"], mode="w+",
                          dtype=np.float32,
                          shape=(frames,) + dims["resnet"])
        for i in range(0, frames, 256):
            lab = frame_labels[i:i + 256]
            out[i:i + len(lab)] = (centers["resnet"][lab]
                                   + pool[rng.randint(256, size=len(lab))])
        out.flush()
        written += out.nbytes
        del out
        for m, dim in MM_MODALITIES.items():
            feats = (centers[m][frame_labels]
                     + rng.randn(frames, *dim)).astype(np.float32)
            np.save(feat + MODALITY_SUFFIX[m], feats)
            written += feats.nbytes
        with open(os.path.join(root, "labels", f"{sess}_goal.pkl"),
                  "wb") as f:
            pickle.dump({"label": frame_labels,
                         "s": np.arange(0, frames + 1, length),
                         "G": raw}, f)
    n_train, n_val, _ = FULL_SESSIONS
    for split, ids in (("all", sessions), ("train", sessions[:n_train]),
                       ("val", sessions[n_train:n_train + n_val]),
                       ("test", sessions[n_train + n_val:])):
        with open(os.path.join(root, f"{split}_session.txt"), "w") as f:
            f.write("\n".join(ids))
    print(f"[multimodal] full-budget directory: {len(sessions)} sessions "
          f"of {FULL_EVENTS} events of {length} frames (resnet 8x8x1536, "
          f"sensors (8,), segment (357,)), {written} bytes written in "
          f"{time.time() - t0:.2f} s", flush=True)
    return written


def scaled_branches(ckpts, out_dir):
    """Copies of the ``pddm_model`` checkpoints ``ckpts`` with each PDDM
    output layer's weights times PDDM_SCALE and its similar-class bias
    moved by PDDM_SHIFT."""
    import torch
    out = {}
    for feat, path in ckpts.items():
        saved = torch.load(path, map_location="cpu", weights_only=True)
        model = saved["model"]
        model["pddm.score.s.weight"] = (model["pddm.score.s.weight"]
                                        * PDDM_SCALE)
        model["pddm.score.s.bias"] = (model["pddm.score.s.bias"]
                                      + torch.tensor([0.0, PDDM_SHIFT]))
        out[feat] = os.path.join(out_dir, f"scaled_{feat}.ckpt")
        torch.save(saved, out[feat])
    return out


def mm_cfg(root, name, ckpts, **kw):
    """scripts/train_multimodal_model.sh: full_width_cfg's ConvRTSN,
    lambda_multimodal 0.1 from epoch 0, budget 1000, 3 sessions a batch,
    200 triplets, 5 negatives, --label_num 9, --no_joint,
    --multimodal_select random, the branches from ``ckpts``; 1 epoch."""
    args = dict(feat=MM_FEATS, lambda_multimodal=0.1, multimodal_epochs=0,
                num_negative=5, triplet_per_batch=200, label_num=9,
                max_epochs=1, no_joint=True, multimodal_select="random",
                sensors_path=ckpts["sensors"], segment_path=ckpts["segment"])
    args.update(kw)
    return full_width_cfg(root, name, **args)


def mm_experiment(root, tag, cfg, modalities):
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    exp = HondaExperiment(cfg, modalities=modalities,
                          result_dir=os.path.join(root, f"r_{tag}"),
                          supports_int8=True)
    exp.close()
    return exp


def check_mm_records(tag, res, multimodal, structure=False):
    """On a flagship path, the run's triplet, hard and structure counts a
    step, and hard triplets in the run (and structure triplets, where
    ``structure``).  Returns the structure counts."""
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    if not multimodal:
        return []
    counts = {k: [r[k] for r in steps]
              for k in ("triplet_count", "hard_count", "struct_count")}
    print(f"[{tag}] per step {json.dumps(counts)}", flush=True)
    if not sum(counts["hard_count"]):
        fail(f"{tag}: no hard triplet in the run")
    if structure and not sum(counts["struct_count"]):
        fail(f"{tag}: no structure triplet in the run")
    return counts["struct_count"]


def check_mm_similarity_and_miner(models, cfg, exp):
    """On one loader batch of ``exp``, for each trained flagship model of
    ``models`` (name -> (model, tolerance)): the fused PDDM similarity on
    the card against the CPU (within its tolerance), and the row-wise hard
    + structure miner on the card against the CPU on that similarity, the
    batch's labels and mask and the same Gumbel draws, index-equal; then
    the miner so on a symmetric uniform similarity.  Returns each
    similarity's range over the batch's real events."""
    import copy

    import torch
    from multimodal_similarity_tpu_torch.ops import mining
    from multimodal_similarity_tpu_torch.train.trainers import (
        multimodal_model)

    batches = exp.loader.epoch(max_batches=1)
    try:
        batch = next(batches)
    finally:
        batches.close()
    n = int(batch["num_events"])
    x2, x3 = (torch.from_numpy(batch[k]) for k in ("events2", "events3"))
    sims, ranges = [], {}
    for name, (model, tol) in models.items():
        sim = multimodal_model.fused_similarity(model, x2.cuda(), x3.cuda())
        sim_cpu = multimodal_model.fused_similarity(
            copy.deepcopy(model).cpu(), x2, x3)
        err = float((sim.cpu() - sim_cpu).abs().max())
        real = sim[:n, :n]
        lo, hi = ranges[name] = (float(real.min()), float(real.max()))
        print(f"[multimodal] {name} PDDM similarity [{sim.shape[0]}, "
              f"{sim.shape[1]}] card vs CPU max |diff| {err:.3g} (tolerance "
              f"{tol:g}); range over the {n} real events [{lo:.6f}, "
              f"{hi:.6f}], under 0.2: "
              f"{float((real < 0.2).float().mean()):.4f}, over 0.8: "
              f"{float((real > 0.8).float().mean()):.4f}", flush=True)
        if not bool(torch.isfinite(sim).all()) or err > tol:
            fail(f"multimodal: the {name} PDDM similarity on the card "
                 "differs from the CPU's")
        sims.append((name, sim))

    hard, struct = cfg.triplet_per_batch, cfg.triplet_per_batch // 2
    labels = torch.from_numpy(batch["labels"]).cuda()
    mask = torch.from_numpy(batch["mask"]).cuda()
    margins = torch.rand(8, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    spread = torch.rand(sims[0][1].shape, generator=gen, device="cuda")
    real_draw = mining._draw_structure_gumbels
    for name, s in sims + [("uniform", 0.5 * (spread + spread.T))]:
        draws = real_draw(hard, struct, s.shape[0], gen,
                          torch.device("cuda"))
        outs = []
        try:
            for dev in (torch.device("cuda"), torch.device("cpu")):
                mining._draw_structure_gumbels = (
                    lambda *a, dev=dev: tuple(g.to(dev) for g in draws))
                outs.append(mining.mine_hard_structure_triplets_rowwise(
                    lambda rows, s=s.to(dev): s[rows], labels.to(dev),
                    margins.to(dev), None, hard, struct, 0.8, 0.2,
                    valid=mask.to(dev)))
        finally:
            mining._draw_structure_gumbels = real_draw
        for field in outs[0]._fields:
            if not torch.equal(getattr(outs[0], field).cpu(),
                               getattr(outs[1], field)):
                fail(f"multimodal: the structure miner's {field} on the "
                     f"{name} similarity differs between card and CPU")
        print(f"[multimodal] structure miner on the {name} similarity, "
              f"card vs CPU index-equal: {int(outs[1].hard_mask.sum())} "
              f"hard and {int(outs[1].struct_mask.sum())} structure "
              f"triplets of {hard} / {struct}", flush=True)
    return ranges


def multimodal_phase(root, ckpts):
    """The multimodal flagship at the width of
    scripts/train_multimodal_model.sh, 1 epoch each with random core
    weights and the branches of phase 13's ``pddm_model`` checkpoints
    (``ckpts``): ``multimodal_model`` on the host miners, with
    --device_mining (f32, and --int8_features), the hard-only ablation and
    the weak trainer (--multimodal_select confidence, resnet and sensors);
    then the host path and --device_mining with the branches' PDDM output
    layers scaled, so that the structure term fires.  Checks finite
    losses, hard triplets on every flagship path and structure triplets on
    the scaled ones, no ``csrc/`` launch, the metrics against the NumPy
    oracle, the fused similarity and the structure miner card vs CPU; then
    the steady step of the host path and of --device_mining on a
    directory whose batches fill the event budget.  Returns that
    directory (phase 15 reads it too, and removes it)."""
    import random

    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES
    from multimodal_similarity_tpu_torch.train.steps import (
        embed_in_chunks, make_embed_fn)
    from multimodal_similarity_tpu_torch.train.trainers import (
        multimodal_model, multimodal_model_hardonly, multimodal_model_weak)
    from multimodal_similarity_tpu_torch.train.trainers._loop import (
        loader_batches)

    t_phase = time.time()
    add_modalities(root)
    scaled = scaled_branches(ckpts, root)
    none = dict.fromkeys(LAUNCHES, 0)
    mm = multimodal_model.train
    device_mining = functools.partial(mm, device_mining=True)
    runs = (
        # tag, trainer, config, branches
        ("mm-host", mm, {}, ckpts),
        ("mm-device", device_mining, {}, ckpts),
        ("mm-device-int8", device_mining, {"int8_features": True}, ckpts),
        ("mm-hardonly", multimodal_model_hardonly.train, {}, ckpts),
        ("mm-weak", multimodal_model_weak.train,
         {"feat": "resnet,sensors", "multimodal_select": "confidence"},
         ckpts),
        ("mm-host-struct", mm, {}, scaled),
        ("mm-device-struct", device_mining, {}, scaled))
    structs, trained = {}, {}
    for tag, train_fn, kw, branches in runs:
        cfg = mm_cfg(root, f"smoke_{tag}", branches, **kw)
        res, launches, _, _, _, _ = drive_trainer(
            root, tag, train_fn, cfg, expect_val_loss=False,
            encoder=lambda m: m["modality_core"])
        expect_launches(tag, launches, none)
        structs[tag] = check_mm_records(tag, res, tag != "mm-weak",
                                        structure=branches is scaled)
        if tag in ("mm-host", "mm-device", "mm-device-struct"):
            trained[tag] = (res, cfg, branches)
        del res

    modalities = MM_FEATS.split(",")
    cfg = trained["mm-device"][1]
    ranges = check_mm_similarity_and_miner(
        {"fused": (trained["mm-device"][0].model, PAIR_PROB_TOL),
         # the scaled output layer scales the logits' rounding differences
         "fused-scaled": (trained.pop("mm-device-struct")[0].model,
                          PAIR_PROB_TOL * PDDM_SCALE)},
        cfg, mm_experiment(root, "mm-check", cfg, modalities))
    print(f"[multimodal] structure triplets a run: "
          f"{json.dumps({k: sum(v) for k, v in structs.items()})}; fused "
          f"similarity ranges {json.dumps(ranges)}", flush=True)

    # steady state on batches that fill the budget; the directory is
    # phase 15's too, which removes it
    full_root = os.path.join(root, "full")
    write_full_budget(full_root)
    times = {}
    device = torch.device("cuda")
    for tag in ("mm-host", "mm-device"):
        res, cfg, branches = trained.pop(tag)
        exp = mm_experiment(full_root, f"steady-{tag}",
                            mm_cfg(full_root, f"steady_{tag}", branches,
                                   label_num=93), modalities)
        lr = cfg.learning_rate
        if tag == "mm-host":
            dist_dict = multimodal_model.init_dist_dict(
                embed_in_chunks(make_embed_fn(res.model["modality_core"]),
                                exp.val_feats, device),
                exp.val_labels, cfg.metric)
            run = multimodal_model.make_host_step(
                res.model, res.optimizer, cfg, device, dist_dict,
                random.Random(0), np.random.RandomState(0))
            keys = ("events", "events2", "events3")

            def step(b, run=run):
                return run(b, lr)
        else:
            fused = multimodal_model.make_mm_fused_step(
                res.model, res.optimizer, cfg,
                torch.Generator(device="cuda").manual_seed(0))
            cm = multimodal_model.margin_table({0: [0.5]}, device)
            keys = ("events", "events2", "events3", "labels", "mask")

            def step(b, fused=fused, cm=cm):
                return fused(b["events"], b["events2"], b["events3"],
                             b["labels"], b["mask"], cm, 1.0, lr)
        times[tag] = steady_step(tag, cfg, keys, step, loader_batches(exp),
                                 FULL_WARM, FULL_DRAWS)
        del res, step, exp
    torch.cuda.empty_cache()
    print(f"[multimodal] steady state (s a loader draw) "
          f"{json.dumps(times)}; multimodal phase "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return full_root


# ---------------------------------------------------------------------------
# slice 6a: DCCA, cross-prediction, hallucination, classifier, evaluation
# ---------------------------------------------------------------------------

# the DCCA loss on the card against the CPU, both in f32 on the same
# embeddings: the value within DCCA_VALUE_RTOL; each gradient within
# DCCA_GRAD_RTOL of its largest entry, or within 4x the CPU's own f32 error
# against float64 where that is larger (eigh's gradient divides by
# eigenvalue gaps, so a near-degenerate covariance makes the f32 gradient
# ill-conditioned in either place); in float64, card and CPU within
# DCCA_F64_RTOL (value) and DCCA_GRAD_RTOL (gradients)
DCCA_VALUE_RTOL, DCCA_GRAD_RTOL, DCCA_F64_RTOL = 1e-4, 1e-3, 1e-6
# the evaluation CLIs' embeddings on the card against the CPU's, both f32
# with TF32 off: the largest difference within EVAL_EMB_RTOL of the CPU
# embeddings' largest entry (a 1536-deep reduction summed in another order)
EVAL_EMB_RTOL = 1e-4
# phase 15's full-budget windows: fewer draws than the flagship's (the
# loader takes about 3.8 s a draw there)
SLICE6_WARM, SLICE6_DRAWS = 2, 5


def slice6_cfg(root, name, ckpts, **kw):
    """scripts/train_multitask_dcca.sh, train_multitask_crosspredict.sh,
    train_hallucination.sh, train_cross_prediction.sh and
    train_base_classifier.sh as ``kw`` sets them, at full_width_cfg's
    ConvRTSN width (lambda_multimodal 0.1 from epoch 0, 200 triplets,
    keep_prob 0.5, Adam 1e-2), the branches from ``ckpts``; 1 epoch."""
    args = dict(feat=MM_FEATS, lambda_multimodal=0.1, multimodal_epochs=0,
                triplet_per_batch=200, label_num=9, max_epochs=1,
                sensors_path=ckpts["sensors"], segment_path=ckpts["segment"])
    args.update(kw)
    return full_width_cfg(root, name, **args)


def slice6_records(tag, res, keys):
    """The run's step records: each of ``keys`` logged and finite at every
    step.  Returns {key: [values]}."""
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    cols = {k: [r.get(k, math.nan) for r in steps] for k in keys}
    print(f"[{tag}] per step " + json.dumps(
        {k: [round(v, 6) for v in vals] for k, vals in cols.items()}),
        flush=True)
    for k, vals in cols.items():
        if not vals or not all(math.isfinite(v) for v in vals):
            fail(f"{tag}: no or a non-finite {k}")
    return cols


def drive_plain(root, tag, train_fn, cfg, keys):
    """A trainer run without a retrieval validation, launch counts set to
    0 just before it and read just after; finite ``keys`` at every step.
    Returns (result, launches, step columns)."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    reset_launch_counts()
    t0 = time.time()
    res = train_fn(cfg, result_dir=os.path.join(root, f"result_{tag}"))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"[{tag}] {res.step} steps in {time.time() - t0:.1f} s; metrics "
          f"{json.dumps(res.metrics)}; launches {json.dumps(launches)}",
          flush=True)
    if res.step < 1:
        fail(f"{tag}: the trainer took no step")
    return res, launches, slice6_records(tag, res, keys)


def slice6_step_times(runs, batch, iters=5):
    """Each trainer's step alone on inputs already on the card, from the
    full-budget loader batch ``batch``: ``multitask_dcca`` (the trainer's
    1200 triplet rows, 200 triplets active, and 600 unsupervised rows of
    three modalities), ``modality_hallucination`` (1200 rows of three
    modalities) and ``cross_prediction`` (the 1000-event budget and its
    mean-pooled sensors); ms a step from CUDA events around ``iters``
    steps back to back after 2, the host's waits (cuSOLVER's) included."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.train.trainers import (
        cross_prediction, modality_hallucination, multitask_dcca)
    n = int(batch["num_events"])
    x, x2, x3 = (torch.from_numpy(batch[k]).cuda()
                 for k in ("events", "events2", "events3"))
    out = {}
    res, cfg = runs["dcca"]
    tri_cap = 2 * cfg.triplet_per_batch
    rs = np.random.RandomState(0)
    tri = torch.from_numpy(rs.randint(0, n, 3 * tri_cap)).cuda()
    mask = torch.zeros(tri_cap, device=x.device)
    mask[: cfg.triplet_per_batch] = 1.0
    u = torch.from_numpy(rs.permutation(n)[:3 * cfg.triplet_per_batch]).cuda()
    step = multitask_dcca.make_dcca_step(res.model, res.optimizer, cfg)
    out["dcca"] = call_ms(lambda: step(
        x[tri], mask, x[u], x2[u], x3[u], cfg.lambda_multimodal,
        cfg.learning_rate), iters=iters, warmup=2)
    res, cfg = runs["hallucination"]
    step = modality_hallucination.make_hallucination_step(
        res.model, res.optimizer, cfg)
    out["hallucination"] = call_ms(lambda: step(
        x[tri], x2[tri], x3[tri], mask, cfg.learning_rate), iters=iters,
        warmup=2)
    res, cfg = runs["cross"]
    step = cross_prediction.make_regression_step(res.model, res.optimizer,
                                                 cfg)
    # the mean-pooled sensors target of each event: its TSN segments'
    # mean here (the loader pools the whole window; the shape is the same)
    target = x2.mean(dim=1)
    valid = torch.from_numpy(batch["mask"]).cuda()
    out["cross"] = call_ms(lambda: step(x, target, valid, cfg.learning_rate),
                           iters=iters, warmup=2)
    print(f"[slice6] steps alone on the card (ms a step, CUDA events around "
          f"{iters} steps back to back) {json.dumps(out)}", flush=True)
    return out


def slice6_experiment(root, tag, ckpts):
    """``multitask_dcca``'s experiment on ``root``: three modalities, all
    train sessions, the first --label_num 9 labeled."""
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    exp = HondaExperiment(slice6_cfg(root, f"smoke_{tag}", ckpts),
                          modalities=MM_FEATS.split(","),
                          result_dir=os.path.join(root, f"r_{tag}"),
                          limit_label_num=False)
    exp.close()
    return exp


def first_batch(exp):
    batches = exp.loader.epoch(max_batches=1)
    try:
        return next(batches)
    finally:
        batches.close()


def check_dcca_on_card(model, cfg, batch):
    """``dcca_loss`` of the trained core's unsupervised embeddings (the
    trainer's 3 x triplet_per_batch events of the loader batch ``batch``,
    eval mode) against the frozen sensors and segment towers' on the card
    and on the CPU: value and gradients (DCCA_* tolerances), and its time
    on the card, forward and backward."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.ops.losses import dcca_loss
    from multimodal_similarity_tpu_torch.train.steps import (
        embed_in_chunks, make_embed_fn)

    cap = min(3 * cfg.triplet_per_batch, cfg.event_per_batch)
    perm = np.random.RandomState(0).permutation(int(batch["num_events"]))[
        :cap]
    device = torch.device("cuda")
    emb_u = embed_in_chunks(make_embed_fn(model["modality_core"],
                                          cfg.normalized),
                            batch["events"][perm], device)
    deltas, times = {}, {}
    for scope in ("modality_sensors", "modality_segment"):
        emb_b = embed_in_chunks(make_embed_fn(model[scope], cfg.normalized),
                                batch[{"modality_sensors": "events2",
                                       "modality_segment": "events3"}[scope]]
                                [perm], device)
        out = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cuda", torch.float64), ("cpu", torch.float64)):
            a, b = (x.to(dev, dtype, copy=True).requires_grad_()
                    for x in (emb_u, emb_b))
            v = dcca_loss(a, b)
            v.backward()
            out[dev, dtype] = (float(v.detach()), a.grad.cpu().double(),
                               b.grad.cpu().double())
        card, cpu = out["cuda", torch.float32], out["cpu", torch.float32]
        ref = out["cpu", torch.float64]
        c64 = out["cuda", torch.float64]

        def rel(x, y):
            return float((x - y).abs().max() / y.abs().max())

        d = {"value": abs(card[0] - cpu[0]) / abs(cpu[0]),
             "grad_core": rel(card[1], cpu[1]),
             "grad_branch": rel(card[2], cpu[2]),
             "cpu_f32_vs_f64": [rel(cpu[1], ref[1]), rel(cpu[2], ref[2])],
             "f64_value": abs(c64[0] - ref[0]) / abs(ref[0]),
             "f64_grads": [rel(c64[1], ref[1]), rel(c64[2], ref[2])]}
        deltas[scope] = d
        print(f"[dcca] {scope}: [{cap}, {emb_u.shape[1]}] against "
              f"[{cap}, {emb_b.shape[1]}]: value card {card[0]:.6f}, CPU "
              f"{cpu[0]:.6f}; deltas {json.dumps(d)}", flush=True)
        finite = all(bool(torch.isfinite(g).all()) for g in card[1:])
        if finite != all(bool(torch.isfinite(g).all()) for g in cpu[1:]):
            fail(f"dcca: {scope} gradients finite on one side only")
        if not finite or not -64 <= card[0] < 0:
            fail(f"dcca: {scope} value {card[0]} or its gradient not "
                 "finite or out of range")
        if d["value"] > DCCA_VALUE_RTOL:
            fail(f"dcca: {scope} value differs between card and CPU")
        for name, cpu_err in zip(("grad_core", "grad_branch"),
                                 d["cpu_f32_vs_f64"]):
            if d[name] > max(DCCA_GRAD_RTOL, 4 * cpu_err):
                fail(f"dcca: {scope} {name} differs between card and CPU")
        if d["f64_value"] > DCCA_F64_RTOL or \
                max(d["f64_grads"]) > DCCA_GRAD_RTOL:
            fail(f"dcca: {scope} float64 card and CPU differ")

        a = emb_u.clone().requires_grad_()

        def fwd_bwd(a=a, b=emb_b):
            dcca_loss(a, b).backward()

        times[scope] = call_ms(fwd_bwd)
    print(f"[dcca] forward + backward on the card (ms a call: CUDA events "
          f"around 20 calls back to back, the host's waits for cuSOLVER "
          f"included) {json.dumps(times)}", flush=True)
    return deltas, times


def check_classifier_accuracy(res, cfg, root):
    """The classifier's val_accuracy against the NumPy oracle: the share of
    validation events whose card logits' argmax is the label."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    exp = HondaExperiment(cfg, result_dir=os.path.join(root,
                                                        "check_classifier"))
    exp.close()
    model = res.model.eval()
    with torch.no_grad():
        logits = torch.cat([model(torch.from_numpy(
            exp.val_feats[i:i + 256]).cuda())[1]
            for i in range(0, exp.val_feats.shape[0], 256)]).cpu().numpy()
    acc = float(np.mean(np.argmax(logits, -1) == exp.val_labels.reshape(-1)))
    print(f"[classifier] val_accuracy trainer {res.metrics['val_accuracy']}"
          f", NumPy oracle on the card's logits {acc}", flush=True)
    if logits.shape != (exp.val_feats.shape[0], 7) or \
            not np.isfinite(logits).all() or \
            acc != res.metrics["val_accuracy"]:
        fail("classifier: val_accuracy differs from the oracle's")


def check_eval_clis(root, runs, ckpts):
    """``evaluate_model`` (the multitask_dcca core, and --use_output on the
    classifier) and ``evaluate_late_fusion`` (phase 13's sensors
    checkpoint, and --use_output on the cross_prediction checkpoint) on the
    card and on the CPU, over the test session of ``root``: the embeddings
    within EVAL_EMB_RTOL, mAP and Recall@1 within PAIR_METRIC_TOL."""
    import numpy as np
    from multimodal_similarity_tpu_torch.configs import EvalConfig
    from multimodal_similarity_tpu_torch.eval import (
        evaluate_late_fusion, evaluate_model)

    def ckpt(tag):
        res, cfg = runs[tag]
        return os.path.join(res.result_dir, f"{cfg.name}.ckpt-{res.step}")

    def widths(tag):
        cfg = runs[tag][1]
        return {k: getattr(cfg, k) for k in ("network", "num_seg", "emb_dim",
                                             "n_input", "n_h", "n_w", "n_C")}

    core = dict(model_path=ckpt("dcca"), variable_name="modality_core",
                **widths("dcca"))
    cases = {
        "evaluate_model": (evaluate_model, dict(core)),
        "evaluate_model-use_output": (evaluate_model, dict(
            model_path=ckpt("classifier"), use_output=True,
            **widths("classifier"))),
        "late_fusion-sensors": (evaluate_late_fusion, dict(
            core, feat="resnet,sensors", sensors_path=ckpts["sensors"])),
        "late_fusion-use_output": (evaluate_late_fusion, dict(
            core, feat="resnet,sensors", sensors_path=ckpt("cross"),
            use_output=True)),
    }
    out = {}
    for tag, (module, kw) in cases.items():
        got, emb = {}, {}
        for dev in ("cuda", "cpu"):
            cfg = EvalConfig(DATA_ROOT=root, device=dev, **kw).resolve()
            t0 = time.time()
            r = module.run(cfg)
            got[dev] = (r["mAP"], r["recall"][0], time.time() - t0)
            emb[dev] = r["embeddings"]
        err = float(np.abs(emb["cuda"] - emb["cpu"]).max()
                    / np.abs(emb["cpu"]).max())
        out[tag] = {**got, "events": emb["cpu"].shape[0], "emb_err": err}
        print(f"[eval] {tag}: {emb['cpu'].shape[0]} test events, embeddings "
              f"{emb['cpu'].shape[1]} wide; (mAP, Recall@1, s) card "
              f"{got['cuda']}, CPU {got['cpu']}; embeddings card vs CPU "
              f"{err:.3g} of their scale", flush=True)
        if emb["cuda"].shape != emb["cpu"].shape or \
                not np.isfinite(emb["cuda"]).all() or err > EVAL_EMB_RTOL:
            fail(f"eval: {tag} embeddings on the card differ from the CPU")
        if not all(math.isfinite(v) for v in got["cuda"][:2]) or any(
                abs(a - b) > PAIR_METRIC_TOL
                for a, b in zip(got["cuda"][:2], got["cpu"][:2])):
            fail(f"eval: {tag} on the card differs from the CPU")
    return out


def slice6_phase(root, ckpts, full_root):
    """Slice 6a at the scripts' widths, 1 epoch each with random weights on
    phase 14's three-modality directory: ``multitask_dcca`` and
    ``multitask_cross_prediction`` (--label_num 9, the frozen towers
    restored from phase 13's ``pddm_model`` checkpoints),
    ``modality_hallucination`` and ``modality_hallucination_weak``
    (--label_num 93, keep_prob 0.5 on every branch), ``cross_prediction``
    (resnet -> mean-pooled sensors) and ``base_model_classifier`` (ConvTSN,
    emb_dim 256, 7 outputs).  Checks finite losses, the DCCA term in [-64,
    0), the MSE and hallucination terms positive, the frozen towers
    unchanged and the core moved, no ``csrc/`` launch, val mAP and val
    accuracy against the NumPy oracle, ``dcca_loss`` card vs CPU on the
    trained core's unsupervised embeddings, and the two evaluation CLIs on
    the card against the CPU on the checkpoints just written, over the
    test session of ``full_root``; then the
    steady step of ``multitask_dcca``, ``modality_hallucination`` and
    ``cross_prediction`` on ``full_root`` (batches of 1000 real events),
    which phase 16 reads next.  Returns the ``modality_hallucination``
    checkpoint (phase 17 serves its core)."""
    import random

    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.data import mean_pool_input
    from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_classifier, cross_prediction, modality_hallucination,
        modality_hallucination_weak, multitask_cross_prediction,
        multitask_dcca)
    from multimodal_similarity_tpu_torch.train.trainers._loop import (
        loader_batches)

    t_phase = time.time()
    none = dict.fromkeys(LAUNCHES, 0)
    device = torch.device("cuda")
    runs = {}
    frozen = ("modality_sensors", "modality_segment")
    for tag, train_fn, mse in (("dcca", multitask_dcca.train, False),
                               ("crosspredict",
                                multitask_cross_prediction.train, True)):
        cfg = slice6_cfg(root, f"smoke_{tag}", ckpts)
        res, launches, _, _, _, _ = drive_trainer(
            root, tag, train_fn, cfg, expect_val_loss=False,
            encoder=lambda m: m["modality_core"])
        expect_launches(tag, launches, none)
        mul = slice6_records(tag, res, ("metric_loss", "mul_loss"))[
            "mul_loss"]
        if not all((v > 0) if mse else (-64 <= v < 0) for v in mul):
            fail(f"{tag}: mul_loss {mul} out of range")
        init = multitask_dcca.build_model(cfg, device, 8, 357, mse)
        for scope, feat in zip(frozen, ("sensors", "segment")):
            saved = torch.load(ckpts[feat], map_location="cuda",
                               weights_only=True)["model"]
            for k, v in res.model[scope].state_dict().items():
                if not torch.equal(v, saved["encoder." + k]):
                    fail(f"{tag}: frozen {scope}.{k} moved")
        scopes = ("modality_core",) + (("modality_core_heads",) if mse
                                       else ())
        for scope in scopes:
            if all(torch.equal(a, b) for a, b in zip(
                    res.model[scope].parameters(),
                    init[scope].parameters())):
                fail(f"{tag}: {scope} did not move")
        if not all(bool(torch.isfinite(p).all())
                   for p in res.model.parameters()):
            fail(f"{tag}: a non-finite parameter after training")
        runs[tag] = (res, cfg)
        del init
    # on a full-budget batch: 600 distinct events, as in the trainer's
    # steps on real sessions
    full_batch = first_batch(slice6_experiment(full_root, "check", ckpts))
    dcca_deltas, dcca_ms = check_dcca_on_card(
        runs["dcca"][0].model, runs["dcca"][1], full_batch)

    for tag, train_fn, feat in (
            ("hallucination", modality_hallucination.train, MM_FEATS),
            ("hallucination-weak", modality_hallucination_weak.train,
             "resnet,sensors")):
        cfg = slice6_cfg(root, f"smoke_{tag}", ckpts, feat=feat,
                         label_num=93, sensors_path=None, segment_path=None)
        res, launches, _, _, _, _ = drive_trainer(
            root, tag, train_fn, cfg, expect_val_loss=False,
            encoder=lambda m: m["modality_core"])
        expect_launches(tag, launches, none)
        hal = slice6_records(tag, res, ("metric_loss", "hal_loss"))[
            "hal_loss"]
        if not all(v > 0 for v in hal):
            fail(f"{tag}: hal_loss {hal} not positive")
        runs[tag] = (res, cfg)
    res, cfg = runs["hallucination"]
    hal_ckpt = os.path.join(res.result_dir, f"{cfg.name}.ckpt-{res.step}")

    cfg = slice6_cfg(root, "smoke_cross", ckpts, feat="resnet,sensors",
                     sensors_path=None, segment_path=None, label_num=93,
                     static_epochs=500)
    res, launches, cols = drive_plain(root, "cross", cross_prediction.train,
                                      cfg, ("mse",))
    expect_launches("cross", launches, none)
    if not (res.metrics["train_mse"] > 0
            and res.metrics["train_mse"] == cols["mse"][-1]):
        fail("cross: train_mse not the last step's positive MSE")
    runs["cross"] = (res, cfg)

    cfg = full_width_cfg(root, "smoke_classifier", network="convtsn",
                         emb_dim=256, max_epochs=1, static_epochs=500)
    res, launches, _ = drive_plain(root, "classifier",
                                   base_model_classifier.train, cfg,
                                   ("ce", "accuracy"))
    expect_launches("classifier", launches, none)
    check_classifier_accuracy(res, cfg, root)
    runs["classifier"] = (res, cfg)
    # on the full-budget directory's test session: 340 events
    evals = check_eval_clis(full_root, runs, ckpts)
    step_ms = slice6_step_times(runs, full_batch)
    del full_batch

    # steady state on batches that fill the budget
    times = {}
    for tag in ("dcca", "hallucination", "cross"):
        res, cfg = runs.pop(tag)
        lr = cfg.learning_rate
        if tag == "cross":
            exp = mm_experiment(full_root, f"steady-{tag}",
                                slice6_cfg(full_root, f"steady_{tag}", ckpts,
                                           feat="resnet,sensors",
                                           label_num=93),
                                ["resnet", "sensors"])
            exp.loader.prepare_funcs[1] = mean_pool_input
            step_fn = cross_prediction.make_regression_step(
                res.model, res.optimizer, cfg)
            keys = ("events", "events2", "mask")

            def step(b, step_fn=step_fn):
                return step_fn(b["events"], b["events2"].reshape(
                    b["events2"].shape[0], -1), b["mask"], lr)
        elif tag == "dcca":
            exp = slice6_experiment(full_root, f"steady-{tag}", ckpts)
            run = multitask_dcca.make_host_step(
                res.model, res.optimizer, cfg, device, exp.labeled_sessions,
                random.Random(0), np.random.RandomState(0),
                min(3 * cfg.triplet_per_batch, exp.event_budget))
            keys = ("events", "events2", "events3")

            def step(b, run=run):
                return run(b, lr, cfg.lambda_multimodal)
        else:
            exp = mm_experiment(full_root, f"steady-{tag}",
                                slice6_cfg(full_root, f"steady_{tag}", ckpts,
                                           label_num=93),
                                MM_FEATS.split(","))
            run = modality_hallucination.make_host_step(
                res.model, res.optimizer, cfg, device, random.Random(0))
            keys = ("events", "events2", "events3")

            def step(b, run=run):
                return run(b, lr)
        times[tag] = steady_step(tag, cfg, keys, step, loader_batches(exp),
                                 SLICE6_WARM, SLICE6_DRAWS)
        del res, step, exp
    del runs
    torch.cuda.empty_cache()
    print(f"[slice6] steady state (s a loader draw) {json.dumps(times)}; "
          f"steps alone (ms) {json.dumps(step_ms)}; "
          f"dcca deltas {json.dumps(dcca_deltas)}, ms {json.dumps(dcca_ms)};"
          f" eval {json.dumps(evals)}; slice 6a phase "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return hal_ckpt


NATIVE_REPEATS = 2
TF_WARM, TF_DRAWS = 1, 4


@contextlib.contextmanager
def python_gather():
    """``load_data_and_label`` on its per-event Python loop (the native
    gather patched to defer)."""
    from multimodal_similarity_tpu_torch.data import datasets
    native_path = datasets._load_events_tsn_native
    datasets._load_events_tsn_native = lambda *a: None
    try:
        yield
    finally:
        datasets._load_events_tsn_native = native_path


def same_events(tag, got, want):
    import numpy as np
    if not (got[0].dtype == want[0].dtype
            and np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])
            and [tuple(map(int, b)) for b in got[2]]
            == [tuple(map(int, b)) for b in want[2]]):
        fail(f"{tag}: the native gather differs from the Python loop")


def native_phase(full_root):
    """The native TSN gather on the card's host, on the full-budget
    directory's resnet sessions (340 events of MIN_LENGTH + 1 frames, 3 of
    them copied): ``native_gather_segments`` against NumPy indexing and
    ``load_data_and_label`` against the Python loop, bit for bit, with
    train-time sampling (the generator left in the same state) and
    test-time sampling; then both paths' times on one session and on a
    3-session ``SessionBatchLoader`` batch at the 1000-event budget."""
    import functools

    import numpy as np
    from multimodal_similarity_tpu_torch.data import (
        MIN_LENGTH, SessionBatchLoader, load_data_and_label,
        native_gather_segments, prepare_dataset, tsn_prepare_input,
        tsn_prepare_input_test)
    from multimodal_similarity_tpu_torch.data import native

    with open(os.path.join(full_root, "train_session.txt")) as f:
        sessions = f.read().split()
    rows = prepare_dataset(os.path.join(full_root, "features"), sessions,
                           "resnet", os.path.join(full_root, "labels"))
    feat_path, label_path = rows[0]

    def train_prep(seed):
        gen = np.random.RandomState(seed)
        return gen, functools.partial(
            functools.partial(tsn_prepare_input, 3), rng=gen)

    gen_n, prep_n = train_prep(11)
    got = load_data_and_label(feat_path, label_path, prep_n)
    gen_p, prep_p = train_prep(11)
    with python_gather():
        want = load_data_and_label(feat_path, label_path, prep_p)
    same_events("native train sampling", got, want)
    if gen_n.randint(1 << 30) != gen_p.randint(1 << 30):
        fail("native train sampling: the generator's state differs")
    prep_t = functools.partial(tsn_prepare_input_test, 3)
    got = load_data_and_label(feat_path, label_path, prep_t)
    with python_gather():
        same_events("native test sampling", got,
                    load_data_and_label(feat_path, label_path, prep_t))
    feats = np.load(feat_path, mmap_mode="r")
    flat = feats.reshape(feats.shape[0], -1)
    starts = np.asarray([b[0] for b in got[2]], np.int64)
    offsets = np.random.RandomState(0).randint(
        0, MIN_LENGTH + 1, size=(len(starts), 3)).astype(np.int64)
    if not np.array_equal(native_gather_segments(flat, starts, offsets),
                          flat[starts[:, None] + offsets]):
        fail("native_gather_segments differs from NumPy indexing")
    n_events = got[0].shape[0]
    del got, want, feats, flat

    times = {"session_native_s": [], "session_python_s": [],
             "batch_native_s": [], "batch_python_s": []}
    loader = SessionBatchLoader(
        rows[:3], sess_per_batch=3, event_budget=1000,
        prepare_funcs=[functools.partial(tsn_prepare_input, 3)], seed=0)
    for _ in range(NATIVE_REPEATS):
        for path, ctx in (("native", contextlib.nullcontext),
                          ("python", python_gather)):
            with ctx():
                t = time.perf_counter()
                load_data_and_label(feat_path, label_path, train_prep(1)[1])
                times[f"session_{path}_s"].append(time.perf_counter() - t)
                t = time.perf_counter()
                batch = loader._load_group(rows[:3])
                times[f"batch_{path}_s"].append(time.perf_counter() - t)
            if int(batch["num_events"]) != min(1000, 3 * FULL_EVENTS):
                fail(f"native: a 3-session batch of {batch['num_events']} "
                     "events does not fill the 1000-event budget")
            del batch
    frame = int(np.prod(np.load(feat_path, mmap_mode="r").shape[1:])) * 4
    print(f"[native] {native.library_path().name}; one session of "
          f"{n_events} events and a 3-session batch ("
          f"{min(1000, 3 * FULL_EVENTS)} of {3 * FULL_EVENTS} events), resnet "
          f"{'x'.join(map(str, FULL_RESNET))} ({frame} bytes a frame), "
          f"each event MIN_LENGTH + 1 = {MIN_LENGTH + 1} frames of which 3 "
          f"are sampled (real Honda events run up to MAX_LENGTH = 45): the "
          f"native gather copies the sampled frames once, into the session "
          f"array; the Python loop copies them into a per-event array, casts "
          f"it, concatenates the session and casts it again; times (s) "
          f"{json.dumps(times)}", flush=True)
    return times


def pretrain_chain(full_root):
    """scripts/unimodal_pretrain.sh at its widths on the full-budget
    directory's sensors (8,) features: ``unimodal_pretrain_sae``
    (Seq2seqTSN, emb_dim 128, Adam 1e-2, 3 segments; 1 epoch of 500),
    ``unimodal_pretrain_cluster`` on its checkpoint (20 clusters, n_init
    20, on the 12 x 340 train events), ``unimodal_pretrain_pairsim`` on
    the cluster files (emb_dim 128; 2 epochs of 200, the curriculum phase
    0.5 then 1.0).  Checks finite losses and val_mse, the stored inertia
    against NumPy on the CPU's embeddings with the stored centres, the
    high-confidence rows as CPU embeddings, and val_acc against the CPU
    head on the same pairs."""
    import functools
    import pickle

    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    from multimodal_similarity_tpu_torch.data import (
        prepare_dataset, tsn_prepare_input_test)
    from multimodal_similarity_tpu_torch.models import Seq2seqTSN
    from multimodal_similarity_tpu_torch.train.checkpoints import (
        load_checkpoint)
    from multimodal_similarity_tpu_torch.train.trainers import (
        unimodal_pretrain_cluster, unimodal_pretrain_pairsim,
        unimodal_pretrain_sae)

    out = {}

    def cfg_of(name, **kw):
        return TrainConfig(DATA_ROOT=full_root, name=name, feat="sensors",
                           n_input=8, emb_dim=128, optimizer="ADAM",
                           log_flush_every=1, **kw).resolve()

    t0 = time.time()
    cfg = cfg_of("smoke_pretrain_sae", network="rtsn", max_epochs=1,
                 static_epochs=250, learning_rate=1e-2)
    res = unimodal_pretrain_sae.train(
        cfg, result_dir=os.path.join(full_root, "r_sae"), device="cuda")
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    if res.step != 4 or len(losses) != 4 or not all(
            map(math.isfinite, losses + [res.metrics["val_mse"]])):
        fail(f"pretrain_sae: {res.step} steps, losses {losses}, metrics "
             f"{res.metrics}")
    out["sae"] = {"s": time.time() - t0, "steps": res.step,
                  "loss": losses, "val_mse": res.metrics["val_mse"]}
    ckpt = os.path.join(res.result_dir, f"{cfg.name}.ckpt-{res.step}")

    t0 = time.time()
    ccfg = cfg_of("smoke_pretrain_cluster", model_path=ckpt)
    kdir = unimodal_pretrain_cluster.run(
        ccfg, result_dir=os.path.join(full_root, "r_kmeans"),
        device="cuda")
    seconds = time.time() - t0
    with open(os.path.join(kdir, "kmeans_model.pkl"), "rb") as f:
        km = pickle.load(f)
    with open(os.path.join(kdir, "train_data.pkl"), "rb") as f:
        data = pickle.load(f)
    # the CPU's embeddings of the same events, the stored centres' inertia
    model = Seq2seqTSN(n_seg=3, n_input=8, emb_dim=128)
    load_checkpoint(ckpt, model)
    rows = prepare_dataset(ccfg.feature_root, ccfg.train_session, "sensors",
                           ccfg.label_root)
    emb, _, _ = unimodal_pretrain_cluster.embed_sessions(
        model, rows, functools.partial(tsn_prepare_input_test, 3),
        torch.device("cpu"))
    centers = km["cluster_centers"]
    d = ((emb[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    inertia = float(d.min(axis=1).sum())
    sizes = np.bincount(data["labels"][:, 0], minlength=20)
    # each kept row is one of the events: its distance to the nearest CPU
    # embedding
    err = float(torch.cdist(torch.from_numpy(data["feats"]).double(),
                            torch.from_numpy(emb).double()).min(1)[0].max())
    print(f"[pretrain] k-means on {emb.shape[0]} embeddings: inertia card "
          f"{km['inertia']:.6f} vs NumPy with the stored centres on the "
          f"CPU's embeddings {inertia:.6f}; {km['n_iter']} Lloyd "
          f"iterations in the kept run; high-confidence rows per cluster "
          f"{sizes.tolist()} (each within {err:.2e} of a CPU embedding); "
          f"{seconds:.1f} s", flush=True)
    if not (emb.shape[0] == 12 * FULL_EVENTS and np.isfinite(inertia)
            and abs(km["inertia"] - inertia) <= 1e-4 * inertia
            and err <= 1e-4 and sizes.max() <= 100
            and data["feats"].shape == (sizes.sum(), 128)):
        fail("pretrain_cluster: the k-means result does not hold")
    out["cluster"] = {"s": seconds, "inertia": km["inertia"],
                      "sizes": sizes.tolist()}

    t0 = time.time()
    pcfg = cfg_of("smoke_pretrain_pairsim", max_epochs=2,
                  model_path=os.path.join(kdir, "x"))
    res = unimodal_pretrain_pairsim.train(
        pcfg, result_dir=os.path.join(full_root, "r_pairsim"),
        device="cuda")
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    (_, _), (val_feats, val_labels) = unimodal_pretrain_pairsim \
        .load_clusters(os.path.join(kdir, "train_data.pkl"))
    a, b = unimodal_pretrain_pairsim.prepare_val(
        val_labels, np.random.RandomState(pcfg.seed))
    head = res.model.cpu().eval()
    with torch.no_grad():
        logits, _ = head.score(torch.from_numpy(val_feats[a]),
                               torch.from_numpy(val_feats[b]))
    lab = unimodal_pretrain_pairsim.pair_labels(val_labels, a, b)
    cpu_acc = float((logits.argmax(-1).numpy() == lab).mean())
    print(f"[pretrain] pairsim epochs {json.dumps(recs)}; val_acc card "
          f"{res.metrics['val_acc']:.6f} vs CPU {cpu_acc:.6f}", flush=True)
    if [r["phase"] for r in recs] != [0.5, 1.0] or not all(
            math.isfinite(r["loss"]) for r in recs) or \
            abs(cpu_acc - res.metrics["val_acc"]) > PAIR_METRIC_TOL:
        fail("pretrain_pairsim: epochs or val_acc do not hold")
    out["pairsim"] = {"s": time.time() - t0, "steps": res.step,
                      "val_acc": res.metrics["val_acc"]}
    print(f"[pretrain] {json.dumps(out)}", flush=True)
    return out


def tf_phase(root):
    """``base_model_tf`` at base_model's width (ConvLSTM on 8x8x1536
    frames, n_C 20, emb_dim 128, MAX_LENGTH_FRAMES 90, 64 events a batch,
    100 triplets), 1 epoch on TFRecords that ``generate_event_tfrecords``
    writes from the trainers' 10-session directory: a native-parsed batch
    against the Python parse, finite losses, the validation metrics against
    the NumPy oracle, and the steady step (TF_DRAWS draws after TF_WARM:
    one batch an epoch here)."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.data import (
        EventTFRecordLoader, generate_event_tfrecords, list_event_tfrecords,
        prepare_dataset)
    from multimodal_similarity_tpu_torch.data import native
    from multimodal_similarity_tpu_torch.eval.metrics import (
        evaluate_simple, retrieval_metrics)
    from multimodal_similarity_tpu_torch.train.trainers import base_model_tf

    cfg = full_width_cfg(root, "smoke_tf", network="convlstm", max_epochs=1,
                         tfrecords_root=os.path.join(root, "tfrecords2"))
    feat, flat_dim, hwc = base_model_tf.frame_layout(cfg)
    t0 = time.time()
    rows = prepare_dataset(cfg.feature_root,
                           cfg.train_session + cfg.val_session, feat,
                           cfg.label_root)
    n = generate_event_tfrecords(rows, cfg.tfrecords_root, [feat])
    paths = list_event_tfrecords(cfg.tfrecords_root, cfg.train_session)
    size = sum(os.path.getsize(p) for p in
               list_event_tfrecords(cfg.tfrecords_root))
    print(f"[tf] {n} event records ({size} bytes) written in "
          f"{time.time() - t0:.1f} s; {len(paths)} train events", flush=True)

    loader = EventTFRecordLoader(paths[:64], feat, flat_dim, 64,
                                 cfg.MAX_LENGTH_FRAMES, shuffle=False)
    t0 = time.time()
    got = loader._make_batch(paths[:64])
    t_native = time.time() - t0
    parse = native.native_load_event_batch
    native.native_load_event_batch = lambda *a, **k: (None, None, None, 0)
    try:
        t0 = time.time()
        want = loader._make_batch(paths[:64])
        t_python = time.time() - t0
    finally:
        native.native_load_event_batch = parse
    for key in ("features", "seq_len", "labels", "mask"):
        if not np.array_equal(got[key], want[key]):
            fail(f"tf: the native parse's {key} differs from the Python "
                 "parse")
    print(f"[tf] a batch of {len(paths[:64])} events parsed natively in "
          f"{t_native:.3f} s and in Python in {t_python:.3f} s: equal",
          flush=True)
    del got, want

    t0 = time.time()
    res = base_model_tf.train(cfg, result_dir=os.path.join(root, "r_tf"),
                              device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    print(f"[tf] {res.step} steps in {wall:.1f} s: "
          + "; ".join(f"loss {r['loss']:.6f} triplets {r['triplet_num']:.0f}"
                      for r in steps) + f"; metrics {res.metrics}",
          flush=True)
    if not steps or not all(math.isfinite(r["loss"]) for r in steps) or \
            not math.isfinite(res.metrics.get("val_mAP", math.nan)):
        fail("tf: non-finite loss or val mAP")
    val_paths = list_event_tfrecords(cfg.tfrecords_root, cfg.val_session)
    emb, labels = base_model_tf.embed_records(
        res.model, cfg, val_paths, feat, flat_dim, hwc, 64,
        torch.device("cuda"))
    dev = retrieval_metrics(emb, labels)
    ref = evaluate_simple(emb.cpu().numpy(), labels)
    print(f"[tf] val metrics device (mAP, mPrec, R@1) {dev[0]:.6f} "
          f"{dev[1]:.6f} {dev[2][1]:.6f} vs NumPy oracle {ref[0]:.6f} "
          f"{ref[1]:.6f} {ref[2]:.6f}", flush=True)
    if not np.allclose([dev[0], dev[1], dev[2][1]], list(ref), atol=2e-3) \
            or abs(dev[0] - res.metrics["val_mAP"]) > 1e-6:
        fail("tf: validation metrics disagree with the NumPy oracle or the "
             "trainer")

    def batches():
        train_loader = EventTFRecordLoader(paths, feat, flat_dim, 64,
                                           cfg.MAX_LENGTH_FRAMES, seed=1)
        while True:
            yield from train_loader.epoch()

    step = base_model_tf.make_step(
        res.model, res.optimizer, cfg, hwc,
        torch.Generator(device="cuda").manual_seed(0))
    steady = steady_step("tf", cfg, base_model_tf.FEED_KEYS,
                         lambda b: step(b, cfg.learning_rate), batches(),
                         TF_WARM, TF_DRAWS)
    del res, step
    torch.cuda.empty_cache()
    return {"train_s": wall, "parse_native_s": t_native,
            "parse_python_s": t_python, **steady}


def pretrain_phase(root, full_root):
    """Phase 16: the native host data path, the pretrain chain and
    ``base_model_tf``; no ``csrc/`` launch."""
    from multimodal_similarity_tpu_torch.data import native
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)

    t_phase = time.time()
    reset_launch_counts()
    native.reset_counts()
    times = native_phase(full_root)
    chain = pretrain_chain(full_root)
    tf = tf_phase(root)
    expect_launches("pretrain", dict(LAUNCHES), dict.fromkeys(LAUNCHES, 0))
    print(f"[pretrain] native counts over phase 16 {json.dumps(native.COUNTS)}"
          f"; native {json.dumps(times)}; chain seconds "
          f"{json.dumps({k: v['s'] for k, v in chain.items()})}; tf "
          f"{json.dumps(tf)}; phase 16 {time.time() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# slice 7: serving, export_index, the other evaluation CLIs, the dispatcher
# ---------------------------------------------------------------------------

# a request: 256 events at ConvRTSN full width (302 MB in f32), the
# service's batch; SERVE_CHECK of them held against the CPU
SERVE_EVENTS, SERVE_CHECK = 256, 32
# the gallery's rows (RESULTS.md: 200k-400k x 256 galleries, Q = 1024,
# top-10): the dense path at one chunk, the chunked path at 7 chunks of
# the default 65,536
INDEX_DIM, INDEX_QUERIES, INDEX_K = 256, 1024, 10
INDEX_ROWS = {"dense": 65_536, "chunked": 400_000}
INDEX_CPU_QUERIES = 256
# f32 top-k against float64, and card against CPU: indices equal wherever
# neighbouring distances are more than INDEX_GAP apart (relative); f32
# distances within INDEX_RTOL, int8 ones within INT8_ATOL
INDEX_GAP = INDEX_RTOL = 1e-5
INT8_ATOL = 3e-4
# the int8 gallery's top-10 overlap with the exact index
# (tests/test_serving.py:227)
INT8_OVERLAP = 0.95


def separated(d, gap=INDEX_GAP):
    """[Q, k + 1] ascending distances -> ([Q] rows whose top k is apart
    from the next, [Q] rows whose every neighbour is apart)."""
    import numpy as np
    rel = np.diff(d, axis=1) > gap * np.maximum(np.abs(d[:, 1:]), 1e-30)
    return rel[:, -1], rel.all(axis=1)


def same_topk(tag, got, want, want_next, atol=0.0, rtol=INDEX_RTOL):
    """``got`` (d, idx) [Q, k] against ``want`` (d, idx) [Q, k] and the
    (k+1)-th distances ``want_next`` [Q]: the top-k sets equal where the
    k-th and (k+1)-th distances are apart, the order equal where every
    neighbour is, distances within ``rtol`` / ``atol``.  Returns the
    count of rows each rule checked."""
    import numpy as np
    d_want = np.concatenate([want[0], want_next[:, None]], axis=1)
    set_rows, order_rows = separated(d_want)
    for r in np.flatnonzero(set_rows):
        if set(got[1][r]) != set(want[1][r]):
            fail(f"{tag}: query {r}'s top-{got[1].shape[1]} set differs")
    if not np.array_equal(got[1][order_rows], want[1][order_rows]):
        fail(f"{tag}: the top-k order differs on a separated query")
    np.testing.assert_allclose(got[0], want[0], rtol=rtol, atol=atol,
                               err_msg=tag)
    return int(set_rows.sum()), int(order_rows.sum())


def unit_rows(n, d, seed, device="cuda"):
    """[n, d] random unit f32 rows, drawn on ``device``, as a host
    array."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device)
    return (x / x.norm(dim=1, keepdim=True)).cpu().numpy()


def f64_topk(queries, gallery, k, metric):
    """The float64 dense top-(k + 1) on the card: (d [Q, k], idx [Q, k],
    the (k + 1)-th distances [Q])."""
    import torch
    q = torch.from_numpy(queries).cuda().double()
    g = torch.from_numpy(gallery).cuda().double()
    d = ((q * q).sum(1)[:, None] + (g * g).sum(1)[None]
         - 2.0 * q @ g.T).clamp_(min=0.0)
    if metric == "euclidean":
        d = d.sqrt_()
    val, idx = torch.topk(d, k + 1, dim=1, largest=False, sorted=True)
    del d, q, g
    val, idx = val.cpu().numpy(), idx.cpu().numpy()
    return val[:, :k], idx[:, :k], val[:, k]


def gallery_bytes(index):
    t = index._device_gallery
    return sum(x.numel() * x.element_size()
               for x in (t if isinstance(t, tuple) else (t,)))


def index_cell(tag, gallery, queries, oracle, metric="euclidean",
               int8=False):
    """One index on the card over ``gallery``: its one-time upload (int8:
    quantizing included), its device bytes, the warm query time of
    ``queries`` (CUDA events around 5 calls, each from the host array to
    the results on the host) and queries a second; the results against
    the float64 ``oracle`` (f32: ``same_topk``; int8: overlap) and, on
    INDEX_CPU_QUERIES queries, against the same index on the CPU.  Returns
    its row of numbers."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.serving import RetrievalIndex
    index = RetrievalIndex(INDEX_DIM, metric=metric, int8_gallery=int8)
    index.add(gallery)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index._gallery_on_device()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    ms = call_ms(lambda: index.query(queries, k=INDEX_K), iters=5,
                 warmup=1)
    d, idx, _ = index.query(queries, k=INDEX_K)
    path = ("int8" if int8 else
            "chunked" if len(index) > index.gallery_chunk else "dense")
    row = {"rows": len(index), "path": path, "metric": metric,
           "upload_s": round(upload_s, 4), "device_bytes": gallery_bytes(
               index), "query_ms": round(ms, 4),
           "queries_per_s": round(INDEX_QUERIES / ms * 1e3, 1)}
    # where the query's time goes: its device work alone (CUDA-graph
    # replay); the dense path's product and selection apart
    q = torch.from_numpy(queries).cuda()
    row["device_ms"] = round(device_ms(lambda: index._topk(q, INDEX_K),
                                       reps=3, iters=3), 4)
    if path == "dense":
        from multimodal_similarity_tpu_torch.ops.chunked_topk import (
            ieee_f32, smallest_k)
        from multimodal_similarity_tpu_torch.ops.distances import (
            pairwise_distance)
        with ieee_f32():
            dist = pairwise_distance(q, index._device_gallery, metric)
            row["product_ms"] = round(device_ms(lambda: pairwise_distance(
                q, index._device_gallery, metric), reps=3, iters=3), 4)
        row["select_ms"] = round(device_ms(lambda: smallest_k(
            dist, INDEX_K), reps=3, iters=3), 4)
        del dist
    od, oi, onext = oracle
    if int8:
        overlap = float(np.mean([len(set(a) & set(b)) / INDEX_K
                                 for a, b in zip(oi, idx)]))
        row["overlap"] = overlap
        if overlap < INT8_OVERLAP:
            fail(f"{tag}: int8 top-{INDEX_K} overlap {overlap} < "
                 f"{INT8_OVERLAP}")
    else:
        row["f64_rows"] = same_topk(f"{tag} vs float64", (d, idx),
                                    (od, oi), onext)
    host = RetrievalIndex(INDEX_DIM, metric=metric, int8_gallery=int8,
                          device="cpu")
    host.add(gallery)
    nq = INDEX_CPU_QUERIES
    cd, ci, _ = host.query(queries[:nq], k=INDEX_K + 1)
    row["cpu_rows"] = same_topk(
        f"{tag} card vs CPU", (d[:nq], idx[:nq]), (cd[:, :-1], ci[:, :-1]),
        cd[:, -1], atol=INT8_ATOL if int8 else 0.0)
    del index, host
    torch.cuda.empty_cache()
    print(f"[serve] index {tag}: {json.dumps(row)}", flush=True)
    return row


def tf32_held(gallery, queries):
    """The dense, chunked and int8 queries with TF32 switched on
    process-wide, through the legacy flag and through ``fp32_precision``
    where torch has it, give the bits they give with it off: the products
    run in IEEE f32 whatever the setting."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.serving import RetrievalIndex
    flags = torch.backends.cuda.matmul
    switches = {"allow_tf32": (True, False)}
    if hasattr(flags, "fp32_precision"):
        switches["fp32_precision"] = ("tf32", "ieee")
    out = {}
    for n, chunk, int8 in ((8192, 65536, False), (8192, 2048, False),
                           (8192, 65536, True)):
        tag = "int8" if int8 else "dense" if chunk > n else "chunked"
        index = RetrievalIndex(INDEX_DIM, gallery_chunk=chunk,
                               int8_gallery=int8)
        index.add(gallery[:n])
        want = index.query(queries, k=INDEX_K)[:2]
        for key, (on, off) in switches.items():
            setattr(flags, key, on)
            try:
                got = index.query(queries, k=INDEX_K)[:2]
            finally:
                setattr(flags, key, off)
            out[f"{tag}-{key}"] = all(np.array_equal(a, b)
                                      for a, b in zip(got, want))
    print(f"[serve] bit-equal with TF32 on {json.dumps(out)}", flush=True)
    if not all(out.values()):
        fail("serve: TF32 switched on changed a query's results")
    return out


def retrieval_phase():
    """RetrievalIndex on random unit rows of width 256: the dense path at
    65,536 rows, the chunked path at 400,000 (and once squared
    Euclidean), the int8 gallery at both; Q = 1024, top-10."""
    import torch
    gallery = unit_rows(INDEX_ROWS["chunked"], INDEX_DIM, 17)
    queries = unit_rows(INDEX_QUERIES, INDEX_DIM, 18)
    cells = {}
    for size, n in INDEX_ROWS.items():
        g = gallery[:n]
        for metric in (("euclidean", "squaredeuclidean")
                       if size == "chunked" else ("euclidean",)):
            oracle = f64_topk(queries, g, INDEX_K, metric)
            tag = f"{size}-{n}" + ("-sq" if metric != "euclidean" else "")
            cells[tag] = index_cell(tag, g, queries, oracle, metric)
            if metric == "euclidean":
                cells[f"int8-{n}"] = index_cell(f"int8-{n}", g, queries,
                                                oracle, int8=True)
            torch.cuda.empty_cache()
    cells["tf32_held"] = tf32_held(gallery, queries)
    return cells


def service_phase(hal_ckpt):
    """EmbeddingService at ConvRTSN full width with the modality_core of
    phase 15's hallucination checkpoint: requests of SERVE_EVENTS events
    (f32; int8 quantized on the host; int8 quantized beforehand), ms a
    request from the host array to the embeddings on the host; the card
    against the CPU on SERVE_CHECK events, int8 within 0.05 of f32
    (tests/test_serving.py), the zero-row request."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.data.device_feed import (
        quantize_features)
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.serving import EmbeddingService
    from multimodal_similarity_tpu_torch.train.checkpoints import (
        restore_encoder_params)

    params = restore_encoder_params(hal_ckpt, "modality_core")

    def model():
        return build_encoder("convrtsn", num_seg=3, emb_dim=128,
                             n_input=FULL_RESNET[2], n_h=FULL_RESNET[0],
                             n_w=FULL_RESNET[1], n_C=20)

    gen = torch.Generator(device="cuda").manual_seed(19)
    events = torch.randn((SERVE_EVENTS, 3) + FULL_RESNET, generator=gen,
                         device="cuda").cpu().numpy()
    svc = {"f32": EmbeddingService(model(), params, SERVE_EVENTS),
           "int8": EmbeddingService(model(), params, SERVE_EVENTS,
                                    int8=True)}
    q, s = quantize_features(events)
    calls = {"f32": lambda: svc["f32"].embed(events),
             "int8": lambda: svc["int8"].embed(events),
             "int8_prequantized": lambda: svc["int8"].embed_quantized(q, s)}
    row = {k: round(call_ms(fn, iters=5, warmup=1), 3)
           for k, fn in calls.items()}
    row["request_bytes"] = {"f32": events.nbytes,
                            "int8": q.numel() + s.numel() * 4}
    check = events[:SERVE_CHECK]
    card, errs = {}, {}
    for kind in ("f32", "int8"):
        card[kind] = svc[kind].embed(check)
        cpu = EmbeddingService(model(), params, SERVE_EVENTS,
                               int8=kind == "int8", device="cpu").embed(check)
        errs[kind] = float(np.abs(card[kind] - cpu).max()
                           / np.abs(cpu).max())
        if card[kind].shape != (SERVE_CHECK, 128) or \
                not np.isfinite(card[kind]).all() or \
                errs[kind] > EVAL_EMB_RTOL:
            fail(f"serve: the {kind} service on the card differs from the "
                 "CPU")
    gap = float(np.abs(card["int8"] - card["f32"]).max())
    row.update(card_vs_cpu=errs, int8_vs_f32=gap)
    if gap >= 0.05:
        fail(f"serve: int8 embeddings {gap} from the f32 ones")
    if svc["int8"].embed(events[:0]).shape != (0, 128):
        fail("serve: a zero-row request is not (0, 128)")
    del svc, events, q, s
    torch.cuda.empty_cache()
    print(f"[serve] EmbeddingService (ms a request of {SERVE_EVENTS} "
          f"events) {json.dumps(row)}", flush=True)
    return row


def same_files(a, b):
    for name in sorted(os.listdir(a)):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            if fa.read() != fb.read():
                fail(f"export: {name} of a second save differs")


def export_phase(full_root, sensors_ckpt, out_dir):
    """export_index on the full-budget directory's test session with phase
    13's pddm_model sensors encoder, f32 and int8, on the card and on the
    CPU; each index loaded on the card and queried against the CPU's, and
    a second save of the loaded index byte-equal to the first."""
    import numpy as np
    from multimodal_similarity_tpu_torch.configs import EvalConfig
    from multimodal_similarity_tpu_torch.eval import export_index
    from multimodal_similarity_tpu_torch.serving import RetrievalIndex
    queries = unit_rows(64, 32, 20)
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        dirs = {}
        for dev in ("cuda", "cpu"):
            cfg = EvalConfig(DATA_ROOT=full_root, model_path=sensors_ckpt,
                             variable_name="encoder", network="rtsn",
                             feat="sensors", n_input=8, emb_dim=32,
                             device=dev).resolve()
            t0 = time.time()
            dirs[dev] = export_index.run(
                cfg, os.path.join(out_dir, f"{tag}-{dev}"),
                int8_gallery=int8)
            out[f"{tag}_{dev}_s"] = round(time.time() - t0, 3)
        card = RetrievalIndex.load(dirs["cuda"])
        host = RetrievalIndex.load(dirs["cpu"], device="cpu")
        if card.metric != "euclidean" or len(card) != len(host) or \
                card.int8_gallery != int8:
            fail(f"export: the {tag} index is not what was exported")
        d, idx, meta = card.query(queries, k=INDEX_K)
        hd, hi, _ = host.query(queries, k=INDEX_K + 1)
        same_topk(f"export {tag} card vs CPU", (d, idx),
                  (hd[:, :-1], hi[:, :-1]), hd[:, -1],
                  atol=INT8_ATOL if int8 else 1e-6, rtol=1e-4)
        if not {"session", "label", "start", "end"} <= set(meta[0][0]):
            fail("export: metadata lacks session, label or bounds")
        again = card.save(os.path.join(out_dir, f"{tag}-again"))
        same_files(dirs["cuda"], again)
        out[f"{tag}_events"] = len(card)
        out[f"{tag}_max_err"] = float(np.abs(d - hd[:, :-1]).max())
    print(f"[serve] export_index {json.dumps(out)}", flush=True)
    return out


# check_inconsistent's threshold in phase 17: every misjudged pair
INCONSISTENT_THRESHOLD = 0.5


def same_pairs(tag, card, cpu):
    """check_inconsistent's (session, i, j, label_i, label_j, P(similar))
    lists, card against CPU: equal in order, probabilities within
    PAIR_PROB_TOL, up to a first difference whose probability lies within
    PAIR_PROB_TOL of INCONSISTENT_THRESHOLD (a near-tie decided either
    way; every later entry then shifts).  Returns (len card, len CPU)."""
    for a, b in zip(card, cpu):
        if a[:5] != b[:5]:
            if min(abs(x[5] - INCONSISTENT_THRESHOLD)
                   for x in (a, b)) > PAIR_PROB_TOL:
                fail(f"eval: {tag} on the card differs from the CPU: {a} "
                     f"against {b}")
            print(f"[serve] {tag}: lists part at a threshold near-tie {a} "
                  f"/ {b}", flush=True)
            return len(card), len(cpu)
        if abs(a[5] - b[5]) > PAIR_PROB_TOL:
            fail(f"eval: {tag} probabilities differ: {a} against {b}")
    if len(card) != len(cpu):
        fail(f"eval: {tag} lists of {len(card)} and {len(cpu)} pairs")
    return len(card), len(cpu)


def eval_cli_phase(full_root, ckpts, pairsim_ckpt, hal_ckpt):
    """evaluate_baseline (mean and max; NumPy only), evaluate_hallucination
    (phase 15's checkpoint), evaluate_pairsim (phase 13's pairsim_model),
    check_inconsistent (--head pddm on phase 13's sensors pddm_model,
    --head pairsim; threshold INCONSISTENT_THRESHOLD) on the full-budget
    directory's test session, card against CPU; then analysis on an evaluate_model results.pkl.  Returns
    that results.pkl's path."""
    import numpy as np
    from multimodal_similarity_tpu_torch.configs import EvalConfig
    from multimodal_similarity_tpu_torch.eval import (
        analysis, check_inconsistent, evaluate_baseline,
        evaluate_hallucination, evaluate_model, evaluate_pairsim)
    conv = dict(network="convrtsn", feat="resnet", emb_dim=128,
                n_input=FULL_RESNET[2], n_h=FULL_RESNET[0],
                n_w=FULL_RESNET[1], n_C=20)
    sensors = dict(network="rtsn", feat="sensors", n_input=8)

    def both(fn, **kw):
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.time()
            got[dev] = fn(EvalConfig(DATA_ROOT=full_root, device=dev,
                                     **kw).resolve())
            got[dev + "_s"] = round(time.time() - t0, 3)
        return got

    out = {}
    for pool in ("mean", "max"):
        r = evaluate_baseline.run(EvalConfig(
            DATA_ROOT=full_root, preprocess_func=pool,
            **sensors).resolve())
        out[f"baseline_{pool}"] = (r["mAP"], r["recall"][0])
    r = both(evaluate_hallucination.run, model_path=hal_ckpt, **conv)
    err = float(np.abs(r["cuda"]["embeddings"] - r["cpu"]["embeddings"])
                .max() / np.abs(r["cpu"]["embeddings"]).max())
    metric = [(r[d]["mAP"], r[d]["recall"][0]) for d in ("cuda", "cpu")]
    out["hallucination"] = {"card": metric[0], "cpu": metric[1],
                            "emb_err": err, "s": (r["cuda_s"], r["cpu_s"]),
                            "width": r["cuda"]["embeddings"].shape[1]}
    if err > EVAL_EMB_RTOL or r["cuda"]["embeddings"].shape[1] != 160 or \
            any(abs(a - b) > PAIR_METRIC_TOL for a, b in zip(*metric)):
        fail("eval: evaluate_hallucination on the card differs from the CPU")
    r = both(evaluate_pairsim.run, model_path=pairsim_ckpt, emb_dim=128,
             normalized=False, **sensors)
    out["pairsim"] = {"card": r["cuda"]["accuracy"],
                      "cpu": r["cpu"]["accuracy"],
                      "pairs": r["cuda"]["pairs"],
                      "s": (r["cuda_s"], r["cpu_s"])}
    if not r["cuda"]["pairs"] or \
            abs(r["cuda"]["accuracy"] - r["cpu"]["accuracy"]) > \
            PAIR_METRIC_TOL or sorted(r["cuda"]["triplets"]) != \
            sorted(r["cpu"]["triplets"]) or not all(
                np.array_equal(r["cuda"]["triplets"][k],
                               r["cpu"]["triplets"][k])
                for k in r["cpu"]["triplets"]):
        fail("eval: evaluate_pairsim's triplets or accuracy on the card "
             "differ from the CPU")
    # each head on the embeddings it was trained on: pddm_model's
    # normalised, pairsim_model's not; at INCONSISTENT_THRESHOLD, since the
    # one-epoch heads are confident about no pair at the CLI's 0.9
    for head, path, emb in (("pddm", ckpts["sensors"], 32),
                            ("pairsim", pairsim_ckpt, 128)):
        r = both(lambda cfg, h=head: check_inconsistent.run(
            cfg, h, threshold=INCONSISTENT_THRESHOLD),
                 model_path=path, emb_dim=emb, normalized=head == "pddm",
                 **sensors)
        counts = {key: same_pairs(f"check_inconsistent --head {head} {key}",
                                  r["cuda"][key], r["cpu"][key])
                  for key in ("false_pos", "false_neg")}
        if not any(n for n, _ in counts.values()):
            fail(f"eval: check_inconsistent --head {head} found no pair")
        out[f"inconsistent_{head}"] = {**counts,
                                       "s": (r["cuda_s"], r["cpu_s"])}
    evaluate_model.run(EvalConfig(DATA_ROOT=full_root, model_path=hal_ckpt,
                                  variable_name="modality_core",
                                  **conv).resolve())
    pkl = os.path.join(os.path.dirname(hal_ckpt), "results.pkl")
    text = analysis.summarize_results(pkl)
    if "per-class mAP" not in text or "Recall@1" not in text:
        fail("eval: analysis.summarize_results lacks its sections")
    out["analysis_lines"] = len(text.splitlines())
    print(f"[serve] eval CLIs {json.dumps(out)}", flush=True)
    return pkl


def dispatcher_phase(results_pkl):
    """``python3 -m multimodal_similarity_tpu_torch``: the listing, one
    eval.* command (analysis on ``results_pkl``) and ``preprocess.frames
    --help`` (phase 21 runs the other preprocess.* and tools.* CLIs)."""
    cmd = [sys.executable, "-m", "multimodal_similarity_tpu_torch"]
    runs = {"list": [], "eval": ["eval.analysis", results_pkl],
            "preprocess": ["preprocess.frames", "--help"]}
    expect = {"list": "base_model_CUB", "eval": "per-class mAP",
              "preprocess": "--video_template"}
    out = {}
    for tag, args in runs.items():
        t0 = time.time()
        p = subprocess.run(cmd + args, cwd=HERE, capture_output=True,
                           text=True, timeout=300)
        out[tag] = (p.returncode, round(time.time() - t0, 2))
        if p.returncode != 0 or expect[tag] not in p.stdout:
            fail(f"dispatcher: {tag} failed: {p.stderr[-2000:]}")
    print(f"[serve] dispatcher (rc, s) {json.dumps(out)}", flush=True)
    return out


def serving_phase(full_root, ckpts, pairsim_ckpt, hal_ckpt):
    """Phase 17: slice 7 on the card; no ``csrc/`` launch."""
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    t_phase = time.time()
    reset_launch_counts()
    service_phase(hal_ckpt)
    retrieval_phase()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(full_root)) as d:
        export_phase(full_root, ckpts["sensors"], d)
    pkl = eval_cli_phase(full_root, ckpts, pairsim_ckpt, hal_ckpt)
    dispatcher_phase(pkl)
    expect_launches("serving", dict(LAUNCHES), dict.fromkeys(LAUNCHES, 0))
    print(f"[serve] phase 17 {time.time() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# slice 8a: the device feature cache and the fused cached steps
# ---------------------------------------------------------------------------

# phase 18's cache budget: the reference's estimate counts 45 frames an
# event (about 19.2 GB for the full-budget directory) where the resident
# arrays hold the longest window's 6 (about 2.6 GB); the default 6 GB
# declines it
CACHE_GB = 24.0
# the streamed windows beside the cached ones (the loader takes 2-2.75 s a
# draw there), and the cached windows' epochs of 4 draws after a warm one
CACHE_WARM, CACHE_DRAWS, CACHE_EPOCHS = 1, 3, 3
# the meanpool gather on the card against the CPU: the largest difference
# within CACHE_MEAN_RTOL of the CPU mean's largest entry (f32 sums of 6
# frames in another order)
CACHE_MEAN_RTOL = 1e-6
# the fused cached step against the two-call path: the loss, relative
CACHE_TWO_CALL_RTOL = 1e-5


def gather_on_card_vs_cpu(cache):
    """One plan of ``cache`` (three modalities: TSN, mean-pooled, TSN)
    gathered on the card and from a CPU copy of its resident arrays, the
    uniforms drawn once on the CPU and passed to both: q, scale, labels
    and mask bit-equal, the mean within CACHE_MEAN_RTOL."""
    import copy

    import torch
    from multimodal_similarity_tpu_torch.data import tsn

    cpu = copy.copy(cache)
    cpu.device = torch.device("cpu")
    cpu.q = [q.cpu() for q in cache.q]
    cpu.scale = [s.cpu() for s in cache.scale]
    cpu.seq_len, cpu.label_dev = cache.seq_len.cpu(), cache.label_dev.cpu()
    plan = next(cache.epoch_plans())
    gen = torch.Generator().manual_seed(18)
    uniforms = [torch.rand((cache.event_budget, cache.n_seg), generator=gen)
                for _ in range(2)]
    real = tsn.draw_tsn_uniforms
    out = {}
    try:
        for side, c in (("cuda", cache), ("cpu", cpu)):
            c.modality_modes = ("tsn", "meanpool", "tsn")
            queue = list(uniforms)
            tsn.draw_tsn_uniforms = (
                lambda gen, b, n, device, q=queue: q.pop(0).to(device))
            out[side] = c.gather(torch.from_numpy(plan["packed"]).to(side),
                                 None)
    finally:
        tsn.draw_tsn_uniforms = real
        cache.modality_modes = None
    (gm, glab, gmask), (wm, wlab, wmask) = out["cuda"], out["cpu"]
    same = (torch.equal(glab.cpu(), wlab) and torch.equal(gmask.cpu(), wmask)
            and all(torch.equal(gm[m][k].cpu(), wm[m][k])
                    for m in (0, 2) for k in ("q", "scale")))
    err = float((gm[1].cpu() - wm[1]).abs().max() / wm[1].abs().max())
    print(f"[cache] gather card vs CPU on one plan ({plan['num_events']} "
          f"real events): TSN q/scale, labels, mask bit-equal {same}; "
          f"meanpool max relative difference {err:.3g}", flush=True)
    if not same or not err <= CACHE_MEAN_RTOL:
        fail("cache: the gather on the card differs from the CPU's")


def two_call_vs_fused(cache, cfg):
    """The fused cached semi-hard step against the two-call path
    (``epoch_batches``, then the plain fused step) on the same plan, from
    the same weights and generators: the loss within CACHE_TWO_CALL_RTOL."""
    import torch
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.train.cached_steps import (
        make_cached_triplet_step, upload_plans)
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.steps import (
        make_triplet_train_step)

    def model():
        m = build_encoder(cfg.network, num_seg=cfg.num_seg,
                          emb_dim=cfg.emb_dim, n_input=cfg.n_input,
                          n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
                          keep_prob=1.0,
                          generator=torch.Generator().manual_seed(0)).cuda()
        return m, build_optimizer("ADAM", m, cfg.learning_rate)

    def gens():
        return (torch.Generator(device="cuda").manual_seed(5),
                torch.Generator(device="cuda").manual_seed(6))

    kw = dict(triplet_per_batch=200, alpha=cfg.alpha, num_negative=5)
    state = cache.rng.get_state()
    g_gather, g_mine = gens()
    batch = next(cache.epoch_batches(g_gather))
    plain = make_triplet_train_step(*model(), **kw, generator=g_mine)
    want = float(plain(batch["events"], batch["labels"], batch["mask"],
                       cfg.learning_rate)["loss"])
    cache.rng.set_state(state)
    g_gather, g_mine = gens()
    fused = make_cached_triplet_step(*model(), cache, **kw,
                                     gather_generator=g_gather,
                                     mine_generator=g_mine)
    got = float(fused(upload_plans(next(cache.epoch_plans())["packed"],
                                   "cuda"), cfg.learning_rate)["loss"])
    rel = abs(got - want) / abs(want)
    print(f"[cache] fused cached step loss {got:.8f} vs two-call "
          f"{want:.8f} (relative {rel:.3g})", flush=True)
    if not rel <= CACHE_TWO_CALL_RTOL:
        fail("cache: the fused cached step differs from the two-call path")


def cached_window(tag, exp, cache, fused, plans, k, epochs=CACHE_EPOCHS):
    """The cached path's steady state: after one warm epoch, ``epochs``
    epochs of the trainer's cached loop (``run_cached_epoch``: the plans
    of ``plans()``, whole K windows issued back to back, scalars read at
    each epoch's end), synchronised at both ends.  Returns ``step_s`` (s a
    draw), ``in_step_s`` (the host's time in the fused steps a draw), the
    window's ``steps``, and the fused step's device time on one uploaded
    plan: ``busy_ms`` and ``ops`` (``step_busy_ms``), which set
    ``idle_share`` = 1 - busy / step_s, and ``event_ms``
    (``step_event_ms``)."""
    import torch
    from multimodal_similarity_tpu_torch.train.cached_steps import (
        upload_plans)
    host = [0.0]

    def timed(plan, lr):
        t = time.perf_counter()
        out = fused(plan, lr)
        host[0] += time.perf_counter() - t
        return out

    exp.cfg.steps_per_dispatch = k
    lr = exp.cfg.learning_rate
    step = exp.run_cached_epoch(cache, timed, lr, 0, 0, plans=plans())
    torch.cuda.synchronize()
    host[0], start, t0 = 0.0, step, time.perf_counter()
    for _ in range(epochs):
        step = exp.run_cached_epoch(cache, timed, lr, step, 0, plans=plans())
    torch.cuda.synchronize()
    draws = epochs * cache.batches_per_epoch
    out = {"steps": step - start,
           "step_s": (time.perf_counter() - t0) / draws,
           "in_step_s": host[0] / draws}
    plan = upload_plans(plans()[0], "cuda")
    out["busy_ms"], out["ops"] = step_busy_ms(lambda: fused(plan, lr))
    out["event_ms"] = step_event_ms(lambda: fused(plan, lr))
    out["idle_share"] = 1.0 - out["busy_ms"] / 1e3 / out["step_s"]
    print(f"[{tag}] cached steady state (K={k}): {draws} draws "
          f"({out['steps']} optimizer steps) after a warm epoch; a draw (s): "
          f"step_s {out['step_s']:.4f}, in_step_s {out['in_step_s']:.4f}; "
          f"the step on the card: busy {out['busy_ms']:.3f} ms in "
          f"{out['ops']:.0f} operations (idle share {out['idle_share']:.3f}), "
          f"CUDA events {out['event_ms']:.3f} ms", flush=True)
    return out


def cache_phase(root, full_root):
    """Slice 8a on the card.  On the full-budget directory: the budget gate
    (the default 6 GB declines with the notice, CACHE_GB builds; a decline
    fails the run), the build's time, resident bytes and estimate; the
    gather card vs CPU; the fused cached step against the two-call path;
    the steady windows of ``base_model_batchhard --device_cache`` (K=1 and
    --steps_per_dispatch 4: one window an epoch) and ``multimodal_model
    --device_mining --device_cache`` beside the streamed ones of the same
    trainers; one epoch of the cached batch-hard (K=4), lifted and
    --no_normalized lifted trainers through ``train`` with their kernel
    launches.  On the 10-session directory: one epoch each of
    ``base_model``, ``multitask_model``, ``pddm_model``,
    ``cross_prediction`` (mean-pooled target) and ``unimodal_pretrain_sae``
    with --device_cache: finite losses, a cache gather a step, no
    ``csrc/`` launch."""
    import contextlib
    import io
    import random

    import torch
    from multimodal_similarity_tpu_torch.data import device_cache
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, use_triangular)
    from multimodal_similarity_tpu_torch.train.cached_steps import (
        make_cached_body_step)
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model, base_model_batchhard, base_model_lifted, cross_prediction,
        multimodal_model, multitask_model, pddm_model, unimodal_pretrain_sae)
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    from multimodal_similarity_tpu_torch.train.trainers._loop import (
        loader_batches)

    t_phase = time.time()
    none = dict.fromkeys(LAUNCHES, 0)
    cfg = full_width_cfg(full_root, "cache_bh", label_num=93,
                         device_cache=True, device_cache_gb=CACHE_GB)
    exp = HondaExperiment(cfg, result_dir=os.path.join(full_root, "r_cache"))
    est = device_cache.estimate_cache_bytes(exp.train_set)
    notice = io.StringIO()
    with contextlib.redirect_stdout(notice):
        declined = device_cache.DeviceFeatureCache.build(
            exp.train_set, n_seg=cfg.num_seg,
            sess_per_batch=cfg.sess_per_batch, event_budget=1000,
            seed=cfg.seed, device="cuda",
            budget_bytes=device_cache.cache_budget_bytes(6.0))
    print(f"[cache] default --device_cache_gb 6.0: "
          f"{notice.getvalue().strip()}", flush=True)
    if declined is not None or "falling back" not in notice.getvalue():
        fail("cache: the default budget did not decline the full-budget "
             "directory")
    device_cache.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    cache = exp.build_cache("cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    if cache is None:
        fail(f"cache: the build declined at --device_cache_gb {CACHE_GB}")
    print(f"[cache] built {len(exp.train_set)} sessions in {build_s:.2f} s "
          f"(page cache warm): {cache.device_bytes} bytes resident, "
          f"{cache.shard_rows} events x {cache.max_frames} frames, estimate "
          f"{est} bytes; {cache.batches_per_epoch} batches an epoch",
          flush=True)
    two_call_vs_fused(cache, cfg)

    # steady windows: batch-hard cached (K=1, K=4) and streamed
    device = torch.device("cuda")
    model = build_encoder(
        cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
        n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
        keep_prob=cfg.keep_prob,
        generator=torch.Generator().manual_seed(0),
        dropout_generator=torch.Generator(device="cuda").manual_seed(1)
    ).cuda()
    opt = build_optimizer("ADAM", model, cfg.learning_rate)
    fused = base_model_batchhard.make_cached_balanced_step(
        model, opt, cfg, cache,
        torch.Generator(device="cuda").manual_seed(2))
    sel_rng = random.Random(0)
    times = {}
    for k in (1, 4):
        times[f"bh-cached-k{k}"] = cached_window(
            f"bh-cached-k{k}", exp, cache, fused,
            lambda: base_model_batchhard.cached_selections(
                cache, cfg.batch_size, sel_rng), k)
    step = base_model_batchhard.make_balanced_batch_step(model, opt, cfg)
    times["bh-streamed"] = steady_step(
        "bh-streamed", cfg, ("events", "labels"),
        lambda b: step(b["events"], b["labels"], cfg.learning_rate),
        base_model_batchhard.balanced_batches(exp, cfg.batch_size,
                                              random.Random(0)),
        CACHE_WARM, CACHE_DRAWS)
    exp.close()
    del cache, fused, step, model, opt
    torch.cuda.empty_cache()

    # the flagship: its three-modality cache, the gather card vs CPU, its
    # cached and streamed windows
    mcfg = full_width_cfg(full_root, "cache_mm", feat=MM_FEATS,
                          lambda_multimodal=0.1, multimodal_epochs=0,
                          num_negative=5, triplet_per_batch=200,
                          label_num=93, no_joint=True, device_cache=True,
                          device_cache_gb=CACHE_GB)
    mexp = HondaExperiment(mcfg, modalities=MM_FEATS.split(","),
                           result_dir=os.path.join(full_root, "r_cache_mm"))
    mcache = mexp.build_cache("cuda")
    if mcache is None:
        fail("cache: the flagship's build declined")
    gather_on_card_vs_cpu(mcache)
    mm = multimodal_model.build_model(mcfg, device, sensors=8, segment=357)
    mopt = multimodal_model.mm_optimizer(mcfg, mm)
    mfused = multimodal_model.make_mm_fused_step(
        mm, mopt, mcfg, torch.Generator(device="cuda").manual_seed(0))
    cm = multimodal_model.margin_table({0: [0.5]}, device)
    mcached = make_cached_body_step(
        lambda ev, lab, m, lr: mfused(*ev, lab, m, cm, 1.0, lr), mcache,
        torch.Generator(device="cuda").manual_seed(3))
    times["mm-cached"] = cached_window(
        "mm-cached", mexp, mcache, mcached,
        lambda: [p["packed"] for p in mcache.epoch_plans()], 1)
    times["mm-streamed"] = steady_step(
        "mm-streamed", mcfg, ("events", "events2", "events3", "labels",
                              "mask"),
        lambda b: mfused(b["events"], b["events2"], b["events3"],
                         b["labels"], b["mask"], cm, 1.0,
                         mcfg.learning_rate),
        loader_batches(mexp), CACHE_WARM, CACHE_DRAWS)
    mexp.close()
    del mcache, mcached, mfused, mm, mopt
    torch.cuda.empty_cache()
    print(f"[cache] steady state (s a draw) {json.dumps(times)}", flush=True)

    # the cached paths through the trainers' entry points, with their
    # kernel launches: batch-hard (K3 or K1 with winners a step), lifted
    # normalised (K6 and K5) and not (K4 and K5)
    launches = {}
    runs = (("bh", base_model_batchhard.train, {"steps_per_dispatch": 4}),
            ("lifted", base_model_lifted.train, {}),
            ("lifted-raw", base_model_lifted.train, {"normalized": False}))
    for tag, train_fn, kw in runs:
        device_cache.reset_counts()
        rcfg = full_width_cfg(full_root, f"cache_{tag}", label_num=93,
                              max_epochs=1, device_cache=True,
                              device_cache_gb=CACHE_GB, **kw)
        res, got, n_val, _, _, _ = drive_trainer(
            full_root, f"cache-{tag}", train_fn, rcfg)
        if device_cache.COUNTS != {"build": 1, "gather": res.step}:
            fail(f"cache-{tag}: cache counts {device_cache.COUNTS} for "
                 f"{res.step} steps")
        if tag == "bh":
            tri = use_triangular(rcfg.batch_size, rcfg.emb_dim, sm_count())
            name = "batch_hard_tri_idx" if tri else "batch_hard_stats_idx"
            want = {name: res.step}
        elif tag == "lifted":
            want = {"lifted_fwd_tri": res.step + n_val,
                    "lifted_bwd": res.step, "lifted_fwd": 0}
        else:
            want = {"lifted_fwd": res.step + n_val, "lifted_bwd": res.step,
                    "lifted_fwd_tri": 0}
        expect_launches(f"cache-{tag}", got, want)
        launches[tag] = {k: v for k, v in got.items() if v}
        del res
    print(f"[launches] cached paths: {json.dumps(launches)}", flush=True)

    # the other trainers with a cached feed, on the 10-session directory
    others = (
        ("base-model", base_model.train, full_width_cfg(
            root, "cache_base", triplet_select="facenet",
            triplet_per_batch=200, num_negative=5, max_epochs=1), "loss"),
        ("multitask", multitask_model.train, full_width_cfg(
            root, "cache_multitask", lambda_ver=0.1, triplet_per_batch=200,
            max_epochs=1), "ver_loss"),
        ("pddm", pddm_model.train, pair_cfg(
            root, "cache_pddm", feat="sensors", n_input=8, label_num=93),
         "pddm_loss"),
        ("cross", cross_prediction.train, full_width_cfg(
            root, "cache_cross", feat="resnet,sensors", max_epochs=1,
            static_epochs=500), "mse"),
        ("sae", unimodal_pretrain_sae.train, pair_cfg(
            root, "cache_sae", feat="sensors", n_input=8, emb_dim=128,
            label_num=93), "mse"))
    for tag, train_fn, ocfg, key in others:
        ocfg.device_cache, ocfg.device_cache_gb = True, CACHE_GB
        device_cache.reset_counts()
        res, got, cols = drive_plain(root, f"cache-{tag}", train_fn, ocfg,
                                     (key,))
        expect_launches(f"cache-{tag}", got, none)
        if device_cache.COUNTS != {"build": 1, "gather": res.step}:
            fail(f"cache-{tag}: cache counts {device_cache.COUNTS} for "
                 f"{res.step} steps")
        print(f"[cache-{tag}] {res.step} cached steps, {key} "
              f"{[round(v, 6) for v in cols[key]]}", flush=True)
        del res
    print(f"[cache] phase 18 {time.time() - t_phase:.1f} s", flush=True)


# phase 19: run control and the process group on the card
RC_PROFILE_STEPS = 3
RC_WATCHDOG_SECS = 2.0
RC_STALL_S = 4.0
RC_RING_N, RC_RING_D = 1024, 256
RC_DP_EVENTS, RC_DP_TRIPLETS = 1000, 200
RC_RTOL = 1e-5


def trace_device_ops(path):
    """The device events of a Chrome trace: (name, category, µs)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e.get("cat", ""), float(e.get("dur", 0.0)))
            for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def profile_run(root, steady_root):
    """``base_model_batchhard --profile_dir --profile_steps 3`` for one
    epoch on the 40-session directory at base_model's width: the trace
    holds one K3 winner-tracking tile walk (``batch_hard_tri_tc``) a
    profiled step; prints its five longest device operations and the step
    interval inside the window beside the one after it."""
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    prof_dir = os.path.join(root, "profile")
    cfg = full_width_cfg(steady_root, "rc_profile", max_epochs=1,
                         profile_dir=prof_dir,
                         profile_steps=RC_PROFILE_STEPS)
    t0 = time.time()
    res = base_model_batchhard.train(
        cfg, result_dir=os.path.join(root, "rc_profile"))
    wall = time.time() - t0
    traces = sorted(os.listdir(prof_dir))
    if len(traces) != 1:
        fail(f"profile: {len(traces)} trace files in {prof_dir}")
    ops = trace_device_ops(os.path.join(prof_dir, traces[0]))
    k3 = [o for o in ops if "batch_hard_tri_tc" in o[0]]
    print(f"[rc-profile] {res.step} steps in {wall:.1f} s; trace "
          f"{traces[0]}: {len(ops)} device operations, "
          f"{len(k3)} batch_hard_tri_tc launches", flush=True)
    if len(k3) != RC_PROFILE_STEPS:
        fail(f"profile: {len(k3)} batch_hard_tri_tc launches in the trace, "
             f"want one for each of {RC_PROFILE_STEPS} profiled steps")
    busy = sum(o[2] for o in ops)
    for name, cat, dur in sorted(ops, key=lambda o: -o[2])[:5]:
        print(f"[rc-profile] longest device op {dur / 1e3:.4f} ms "
              f"({100 * dur / busy:.1f}% of the window's device time) "
              f"{cat} {name[:110]}", flush=True)
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    stamps = {r["step"]: r["time"] for r in recs if "loss" in r}
    first = int(traces[0].split("steps")[1].split("-")[0])
    last = first + RC_PROFILE_STEPS - 1
    inside = [stamps[s] - stamps[s - 1] for s in range(first, last + 1)]
    after = [stamps[s] - stamps[s - 1] for s in sorted(stamps)
             if s > last + 1]
    print(f"[rc-profile] step interval (host enqueue to enqueue, s) inside "
          f"the window {json.dumps([round(x, 4) for x in inside])} mean "
          f"{sum(inside) / len(inside):.4f}; after it "
          f"{json.dumps([round(x, 4) for x in after])} mean "
          f"{sum(after) / max(len(after), 1):.4f}; device busy "
          f"{busy / 1e3:.3f} ms over the window", flush=True)


def watchdog_run(root):
    """``--watchdog_secs 2`` with the second step stalled past it (a
    phase-local wrapper of the step sleeps): the thread dump is printed,
    the stop requested, that exact step checkpointed and the run ends; a
    rerun with ``--model_path`` restores that step and goes on from it."""
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.train.checkpoints import (
        load_checkpoint)
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    real = base_model_batchhard.make_balanced_batch_step
    calls = []

    def stalled(*a, **k):
        step = real(*a, **k)

        def run(*sa, **sk):
            out = step(*sa, **sk)
            calls.append(1)
            if len(calls) == 2:
                import torch
                torch.cuda.synchronize()
                time.sleep(RC_STALL_S)
            return out
        return run

    cfg = full_width_cfg(root, "rc_watchdog", max_epochs=50,
                         watchdog_secs=RC_WATCHDOG_SECS)
    # the dump is written to file descriptor 2 (faulthandler), so the run's
    # stderr goes to a file for the check, and is printed after
    err_path = os.path.join(root, "rc_watchdog.stderr")
    saved = os.dup(2)
    base_model_batchhard.make_balanced_batch_step = stalled
    try:
        with open(err_path, "w") as err:
            sys.stderr.flush()
            os.dup2(err.fileno(), 2)
            try:
                res = base_model_batchhard.train(
                    cfg, result_dir=os.path.join(root, "rc_watchdog"))
            finally:
                sys.stderr.flush()
                os.dup2(saved, 2)
    finally:
        os.close(saved)
        base_model_batchhard.make_balanced_batch_step = real
    with open(err_path) as f:
        dump = f.read()
    sys.stderr.write(dump)
    if "watchdog: no step completed" not in dump or \
            "thread dump" not in dump or "File" not in dump:
        fail("watchdog: no thread dump was printed")
    if res.step != 2:
        fail(f"watchdog: the run stopped at step {res.step}, not at the "
             "stalled step 2")
    ckpt = os.path.join(res.result_dir, "rc_watchdog.ckpt-2")
    model = build_encoder(cfg.network, num_seg=cfg.num_seg,
                          emb_dim=cfg.emb_dim, n_input=cfg.n_input,
                          n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C).cuda()
    if load_checkpoint(ckpt, model) != 2:
        fail("watchdog: the checkpoint does not hold step 2")
    resumed = base_model_batchhard.train(
        full_width_cfg(root, "rc_resumed", max_epochs=2, model_path=ckpt),
        result_dir=os.path.join(root, "rc_resumed"))
    recs = [json.loads(line) for line in
            open(os.path.join(resumed.result_dir, "metrics.jsonl"))]
    first = min(r["step"] for r in recs if "loss" in r)
    print(f"[rc-watchdog] stalled step 2 for {RC_STALL_S} s under a "
          f"{RC_WATCHDOG_SECS} s deadline: thread dump printed, stopped and "
          f"checkpointed at step {res.step}; the rerun with --model_path "
          f"restored step 2 and logged steps {first}-{resumed.step}",
          flush=True)
    if first != 3:
        fail(f"watchdog: the resumed run's first step is {first}, not 3")


def sigterm_run(root):
    """SIGTERM to ``python -m multimodal_similarity_tpu_torch
    train.base_model_batchhard --device cuda`` once its metrics show two
    steps: rc 0, the preemption line, and a checkpoint of that step."""
    import glob
    import re
    import signal
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.train.checkpoints import (
        load_checkpoint)
    cfg = full_width_cfg(root, "rc_sigterm")
    args = [sys.executable, "-m", "multimodal_similarity_tpu_torch",
            "train.base_model_batchhard", "--device", "cuda",
            "--DATA_ROOT", root, "--name", "rc_sigterm",
            "--max_epochs", "100000", "--log_flush_every", "1",
            "--silent_mode"]
    for key in ("feat", "network", "n_input", "n_h", "n_w", "n_C",
                "emb_dim", "num_seg", "batch_size", "event_per_batch",
                "sess_per_batch", "label_num", "static_epochs",
                "learning_rate", "keep_prob", "optimizer", "alpha"):
        args += [f"--{key}", str(getattr(cfg, key))]
    t0 = time.time()
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=HERE)
    try:
        pattern = os.path.join(root, "results", "rc_sigterm_*",
                               "metrics.jsonl")
        while True:
            files = glob.glob(pattern)
            if files and sum('"loss"' in line for line in open(files[0])) \
                    >= 2:
                break
            if proc.poll() is not None:
                fail("sigterm: the trainer exited before two steps:\n"
                     + proc.communicate()[0])
            if time.time() - t0 > 300:
                fail("sigterm: no two steps logged in 300 s")
            time.sleep(0.05)
        t_sig = time.time()
        os.kill(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    m = re.search(r"preemption signal: checkpointed at step (\d+)", out)
    if proc.returncode != 0 or not m:
        fail(f"sigterm: rc {proc.returncode}, no preemption line:\n{out}")
    step = int(m.group(1))
    (ckpt,) = glob.glob(os.path.join(root, "results", "rc_sigterm_*",
                                     f"rc_sigterm.ckpt-{step}"))
    model = build_encoder(cfg.network, num_seg=cfg.num_seg,
                          emb_dim=cfg.emb_dim, n_input=cfg.n_input,
                          n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C).cuda()
    if load_checkpoint(ckpt, model) != step:
        fail(f"sigterm: the checkpoint does not hold step {step}")
    print(f"[rc-sigterm] signalled after {t_sig - t0:.1f} s; exited rc 0 "
          f"{time.time() - t_sig:.2f} s later: 'preemption signal: "
          f"checkpointed at step {step}', the checkpoint holds step {step}",
          flush=True)


def rel_close(tag, got, want, rtol=RC_RTOL):
    import torch
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= rtol * max(scale,
                                                                 1e-30)):
        fail(f"{tag}: max_abs_err {err} > {rtol} x {scale}")
    return err / max(scale, 1e-30)


def ring_checks(mesh, gen):
    """The rings at world 1 over NCCL against the f32 kernels on the same
    card inputs (N=1024, d=256, bench.py's shape): batch-hard stats and the
    ring loss's gradient against K1 (``batch_hard_stats_kernel``; fp, cn
    and the gradient rtol 1e-5, nc equal, winners equal on exact inputs),
    the lifted ring's forward and gradient against K4 and K5 at
    ``check_lifted``'s tolerances; each ring's forward plus backward time
    beside the kernel path's (CUDA events)."""
    import torch
    from multimodal_similarity_tpu_torch.ops.kernels import (
        batch_hard_fused, lifted_loss_fused)
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands, stats_kernel)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        lifted_bwd_kernel, lifted_fwd_kernel)
    from multimodal_similarity_tpu_torch.parallel import (
        make_ring_batch_hard_loss, make_ring_lifted_loss,
        make_ring_lifted_stats_grad)
    from multimodal_similarity_tpu_torch.parallel.ring_mining import (
        _ring_stats)
    n, d = RC_RING_N, RC_RING_D
    for kind in ("int", "float"):
        emb, labels, _ = make_case(n, d, kind, gen, n_classes=64)
        ones = torch.ones(n, device=emb.device)
        fp, cn, nc, fpi, cni = stats_kernel(
            prep_operands(emb, labels, ones, "f32"), True)
        rfp, rfpi, rcn, rcni, rnc = _ring_stats(mesh, emb, labels, True)
        torch.cuda.synchronize()
        e1 = rel_close(f"ring {kind} fp", rfp, fp)
        e2 = rel_close(f"ring {kind} cn", rcn, cn)
        if not torch.equal(rnc, nc):
            fail(f"ring {kind}: negative counts differ from K1")
        wrong = int((rfpi != fpi.long()).sum() + (rcni != cni.long()).sum())
        if kind == "int" and wrong:
            fail(f"ring int: {wrong} winners differ from K1 on exact inputs")
        x = emb.clone().requires_grad_(True)
        batch_hard_fused(x, labels, "soft", precision="f32",
                         algo="row")[0].backward()
        y = emb.clone().requires_grad_(True)
        make_ring_batch_hard_loss(mesh, "soft")(y, labels)[0].backward()
        e3 = rel_close(f"ring {kind} gradient", y.grad, x.grad)
        print(f"[rc-ring] batch-hard N={n} d={d} {kind}: fp rel {e1:.3g}, "
              f"cn rel {e2:.3g} (rtol {RC_RTOL}), nc equal, "
              f"{wrong} winner mismatches, loss gradient rel {e3:.3g}",
              flush=True)
    emb, labels, _ = make_case(n, d, "float", gen, n_classes=64)
    valid = (torch.rand(n, generator=gen) >= 0.1).float().cuda()
    ops = prep_operands(emb, labels, valid, "f32")
    tol = 1e-4 * max(1.0, d / 128)
    fp, cn, nc = lifted_fwd_kernel(ops, MARGIN)
    g_fp = torch.rand(n, device=emb.device) - 0.3
    g_cn = torch.rand(n, device=emb.device) - 0.3
    g_k = lifted_bwd_kernel(ops, fp, cn, g_fp, g_cn, MARGIN)
    y = emb.clone().requires_grad_(True)
    rfp, rcn, rnc = make_ring_lifted_stats_grad(mesh, MARGIN)(y, labels,
                                                              valid)
    ((rfp * g_fp).sum() + (rcn * g_cn).sum()).backward()
    rfp, rcn = rfp.detach(), rcn.detach()
    torch.cuda.synchronize()
    err = max(float((rfp - fp).abs().max()), float((rcn - cn).abs().max()))
    gerr = float((y.grad - g_k).abs().max())
    gtol = tol * max(float(g_k.abs().max()), 1.0)
    if not torch.equal(rnc, nc) or err > tol or gerr > gtol:
        fail(f"lifted ring vs K4/K5: stats err {err} (tol {tol}), gradient "
             f"err {gerr} (tol {gtol}), nc equal {torch.equal(rnc, nc)}")
    print(f"[rc-ring] lifted N={n} d={d} f32, 10% invalid: stats vs K4 "
          f"max_abs_err {err:.3g} (tol {tol:.3g}), gradient vs K5 "
          f"{gerr:.3g} (tol {gtol:.3g}), nc equal", flush=True)

    def fwd_bwd(loss_fn):
        def run():
            x = emb.clone().requires_grad_(True)
            loss_fn(x)[0].backward()
        return run

    ring_bh = make_ring_batch_hard_loss(mesh, "soft")
    ring_lt = make_ring_lifted_loss(mesh, MARGIN)
    times = {
        "batch-hard ring": call_ms(fwd_bwd(lambda x: ring_bh(x, labels))),
        "batch-hard K1 f32 (row)": call_ms(fwd_bwd(
            lambda x: batch_hard_fused(x, labels, "soft", precision="f32",
                                       algo="row"))),
        "lifted ring": call_ms(fwd_bwd(lambda x: ring_lt(x, labels))),
        "lifted K4+K5 f32": call_ms(fwd_bwd(
            lambda x: lifted_loss_fused(x, labels, MARGIN,
                                        precision="f32"))),
    }
    rounded = {k: round(v, 4) for k, v in times.items()}
    print(f"[rc-ring] forward + backward ms at N={n} d={d} (CUDA events, "
          f"world 1): {json.dumps(rounded)}", flush=True)


def dp_check(mesh, root):
    """``make_dp_triplet_step`` at world 1 against the single-device fused
    semi-hard step at base_model's width (``full_width_cfg``: ConvRTSN on
    8x8x1536 maps, emb_dim 128, keep_prob 0.5; 1000 events, 200 triplets,
    5 negatives) from the same parameters and the same mining and dropout
    draws: loss and every updated parameter within rtol 1e-5."""
    import torch
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.parallel import make_dp_triplet_step
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.steps import (
        make_triplet_train_step)
    cfg = full_width_cfg(root, "rc_dp")
    gen = torch.Generator(device="cuda").manual_seed(19)
    events = torch.randn((RC_DP_EVENTS, cfg.num_seg, cfg.n_h, cfg.n_w,
                          cfg.n_input), device="cuda", generator=gen)
    labels = torch.randint(1, 12, (RC_DP_EVENTS,), device="cuda",
                           generator=gen)
    mask = (torch.arange(RC_DP_EVENTS, device="cuda")
            < RC_DP_EVENTS - 30).float()
    runs = {}
    for tag in ("dp", "single"):
        model = build_encoder(
            cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
            n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
            keep_prob=cfg.keep_prob,
            generator=torch.Generator().manual_seed(7),
            dropout_generator=torch.Generator(device="cuda").manual_seed(8)
        ).cuda()
        opt = build_optimizer("ADAM", model, cfg.learning_rate)
        kw = dict(triplet_per_batch=RC_DP_TRIPLETS, alpha=0.2,
                  num_negative=5, lambda_l2=1e-3)
        mine = torch.Generator(device="cuda").manual_seed(9)
        step = (make_dp_triplet_step(model, opt, mesh, generator=mine, **kw)
                if tag == "dp" else
                make_triplet_train_step(model, opt, generator=mine, **kw))
        aux = step(events, labels, mask, cfg.learning_rate)
        runs[tag] = (aux, dict(model.named_parameters()))
    (aux_dp, p_dp), (aux_one, p_one) = runs["dp"], runs["single"]
    rel_close("dp step loss", aux_dp["loss"][None], aux_one["loss"][None])
    worst = max(rel_close(f"dp step {name}", p_dp[name].detach(),
                          p.detach()) for name, p in p_one.items())
    if float(aux_dp["triplet_num"]) != float(aux_one["triplet_num"]):
        fail("dp step: the mined triplet counts differ")
    print(f"[rc-dp] make_dp_triplet_step (world 1, NCCL) vs the fused "
          f"semi-hard step: loss {float(aux_dp['loss']):.6f} vs "
          f"{float(aux_one['loss']):.6f}, {float(aux_dp['triplet_num']):.0f} "
          f"triplets, worst parameter rel {worst:.3g} (rtol {RC_RTOL})",
          flush=True)


def run_control_phase(root, steady_root):
    """Phase 19: ``--profile_dir``, ``--watchdog_secs`` and SIGTERM on the
    batch-hard trainer, then a one-rank NCCL process group: the rings and
    the data-parallel step against the kernels and the single-device step,
    and the stop decision's all-reduce."""
    import torch
    import torch.distributed as dist
    from multimodal_similarity_tpu_torch.parallel import create_mesh
    from multimodal_similarity_tpu_torch.utils import preemption
    t0 = time.time()
    profile_run(root, steady_root)
    watchdog_run(root)
    sigterm_run(root)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(root, 'rc_pg')}",
        world_size=1, rank=0)
    try:
        mesh = create_mesh(1)
        if mesh.device.type != "cuda":
            fail(f"NCCL mesh on {mesh.device}")
        ring_checks(mesh, torch.Generator().manual_seed(190))
        dp_check(mesh, root)
        guard = preemption.PreemptionGuard()
        # a process count of 2 makes sync_should_stop run the collective,
        # which it skips for a single process; the group itself is world 1
        if preemption.any_process(False) or \
                preemption.sync_should_stop(guard, 2, step=1, every=1):
            fail("sync_should_stop: a stop no process asked for")
        guard.request_stop()
        if not preemption.sync_should_stop(guard, 2, step=1, every=1):
            fail("sync_should_stop: the stop was not seen over NCCL")
        print("[rc-nccl] sync_should_stop(every=1): all_reduce(MAX) of the "
              "flag over the one-rank NCCL group, False then True",
              flush=True)
    finally:
        dist.destroy_process_group()
    print(f"[rc] phase 19 took {time.time() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 20, slice 8c-ii: sharded retrieval, the mesh cache and the flagship
# on a process group
# ---------------------------------------------------------------------------

# the world-1 sharded index against the index without a mesh: distances,
# relative
SH_INDEX_RTOL = 1e-6
# the flagship on the one-rank mesh against the single-device step: loss
# and every parameter, relative
SH_STEP_RTOL = 1e-5
# the cached flagship's window (--steps_per_dispatch)
SH_WINDOW = 2


def sharded_index_checks(mesh, device, card):
    """``RetrievalIndex`` on the one-rank mesh at phase 17's sizes (random
    unit rows of width 256, Q = 1024, top-10) against the index without
    one: f32 and int8 at 65,536 rows index-equal with distances within
    SH_INDEX_RTOL, f32 at 400,000 rows (the chunked walk) by
    ``same_topk``: sets equal where the 10th and 11th distances are apart,
    order equal where every neighbour is.  Each with its ms host to host
    (CUDA events around 5 queries) beside the unsharded index's."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.serving import RetrievalIndex
    gallery = unit_rows(INDEX_ROWS["chunked"], INDEX_DIM, 17, device)
    queries = unit_rows(INDEX_QUERIES, INDEX_DIM, 18, device)
    k = INDEX_K
    cells = {}
    for tag, n, int8 in (("dense", INDEX_ROWS["dense"], False),
                         ("int8", INDEX_ROWS["dense"], True),
                         ("chunked", INDEX_ROWS["chunked"], False)):
        out = {}
        for side, m in (("unsharded", None), ("mesh", mesh)):
            index = RetrievalIndex(INDEX_DIM, int8_gallery=int8, mesh=m,
                                   device=device)
            index.add(gallery[:n])
            index._gallery_on_device()
            ms = call_ms(lambda: index.query(queries, k=k), iters=5,
                         warmup=1)
            d, idx, _ = index.query(queries, k=k + 1)
            out[side] = (d, idx, ms)
            del index
            if device == "cuda":
                torch.cuda.empty_cache()
        (gd, gi, gms), (wd, wi, wms) = out["mesh"], out["unsharded"]
        bits = bool(np.array_equal(gi, wi) and np.array_equal(gd, wd))
        if tag == "chunked":
            checked = same_topk(f"sharded {tag}", (gd[:, :k], gi[:, :k]),
                                (wd[:, :k], wi[:, :k]), wd[:, k],
                                rtol=SH_INDEX_RTOL)
        else:
            if not np.array_equal(gi[:, :k], wi[:, :k]):
                fail(f"sharded {tag}: indices differ from the unsharded "
                     "index")
            np.testing.assert_allclose(gd, wd, rtol=SH_INDEX_RTOL,
                                       err_msg=f"sharded {tag}")
            checked = (INDEX_QUERIES, INDEX_QUERIES)
        cells[tag] = {"rows": n, "mesh_ms": round(gms, 4),
                      "unsharded_ms": round(wms, 4),
                      "bit_equal": bits, "rows_checked": checked}
        print(f"[p20] index {tag} at {n} rows, Q={INDEX_QUERIES} top-{k} "
              f"({card}): one-rank mesh {gms:.3f} ms vs unsharded "
              f"{wms:.3f} ms host to host; results bit-equal {bits}; "
              f"(set, order) rows checked {checked}", flush=True)
    return cells


def mesh_cache_checks(mesh, full_root, device, card):
    """The full-budget train sessions cached over the one-rank mesh and
    without it: the resident q, scale, seq_len and label table and the
    first epoch's plans bit-equal; both builds' times."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    cfg = full_width_cfg(full_root, "p20_cache", label_num=93,
                         device_cache=True, device_cache_gb=CACHE_GB)
    exp = HondaExperiment(cfg, result_dir=os.path.join(full_root, "r_p20"))
    try:
        caches, secs = {}, {}
        for side, m in (("unsharded", None), ("mesh", mesh)):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            caches[side] = exp.build_cache(device, mesh=m)
            if device == "cuda":
                torch.cuda.synchronize()
            secs[side] = time.perf_counter() - t0
            if caches[side] is None:
                fail(f"p20: the {side} cache build declined")
        a, b = caches["mesh"], caches["unsharded"]
        arrays = all(torch.equal(x, y) for x, y in
                     zip(a.step_operands(), b.step_operands()))
        plans = [(p["packed"], q["packed"]) for p, q in
                 zip(a.epoch_plans(), b.epoch_plans())]
        same_plans = (len(plans) == b.batches_per_epoch and
                      all(np.array_equal(p, q) for p, q in plans))
        print(f"[p20] cache of {len(exp.train_set)} full-budget sessions "
              f"({card}): built over the one-rank mesh in "
              f"{secs['mesh']:.2f} s, without it in {secs['unsharded']:.2f}"
              f" s (page cache warm), {a.device_bytes} bytes resident; q, "
              f"scale, seq_len, label table bit-equal {arrays}; "
              f"{len(plans)} plans of the first epoch bit-equal "
              f"{same_plans}", flush=True)
        if not (arrays and same_plans):
            fail("p20: the mesh cache differs from the unsharded one")
        return secs
    finally:
        exp.close()


def mesh_flagship_checks(mesh, full_root, device, card):
    """The fused flagship step at train_multimodal_model.sh's width
    (phase 18's configuration: ConvRTSN on 8x8x1536 maps, emb_dim 128,
    keep_prob 0.5, 200 triplets, 5 negatives) on one full-budget batch,
    run on the one-rank mesh and without it from the same weights and
    draws: loss and every parameter within SH_STEP_RTOL; then the cached
    flagship over the mesh cache and the unsharded one for two
    SH_WINDOW-step windows: each step's loss and the parameters after
    them within SH_STEP_RTOL.  ms a draw of each path (CUDA events around
    3 steps; the second window's host time with a synchronise)."""
    import torch
    from multimodal_similarity_tpu_torch.train.cached_steps import (
        dispatch_plan_window, make_cached_body_step)
    from multimodal_similarity_tpu_torch.train.trainers import (
        multimodal_model)
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    mcfg = full_width_cfg(full_root, "p20_mm", feat=MM_FEATS,
                          lambda_multimodal=0.1, multimodal_epochs=0,
                          num_negative=5, triplet_per_batch=200,
                          label_num=93, no_joint=True, device_cache=True,
                          device_cache_gb=CACHE_GB)
    mexp = HondaExperiment(mcfg, modalities=MM_FEATS.split(","),
                           result_dir=os.path.join(full_root, "r_p20_mm"))
    lr = mcfg.learning_rate
    cm = multimodal_model.margin_table({0: [0.5]}, torch.device(device))
    out = {}
    try:
        batch = first_batch(mexp)
        args = [torch.from_numpy(batch[k]).to(device) for k in (
            "events", "events2", "events3", "labels", "mask")]

        def model_and_step(m):
            model = multimodal_model.build_model(
                mcfg, torch.device(device), sensors=MM_MODALITIES[
                    "sensors"][0], segment=MM_MODALITIES["segment"][0])
            opt = multimodal_model.mm_optimizer(mcfg, model)
            gen = torch.Generator(device=device).manual_seed(20)
            return model, multimodal_model.make_mm_fused_step(
                model, opt, mcfg, gen, mesh=m)

        runs = {}
        for side, m in (("mesh", mesh), ("unsharded", None)):
            model, step = model_and_step(m)
            aux = step(*args, cm, 1.0, lr)
            runs[side] = (aux["loss"].detach().clone(), {
                k: p.detach().clone() for k, p in model.named_parameters()})
            runs[side] += (call_ms(lambda: step(*args, cm, 1.0, lr),
                                   iters=3, warmup=1),)
            del model, step
        (gl, gp, gms), (wl, wp, wms) = runs["mesh"], runs["unsharded"]
        rel = rel_close("p20 fused step loss", gl[None], wl[None],
                        SH_STEP_RTOL)
        worst = max(rel_close(f"p20 fused step {k}", gp[k], wp[k],
                              SH_STEP_RTOL) for k in wp)
        out["fused"] = {"mesh_ms": round(gms, 3), "unsharded_ms":
                        round(wms, 3), "loss_rel": rel, "param_rel": worst}
        print(f"[p20] fused flagship step on a full-budget batch "
              f"({int(batch['num_events'])} real events, {card}): loss "
              f"{float(gl):.6f} on the one-rank mesh vs {float(wl):.6f} "
              f"(rel {rel:.3g}), worst parameter rel {worst:.3g} (rtol "
              f"{SH_STEP_RTOL}); {gms:.3f} vs {wms:.3f} ms a draw",
              flush=True)
        del runs, args

        cached = {}
        for side, m in (("mesh", mesh), ("unsharded", None)):
            cache = mexp.build_cache(device, mesh=m)
            if cache is None:
                fail(f"p20: the flagship's {side} cache declined")
            model, step = model_and_step(m)
            fused = make_cached_body_step(
                lambda ev, lab, mask, lr_, step=step: step(
                    *ev, lab, mask, cm, 1.0, lr_),
                cache, torch.Generator(device=device).manual_seed(21))
            # a warm window, then the timed one
            plans = [p["packed"] for p in cache.epoch_plans()]
            aux = dispatch_plan_window(plans[:SH_WINDOW], lr, fused=fused,
                                       device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux += dispatch_plan_window(plans[SH_WINDOW:2 * SH_WINDOW], lr,
                                        fused=fused, device=device)
            losses = torch.stack([a["loss"] for a in aux])
            if device == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SH_WINDOW
            cached[side] = (losses, {k: p.detach().clone() for k, p in
                                     model.named_parameters()}, ms)
            del cache, model, step, fused
            if device == "cuda":
                torch.cuda.empty_cache()
        (gl, gp, gms), (wl, wp, wms) = cached["mesh"], cached["unsharded"]
        rel = rel_close("p20 cached window losses", gl, wl, SH_STEP_RTOL)
        worst = max(rel_close(f"p20 cached window {k}", gp[k], wp[k],
                              SH_STEP_RTOL) for k in wp)
        out["cached"] = {"mesh_ms": round(gms, 3), "unsharded_ms":
                         round(wms, 3), "loss_rel": rel, "param_rel": worst}
        print(f"[p20] cached flagship, two {SH_WINDOW}-step windows "
              f"({card}): losses {[round(float(v), 6) for v in gl]} on the "
              f"one-rank mesh (rel {rel:.3g} of the unsharded cache's), "
              f"worst parameter rel {worst:.3g}; {gms:.3f} vs {wms:.3f} ms "
              "a draw (host, the second window)", flush=True)
    finally:
        mexp.close()
    return out


def sharded_phase(root, full_root, device="cuda"):
    """Phase 20: a one-rank process group (NCCL on the card, as phase 19's)
    and on its mesh the sharded retrieval index, the mesh-sharded cache of
    the full-budget sessions and the flagship's data-parallel fused and
    cached steps, each against its path without a mesh.  No ``csrc/``
    kernel runs on these paths."""
    import torch
    import torch.distributed as dist
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    from multimodal_similarity_tpu_torch.parallel import create_mesh
    t0 = time.time()
    card = card_line() if device == "cuda" else "cpu"
    reset_launch_counts()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"file://{os.path.join(root, 'p20_pg')}",
        world_size=1, rank=0)
    try:
        mesh = create_mesh(1)
        if mesh.device.type != torch.device(device).type:
            fail(f"p20: the mesh is on {mesh.device}")
        out = {"index": sharded_index_checks(mesh, device, card),
               "cache_s": mesh_cache_checks(mesh, full_root, device, card),
               "flagship": mesh_flagship_checks(mesh, full_root, device,
                                                card)}
    finally:
        dist.destroy_process_group()
    expect_launches("p20", dict(LAUNCHES), dict.fromkeys(LAUNCHES, 0))
    print(f"[p20] phase 20 {time.time() - t0:.1f} s ({card}): "
          f"{json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# slice 9: per-frame feature extraction on the card
# ---------------------------------------------------------------------------

# the slim trunks' parameter counts (the JAX package's test tables)
TOWER_PARAMS = {"inception_resnet_v2": 54_276_192, "inception_v1": 5_592_624}
# card vs CPU on the same weights and inputs, TF32 off: the largest
# element difference over the output's largest magnitude
TOWER_RTOL = 1e-4
# the two-stage pipeline against the single-stage forward on the card: the
# same, with cuDNN free to pick other algorithms at the microbatch's size
PIPE_RTOL = 1e-4
FRAME_HW = (720, 1280)          # the Honda camera's native frames
FEAT_BATCH = 32                 # extract_sessions' batch
FEAT_TIMED = 5                  # timed batches a setting
PIPE_MICROBATCH = 8
P21_SESSIONS, P21_FRAMES = 3, 240


def rel_delta(got, want):
    """The largest element difference over ``want``'s largest magnitude."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def towers_on_card():
    """Each slim tower at full width from a seeded generator: its
    parameter count, and a 2-image batch at its slim size on the card
    against the CPU forward of the same weights (TF32 off)."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.models import (
        InceptionResNetV2, InceptionV1)
    out = {}
    for name, cls, size in (("inception_resnet_v2", InceptionResNetV2, 299),
                            ("inception_v1", InceptionV1, 224)):
        model = cls(generator=torch.Generator().manual_seed(21)).eval()
        n = sum(p.numel() for p in model.parameters())
        if n != TOWER_PARAMS[name]:
            fail(f"p21: {name} has {n} parameters, not {TOWER_PARAMS[name]}")
        x = torch.from_numpy(np.random.RandomState(21).uniform(
            -1, 1, (2, 3, size, size)).astype(np.float32))
        with torch.no_grad():
            want = model(x)
            model.cuda()
            got = model(x.cuda()).cpu()
        err = rel_delta(got, want)
        out[name] = {"params": n, "shape": list(got.shape), "rel": err}
        if not (err <= TOWER_RTOL and bool(torch.isfinite(got).all())):
            fail(f"p21: {name} card vs CPU {err:.3g} > {TOWER_RTOL:g}")
        del model
    print(f"[p21] towers at full width, card vs CPU (TF32 off, tol "
          f"{TOWER_RTOL:g}): {json.dumps(out)}", flush=True)
    return out


def fake_slim_npz(path, seed=21):
    """A slim checkpoint of the Inception-ResNet-v2 trunk made from the
    seed, one variable for every parameter and running statistic: kernels
    [kh, kw, in, out] of variance 1 / fan-in, betas and biases of a tenth,
    moving means of a fifth, moving variances in [0.5, 2]."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.models import InceptionResNetV2
    with torch.device("meta"):
        state = InceptionResNetV2().state_dict()
    rng = np.random.default_rng(seed)
    slim = {}
    for key, t in state.items():
        scope, leaf = key.rsplit(".", 1)
        scope = scope.rsplit(".", 1)[-1]        # units.<i>.<scope>
        shape = tuple(t.shape)
        if leaf == "weight":
            o, i, kh, kw = shape
            name = f"{scope}/weights"
            arr = rng.standard_normal((kh, kw, i, o), np.float32) \
                / np.float32(np.sqrt(kh * kw * i))
        elif leaf == "bias" and scope.endswith("_BatchNorm"):
            name = f"{scope[:-10]}/BatchNorm/beta"
            arr = 0.1 * rng.standard_normal(shape, np.float32)
        elif leaf == "bias":
            name = f"{scope}/biases"
            arr = 0.1 * rng.standard_normal(shape, np.float32)
        elif leaf == "running_mean":
            name = f"{scope[:-10]}/BatchNorm/moving_mean"
            arr = 0.2 * rng.standard_normal(shape, np.float32)
        else:
            name = f"{scope[:-10]}/BatchNorm/moving_variance"
            arr = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        slim[f"InceptionResnetV2/{name}"] = arr
    np.savez(path, **slim)
    return len(slim)


def seeded_frames(n, seed):
    """``n`` uint8 noise frames in [0, 120) at FRAME_HW from the seed."""
    import numpy as np
    return np.random.RandomState(seed).randint(
        0, 120, (n,) + FRAME_HW + (3,)).astype(np.uint8)


def extraction_rates(npz, card):
    """slim_backbone on the card with the slim graft: 2 frames against the
    CPU's embed_fn on the same checkpoint, then ms a batch of FEAT_BATCH
    720 x 1280 frames (upload, antialiased resize to 299, forward,
    readback; CUDA events) with TF32 off and on.  Returns (embed_fn, the
    timed frames, rates)."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.preprocess.features import (
        slim_backbone)
    t0 = time.time()
    embed = slim_backbone("inception_resnet_v2", npz, device="cuda")
    graft_s = time.time() - t0
    host = slim_backbone("inception_resnet_v2", npz, device="cpu")
    frames = seeded_frames(FEAT_BATCH, 22)
    got, want = embed(frames[:2]), host(frames[:2])
    del host
    err = rel_delta(got, want)
    if got.shape != (2, 8, 8, 1536) or got.dtype != np.float32 or \
            not err <= TOWER_RTOL:
        fail(f"p21: slim_backbone card vs CPU {got.shape} {got.dtype} "
             f"{err:.3g}")
    rates = {"graft_s": round(graft_s, 3), "card_vs_cpu": err}
    flags = torch.backends.cudnn
    feats = {}
    for tf32 in (False, True):
        flags.allow_tf32 = tf32
        try:
            ms = call_ms(lambda: embed(frames), iters=FEAT_TIMED, warmup=2)
            feats[tf32] = embed(frames)
        finally:
            flags.allow_tf32 = False
        tag = "tf32" if tf32 else "f32"
        rates[f"{tag}_ms_per_batch"] = ms
        rates[f"{tag}_frames_per_s"] = FEAT_BATCH / (ms / 1e3)
    rates["tf32_vs_f32"] = rel_delta(feats[True], feats[False])
    if not np.isfinite(feats[True]).all():
        fail("p21: non-finite features with TF32 on")
    print(f"[p21] slim_backbone at {FRAME_HW[0]}x{FRAME_HW[1]} -> 299, batch "
          f"{FEAT_BATCH} ({card}): {json.dumps(rates)}", flush=True)
    return embed, frames, rates


def pipeline_checks(embed, frames, single_ms, card):
    """PipelinedBackbone over the grafted trunk in 2 stages on one card
    (``devices=[cuda:0, cuda:0]``, a stream a stage), microbatch
    PIPE_MICROBATCH, preprocessing in stage 0: against the single-stage
    output (PIPE_RTOL) and its frames a second beside the single stage's;
    ``devices=None`` with 2 stages on one visible card raises."""
    import torch
    from multimodal_similarity_tpu_torch.models import N_PIPELINE_UNITS
    from multimodal_similarity_tpu_torch.parallel import (
        INCEPTION_RESNET_V2_UNIT_COSTS, PipelinedBackbone)
    from multimodal_similarity_tpu_torch.preprocess.features import (
        make_preprocess)
    kw = dict(n_units=N_PIPELINE_UNITS, input_shape=FRAME_HW + (3,),
              microbatch=PIPE_MICROBATCH,
              unit_costs=INCEPTION_RESNET_V2_UNIT_COSTS,
              preprocess=make_preprocess(299), input_dtype=torch.uint8)
    pipe = PipelinedBackbone(embed.model, devices=["cuda:0", "cuda:0"], **kw)
    got = pipe(frames).transpose(0, 2, 3, 1)
    err = rel_delta(got, embed(frames))
    ms = call_ms(lambda: pipe(frames), iters=FEAT_TIMED, warmup=1)
    out = {"stage_ranges": pipe.stage_ranges,
           "stage_params": pipe.stage_parameter_counts(),
           "vs_single": err, "ms_per_batch": ms,
           "frames_per_s": FEAT_BATCH / (ms / 1e3),
           "single_frames_per_s": FEAT_BATCH / (single_ms / 1e3)}
    print(f"[p21] 2-stage pipeline on one card ({card}): {json.dumps(out)}",
          flush=True)
    if not err <= PIPE_RTOL:
        fail(f"p21: the pipeline differs from the single stage by {err:.3g}")
    if torch.cuda.device_count() == 1:
        try:
            PipelinedBackbone(embed.model, n_stages=2, **kw)
        except ValueError as e:
            if "are visible" not in str(e):
                fail(f"p21: devices=None raised another error: {e}")
        else:
            fail("p21: 2 stages with devices=None on one card did not "
                 "raise")
    return out


def frames_to_training(root, embed):
    """The resnet features of a synthetic Honda directory (P21_SESSIONS x
    P21_FRAMES) written by extract_sessions from seeded 720 x 1280 frames
    brightened by their event class (the JPEG reader stays on the CPU: no
    Pillow here), then one epoch of
    base_model_batchhard at full width on them (a session a batch: two
    steps), with its launches."""
    import numpy as np
    from multimodal_similarity_tpu_torch.data import generate_synthetic_honda
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts, use_triangular)
    from multimodal_similarity_tpu_torch.preprocess.features import (
        extract_sessions)
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    # two train sessions and one validation session (it is also the test
    # split's)
    split = generate_synthetic_honda(
        root, n_sessions=P21_SESSIONS, frames_per_session=P21_FRAMES,
        modal_dims={"resnet": (8, 8, 1536)}, seed=0, splits=(0.67, 0.34))
    feat_root = os.path.join(root, "features")
    for sess in split["all"]:
        os.remove(os.path.join(feat_root, sess + ".npy"))

    def load_frames(frame_dir):
        # a session's pool of noise frames, each brightened by its event
        # class (at most 120), so that the features, and the trained
        # embeddings, carry the labels
        sess = os.path.basename(frame_dir)
        base = seeded_frames(FEAT_BATCH, split["all"].index(sess))
        with open(os.path.join(root, "labels", f"{sess}_goal.pkl"),
                  "rb") as f:
            tint = (12 * np.asarray(pickle.load(f)["label"])).astype(
                np.uint8)
        for i in range(0, P21_FRAMES, FEAT_BATCH):
            n = min(FEAT_BATCH, P21_FRAMES - i)
            yield from base[:n] + tint[i:i + n, None, None, None]

    reset_launch_counts()
    t0 = time.time()
    extract_sessions(split["all"], os.path.join(root, "frames"), feat_root,
                     embed, batch_size=FEAT_BATCH, load_frames=load_frames)
    extract_s = time.time() - t0
    expect_launches("p21-extract", dict(LAUNCHES),
                    dict.fromkeys(LAUNCHES, 0))
    for sess in split["all"]:
        f = np.load(os.path.join(feat_root, sess + ".npy"))
        if f.shape != (P21_FRAMES, 8, 8, 1536) or f.dtype != np.float32 \
                or not np.isfinite(f).all():
            fail(f"p21: {sess}.npy is {f.shape} {f.dtype} or not finite")
    cfg = full_width_cfg(root, "p21", max_epochs=1, sess_per_batch=1)
    res, launches, n_val, _, emb, _ = drive_trainer(
        root, "p21", base_model_batchhard.train, cfg)
    want = dict.fromkeys(BATCH_HARD, 0)
    tri_step = use_triangular(cfg.batch_size, cfg.emb_dim, sm_count())
    tri_val = use_triangular(emb.shape[0], cfg.emb_dim, sm_count())
    want["batch_hard_tri_idx" if tri_step else "batch_hard_stats_idx"] += \
        res.step
    want["batch_hard_tri" if tri_val else "batch_hard_stats"] += n_val
    expect_launches("p21", launches, want)
    out = {"frames": P21_SESSIONS * P21_FRAMES,
           "extract_s": round(extract_s, 3),
           "frames_per_s": P21_SESSIONS * P21_FRAMES / extract_s,
           "steps": res.step, "K3_launches": launches["batch_hard_tri_idx"],
           "launches": launches}
    print(f"[p21] frames -> features -> training: {json.dumps(out)}",
          flush=True)
    return out


def dispatch_checks(root):
    """``python -m multimodal_similarity_tpu_torch preprocess.segmentation``,
    ``preprocess.sensors`` and ``tools.import_tf1`` on small seed-made
    inputs, each output held to the same function run here."""
    import numpy as np
    import torch
    from multimodal_similarity_tpu_torch.preprocess import segmentation
    from multimodal_similarity_tpu_torch.preprocess.sensors import (
        compute_sensor_stats, normalize_sensors)
    rng = np.random.RandomState(21)
    d = os.path.join(root, "dispatch")
    os.makedirs(d)
    seg = rng.randn(4, 16, 24, 17).astype(np.float32)
    np.save(os.path.join(d, "s1_seg.npy"), seg)
    raws = [rng.randn(30, 8) * 3 + 5 for _ in range(2)]
    for i, raw in enumerate(raws):
        raw[:, 5:7] = rng.randint(0, 2, (30, 2))
        np.save(os.path.join(d, f"s{i}_sensors.npy"), raw)
    with open(os.path.join(d, "sessions.txt"), "w") as f:
        f.write("s0\ns1\n")
    tf1 = {"RTSN/W_1": rng.randn(8, 16).astype(np.float32),
           "RTSN/b_1": rng.randn(16).astype(np.float32),
           "RTSN/lstm_cell/kernel": rng.randn(32, 64).astype(np.float32),
           "RTSN/lstm_cell/bias": rng.randn(64).astype(np.float32),
           "RTSN/W_1/Adam": np.zeros((8, 16), np.float32)}
    np.savez(os.path.join(d, "ref.npz"), **tf1)
    runs = {
        "preprocess.segmentation": ["--seg_root", d, "--feature_root", d],
        "preprocess.sensors": ["--feature_root", d, "--session_file",
                               os.path.join(d, "sessions.txt")],
        "tools.import_tf1": ["--ckpt", os.path.join(d, "ref.npz"),
                             "--model", "rtsn", "--output",
                             os.path.join(d, "rtsn.ckpt-0")]}
    out = {}
    for cmd, args in runs.items():
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m",
                            "multimodal_similarity_tpu_torch", cmd] + args,
                           cwd=HERE, capture_output=True, text=True,
                           timeout=300)
        out[cmd] = (p.returncode, round(time.time() - t0, 2))
        if p.returncode != 0:
            fail(f"p21: {cmd} failed: {p.stderr[-2000:]}")
    if not np.array_equal(np.load(os.path.join(d, "s1_seg_sp.npy")),
                          segmentation.spatial_pyramid_features(seg)):
        fail("p21: preprocess.segmentation wrote other features")
    mu, std = compute_sensor_stats(raws)
    for i, raw in enumerate(raws):
        got = np.load(os.path.join(d, f"s{i}_sensors_normalized.npy"))
        if not np.array_equal(got, normalize_sensors(raw, mu, std)):
            fail("p21: preprocess.sensors wrote other values")
    state = torch.load(os.path.join(d, "rtsn.ckpt-0"),
                       weights_only=True)["model"]
    if not (np.array_equal(state["fc1.weight"].numpy(), tf1["RTSN/W_1"].T)
            and np.array_equal(state["lstm.cell.kernel.weight"].numpy(),
                               tf1["RTSN/lstm_cell/kernel"].T)):
        fail("p21: tools.import_tf1 wrote other weights")
    print(f"[p21] dispatcher (rc, s) {json.dumps(out)}", flush=True)
    return out


def features_phase(root):
    """Phase 21: slice 9 on the card."""
    from multimodal_similarity_tpu_torch.ops.kernels import (
        LAUNCHES, reset_launch_counts)
    t0 = time.time()
    card = card_line()
    reset_launch_counts()
    towers = towers_on_card()
    d = os.path.join(root, "p21")
    os.makedirs(d)
    npz = os.path.join(d, "irv2_slim.npz")
    n_vars = fake_slim_npz(npz)
    print(f"[p21] fake slim checkpoint: {n_vars} variables", flush=True)
    embed, frames, rates = extraction_rates(npz, card)
    pipe = pipeline_checks(embed, frames, rates["f32_ms_per_batch"], card)
    expect_launches("p21-towers", dict(LAUNCHES), dict.fromkeys(LAUNCHES, 0))
    training = frames_to_training(os.path.join(d, "honda"), embed)
    dispatch = dispatch_checks(d)
    print(f"[p21] phase 21 {time.time() - t0:.1f} s ({card})", flush=True)
    return {"towers": towers, "rates": rates, "pipeline": pipe,
            "training": training, "dispatch": dispatch}


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

    from multimodal_similarity_tpu_torch.data import native
    from multimodal_similarity_tpu_torch.ops.kernels._build import build
    t0 = time.time()
    logs = build()
    print(f"[build] {len(logs)} CUDA source(s) built in "
          f"{time.time() - t0:.1f} s", flush=True)
    # the host library every Honda loader's TSN gather takes from phase 8 on
    t0 = time.time()
    native.load_native()
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(f"[build] native host library {native.library_path().name} "
          f"({gxx}) ready in {time.time() - t0:.1f} s", flush=True)
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

    feed_phase()
    fused_step_rates()
    scratch = os.path.join(HERE, "_build")
    os.makedirs(scratch, exist_ok=True)
    gathers = {}

    def counted(tag, phase, *args):
        """``phase(*args)`` with the native gather's counts over it."""
        native.reset_counts()
        out = phase(*args)
        gathers[tag] = dict(native.COUNTS)
        return out

    with tempfile.TemporaryDirectory(dir=scratch) as root:
        steady_root = os.path.join(root, "steady")
        write_synthetic(root)
        write_synthetic(steady_root, n_sessions=40)
        launches = counted("trainer", trainer_phase, root, steady_root)
        counted("base_model", base_model_phase, root, steady_root)
        cub = cub_phase(root)
        ckpts, pairsim_ckpt = counted("pair", pair_phase, root,
                                      steady_root)
        full_root = counted("multimodal", multimodal_phase, root, ckpts)
        hal_ckpt = counted("slice6", slice6_phase, root, ckpts, full_root)
        pretrain_phase(root, full_root)
        counted("serving", serving_phase, full_root, ckpts, pairsim_ckpt,
                hal_ckpt)
        cache_phase(root, full_root)
        run_control_phase(root, steady_root)
        sharded_phase(root, full_root)
        shutil.rmtree(full_root)
        counted("features", features_phase, root)
    # every Honda loader of phases 8-15, 17 and 21 draws TSN segments:
    # each must have taken the native gather
    print(f"[native] gathers and deferrals by phase {json.dumps(gathers)}",
          flush=True)
    for tag, counts in gathers.items():
        if not counts["gather"]:
            fail(f"native: phase {tag}'s loaders never took the native "
                 "gather")
    # each batch-hard kernel's launches on the trainers' paths (the Honda
    # batch-hard trainer, and base_CUB --loss batchhard, which takes K1);
    # one that neither path's gate took is counted on the mining path,
    # which runs every one of them
    for name in BATCH_HARD:
        paths = {"trainer": launches[name], "base_CUB": cub[name]}
        if not sum(paths.values()):
            paths = {"mining": mining[name]}
        launches[name] = sum(paths.values())
        print(f"[launches] {name}: {launches[name]} ("
              + ", ".join(f"{v} on the {k} path" for k, v in paths.items())
              + ")", flush=True)
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
