#!/usr/bin/env python3
"""Tensor parallelism across cards against the same data axis without it,
on a host with two or more NVIDIA GPUs.

    torchrun --standalone --nproc_per_node N scripts/tp_cards.py [--steps S]

One rank a card, NCCL.  For each model axis M of 2 and 4 that divides N,
the (N / M) x M data x model mesh (``parallel.create_2d_mesh``) and two
steps at base_model's width (``chip_smoke.full_width_cfg``: ConvRTSN on 3
segments of 8x8x1536 maps, n_C 20, keep_prob 0.5) widened to emb_dim 1024,
the width the JAX module's docstring names:

* base_model's facenet step on a seeded 1000-event budget batch (200
  triplets, 5 negatives): the data-parallel step on the data axis, the
  single-device fused step at a data axis of one;
* the batch-hard step on a seeded class-balanced batch of 512: the ring
  on the data axis, the fused kernel (K3 or K1) at a data axis of one.

Each runs S steps (default 3) on the column-sharded model and on the same
model unsharded over the same data axis (the mesh's data group, which
leaves out the other model columns' ranks, or no mesh at one), from the
same seeds, and checks:

* every step's loss within rtol 2e-4 / atol 2e-5 of the unsharded run's
  (the JAX package's tests/test_tensor_parallel.py tolerance);
* each rank's bytes of split parameters and Adam moments are 1/M of the
  whole of them (``tensor_parallel.sharded_bytes``).

Then one epoch each of the trainers ``base_model --triplet_select facenet``
and ``base_model_batchhard`` with ``--model_parallel M`` through ``train``
on a small synthetic directory (RTSN on sensors (8,), emb_dim 1024): every
rank's loss trace equal, the checkpoint written by rank 0 alone and loaded
into a model without tensor parallelism.

TF32 is off, as ``chip_smoke.py`` sets it.  Rank 0 prints one JSON line a
layout and trainer (losses, the largest relative difference, bytes, ms a
step of both runs: CUDA events around S steps after one) and the cards'
name and power limit; exits 1 on a failed check.  ``--device cpu``
rehearses the same checks over gloo on the CPU (its ms are the host's,
not a card's).
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
EMB_DIM = 1024
BUDGET, TRIPLETS, NEGATIVES = 1000, 200, 5


def seeded_inputs(cfg, device):
    """(budget events, labels, mask) and (balanced events, labels), the
    same on every rank."""
    import torch
    gen = torch.Generator(device=device).manual_seed(31)
    shape = (cfg.num_seg, cfg.n_h, cfg.n_w, cfg.n_input)
    events = torch.randn((BUDGET,) + shape, device=device, generator=gen)
    labels = torch.randint(1, 13, (BUDGET,), device=device, generator=gen)
    mask = (torch.arange(BUDGET, device=device) < BUDGET - 40).float()
    bal = torch.randn((cfg.batch_size,) + shape, device=device,
                      generator=gen)
    bal_labels = torch.arange(cfg.batch_size, device=device) // 8 + 1
    return (events, labels, mask), (bal, bal_labels)


def run_steps(cfg, kind, inputs, mesh, tp, steps, device):
    """``steps`` losses of ``kind`` ("facenet" or "batchhard") on ``mesh``
    (the data axis; None at one), the model split over ``tp`` when given;
    then (losses, ms a step, (held, whole) bytes)."""
    import torch
    import chip_smoke as cs
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.parallel import (
        make_dp_triplet_step, replicate, shard_module_tp)
    from multimodal_similarity_tpu_torch.parallel.tensor_parallel import (
        sharded_bytes)
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.steps import (
        make_triplet_train_step)
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    model = build_encoder(
        cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
        n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
        keep_prob=cfg.keep_prob, generator=torch.Generator().manual_seed(7),
        dropout_generator=torch.Generator(device=device).manual_seed(8)
    ).to(device)
    opt = build_optimizer("ADAM", model, cfg.learning_rate)
    if tp is not None:
        replicate([p.data for p in model.parameters()], tp.world)
        shard_module_tp(model, tp, opt)
    lr = cfg.learning_rate
    rows = mesh.rows if mesh is not None else (lambda n: slice(0, n))
    if kind == "facenet":
        events, labels, mask = inputs
        local = events[rows(events.shape[0])]
        kw = dict(triplet_per_batch=TRIPLETS, alpha=cfg.alpha,
                  num_negative=NEGATIVES,
                  generator=torch.Generator(device=device).manual_seed(9))
        step = (make_dp_triplet_step(model, opt, mesh, **kw)
                if mesh is not None else
                make_triplet_train_step(model, opt, **kw))

        def one():
            return step(local, labels, mask, lr)["loss"]
    else:
        events, labels = inputs
        r = rows(events.shape[0])
        local, local_labels = events[r], labels[r]
        step = base_model_batchhard.make_balanced_batch_step(
            model, opt, cfg, "batchhard", mesh=mesh)

        def one():
            return step(local, local_labels, lr)["loss"]

    losses = [float(one()) for _ in range(steps)]
    if device.startswith("cuda"):
        ms = cs.call_ms(one, iters=steps, warmup=1)
    else:
        t0 = time.perf_counter()
        one()
        ms = (time.perf_counter() - t0) * 1e3
    held = sharded_bytes(model, opt) if tp is not None else (0, 0)
    return losses, ms, held


def close(got, want):
    import numpy as np
    g, w = np.asarray(got), np.asarray(want)
    ok = bool(np.allclose(g, w, rtol=LOSS_RTOL, atol=LOSS_ATOL))
    return ok, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))


def layouts(n):
    return [m for m in (2, 4) if n % m == 0 and m <= n]


def step_checks(root, steps, rank, device):
    """The sharded steps against the unsharded ones, each layout; returns
    the failed checks' names."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from multimodal_similarity_tpu_torch.parallel import create_2d_mesh
    cfg = cs.full_width_cfg(root, "tp_cards", emb_dim=EMB_DIM)
    budget, balanced = seeded_inputs(cfg, device)
    failed = []
    for m in layouts(dist.get_world_size()):
        tp = create_2d_mesh(None, m)
        data = tp.data if tp.data.size > 1 else None
        for kind, inputs in (("facenet", budget), ("batchhard", balanced)):
            ref, ref_ms, _ = run_steps(cfg, kind, inputs, data, None, steps,
                                       device)
            got, ms, (held, whole) = run_steps(cfg, kind, inputs, data, tp,
                                               steps, device)
            ok, rel = close(got, ref)
            parts = [None] * tp.world.size
            dist.all_gather_object(parts, (held, whole, got))
            bytes_ok = all(h * m == w for h, w, _ in parts)
            same = all(p[2] == got for p in parts)
            if not (ok and bytes_ok and same):
                failed.append(f"{tp.data.size}x{m} {kind}")
            if rank == 0:
                print(json.dumps({
                    "layout": f"{tp.data.size}x{m}", "step": kind,
                    "emb_dim": EMB_DIM, "losses_tp": got, "losses_ref": ref,
                    "max_rel": rel, "within_tol": ok,
                    "ranks_equal": same,
                    "held_bytes": [p[0] for p in parts],
                    "whole_bytes": whole, "bytes_1_over_mp": bytes_ok,
                    "ms_tp": round(ms, 3), "ms_ref": round(ref_ms, 3)}),
                    flush=True)
            if device.startswith("cuda"):
                torch.cuda.empty_cache()
    return failed


def trainer_checks(root, rank, device):
    """One epoch each of base_model (facenet) and base_model_batchhard at
    every model axis; returns the failed checks' names."""
    import torch
    import torch.distributed as dist
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    from multimodal_similarity_tpu_torch.data.synthetic import (
        generate_synthetic_honda)
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.train.checkpoints import (
        load_checkpoint)
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model, base_model_batchhard)
    data = os.path.join(root, "honda")
    if rank == 0:
        generate_synthetic_honda(data, n_sessions=12, frames_per_session=300,
                                 modal_dims={"sensors": (8,)}, seed=0)
    dist.barrier()
    failed = []
    for m in layouts(dist.get_world_size()):
        for name, train, kw in (
                ("base_model", base_model.train,
                 dict(triplet_select="facenet", triplet_per_batch=24)),
                ("batchhard", base_model_batchhard.train,
                 dict(batch_size=32))):
            tag = f"tr_{name}_mp{m}"
            cfg = TrainConfig(
                DATA_ROOT=data, name=tag, network="rtsn", feat="sensors",
                n_input=8, emb_dim=EMB_DIM, num_seg=3, sess_per_batch=1,
                max_epochs=1, learning_rate=0.01, keep_prob=0.9,
                silent_mode=True, log_flush_every=1, model_parallel=m,
                **kw).resolve()
            out = os.path.join(root, tag)
            res = train(cfg, event_budget=48, result_dir=out, device=device)
            with open(os.path.join(res.result_dir, "metrics.jsonl")) as f:
                losses = [json.loads(line)["loss"] for line in f
                          if '"loss"' in line]
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, losses)
            dist.barrier()
            ckpts = sorted(glob.glob(os.path.join(root, tag + "*", "*.ckpt-*")))
            ok = bool(losses) and all(p == losses for p in parts) and \
                ckpts and all(os.path.dirname(c) == out for c in ckpts)
            if ok and rank == 0:
                plain = build_encoder("rtsn", num_seg=3, emb_dim=EMB_DIM,
                                      n_input=8).to(device)
                load_checkpoint(ckpts[-1], plain)
            if not ok:
                failed.append(tag)
            if rank == 0:
                print(json.dumps({
                    "trainer": name, "model_parallel": m,
                    "steps": res.step, "losses": losses,
                    "ranks_equal": all(p == losses for p in parts),
                    "checkpoints": [os.path.relpath(c, root)
                                    for c in ckpts]}), flush=True)
            dist.barrier()
    return failed


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    on_card = args.device == "cuda"
    if "LOCAL_RANK" not in os.environ or (
            on_card and not torch.cuda.is_available()):
        print("tp_cards: run under torchrun on a host with NVIDIA GPUs",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    local = int(os.environ["LOCAL_RANK"])
    if on_card:
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method="env://")
    rank = dist.get_rank()
    device = f"cuda:{local}" if on_card else "cpu"
    failed = []
    try:
        if rank == 0 and on_card:
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], check=True, capture_output=True,
                text=True).stdout.strip().splitlines()
            print(f"[tp_cards] {dist.get_world_size()} ranks; cards: "
                  f"{cards}; torch {torch.__version__}", flush=True)
        scratch = os.path.join(HERE, "_build")
        os.makedirs(scratch, exist_ok=True)
        names = [tempfile.mkdtemp(dir=scratch) if rank == 0 else None]
        dist.broadcast_object_list(names, src=0)
        root = names[0]
        try:
            failed += step_checks(root, args.steps, rank, device)
            failed += trainer_checks(root, rank, device)
        finally:
            dist.barrier()
            if rank == 0:
                shutil.rmtree(root, ignore_errors=True)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"tp_cards_failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
