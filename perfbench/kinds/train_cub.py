"""End-to-end CUB training (``base_CUB --network inception_v2``): steps of
the trainer's own loop body, ``base_CUB.CUBTrainer.step``, back to back.

Set-up makes the configuration's training split from the seed (host f32
images in [0, 1], as ``train()`` holds them), builds the trainer's model
with the benchmark's weights (``perfbench/reference/cub_inception_v2.py``),
its optimizer and a ``CUBTrainer`` logging to a directory under
``TMPDIR`` (deleted when the process ends), and takes ``warm_steps`` steps
at the schedule's learning rate, as ``train()`` would.  Its first
``checked_steps`` steps are what the reference follows: each step's loss,
the first gradient (from Adam's first moment after step 1), and the
state after each step (parameters, running statistics, Adam's moments).
The reference takes each step from the state the program reached before
it: the card's weight gradients are summed in no fixed order, so two
runs of one step part by a few ulps of the parameters, and free-running
steps would compare that drift, not the step.  The window then takes
steps until ``--seconds`` have passed.  Validation and checkpoints are not
run.

Parameters: ``warm_steps``, ``checked_steps``."""

from __future__ import annotations

import atexit
import shutil
import tempfile
import time

import torch

from perfbench.harness import sub_seed
from perfbench.reference import cub_inception_v2 as ref


class State:
    pass


def _train_config(run):
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    c = run.config
    keys = ("network", "emb_dim", "batch_size", "loss", "alpha",
            "optimizer", "learning_rate", "max_epochs", "static_epochs",
            "keep_prob", "normalized", "lambda_l2")
    return TrainConfig(name=run.cell.name, seed=sub_seed(run.seed, 0),
                       silent_mode=True, **{k: c[k] for k in keys}
                       ).resolve()


def _data(run):
    c = run.config
    return ref.make_images(sub_seed(run.seed, 1), c["train_classes"],
                           c["images_per_class"], c["image_size"],
                           run.device)


def _weights(run):
    return ref.make_weights(sub_seed(run.seed, 2), run.config["emb_dim"],
                            run.device)


def setup(run):
    from multimodal_similarity_tpu_torch.train.state import (
        build_optimizer, learning_rate_schedule)
    from multimodal_similarity_tpu_torch.train.trainers.base_CUB import (
        CUBTrainer, build_model)
    from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger
    p, c, dev = run.params, run.config, run.device
    st = State()
    st.run = run
    cfg = _train_config(run)
    t0 = time.perf_counter()
    st.images, st.labels = _data(run)
    run.log(f"data: {st.images.nbytes} bytes in "
            f"{time.perf_counter() - t0:.2f} s")
    model = build_model(cfg, dev)
    model.load_state_dict(_weights(run), strict=True)
    opt = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    logs = tempfile.mkdtemp(prefix="perfbench_cub_")
    atexit.register(shutil.rmtree, logs, True)
    st.logger = MetricsLogger(logs)
    st.trainer = CUBTrainer(cfg, model, opt, st.images, st.labels,
                            c["crop"], dev, st.logger)
    st.lr = lambda step: learning_rate_schedule(
        step, cfg.learning_rate, cfg.static_epochs, cfg.max_epochs)
    st.model, st.opt = model, opt

    n_checked = p["checked_steps"]
    st.checked = {"losses": [], "grads": None, "states": []}
    for k in range(p["warm_steps"]):
        out = st.trainer.step(st.lr(st.trainer.steps))
        if k < n_checked:
            st.checked["losses"].append(out["loss"].clone())
            st.checked["states"].append(_state(model, opt))
        if k == 0:
            # Adam's first moment after one step is (1 - beta1) g
            st.checked["grads"] = {
                name: m / (1.0 - ref.ADAM_BETAS[0])
                for name, m in st.checked["states"][0]["m"].items()}
    if len(st.checked["losses"]) < n_checked:
        raise RuntimeError(f"{p['warm_steps']} warm steps ran fewer than "
                           f"{n_checked}")
    return st


def _state(model, opt) -> dict:
    """The model's parameters and running statistics and Adam's moments,
    copied; a moment the optimizer has not made (no step) reads 0."""
    def moment(prm, key):
        st = opt.state[prm]
        return st[key].clone() if key in st else torch.zeros_like(prm)
    named = list(model.named_parameters())
    return {"params": {k: prm.detach().clone() for k, prm in named},
            "stats": {k: buf.clone() for k, buf in model.named_buffers()},
            "m": {k: moment(prm, "exp_avg") for k, prm in named},
            "v": {k: moment(prm, "exp_avg_sq") for k, prm in named}}


def window(st, seconds):
    run, trainer = st.run, st.trainer
    run.synchronize()
    start = trainer.steps
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with run.spans("CUBTrainer.step"):
            trainer.step(st.lr(trainer.steps))
    run.synchronize()
    window_s = time.perf_counter() - t0
    steps = trainer.steps - start
    run.window_s = window_s
    run.counters.update(attempted=steps, failed=0, steps=steps,
                        images=steps * trainer.batch)
    run.log(f"{steps} optimizer steps in {window_s:.3f} s")
    return {"train_step_ms": 1e3 * window_s / steps}


def outputs(st):
    """The checked steps' readings, and the split the reference draws the
    same batches from."""
    return dict(st.checked, images=st.images, labels=st.labels)


def release(st):
    st.logger.close()
    st.trainer = st.model = st.opt = st.logger = None


def reference(run, got):
    """The reference's checked steps, each from the program's state before
    it."""
    return ref.run_steps(got["images"], got["labels"], run.config,
                         sub_seed(run.seed, 0), _weights(run),
                         run.params["checked_steps"], run.device,
                         forced=got["states"])


def control(run, got):
    """The reference put in the program's place at TF32, from the seed's
    weights on: its readings in the form of ``got``.  It is held, as the
    program is, against ``reference(run, control(run, got))``, the
    reference taking each step from the control's own state before it."""
    out = ref.run_steps(got["images"], got["labels"], run.config,
                        sub_seed(run.seed, 0), _weights(run),
                        run.params["checked_steps"], run.device,
                        control=True)
    return {"losses": list(out["losses"]), "grads": out["grads"],
            "states": out["states"], "images": got["images"],
            "labels": got["labels"]}


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def compare(run, got, want):
    """Step k of the reference starts from the program's state before it
    (the seed's weights for the first).  ``loss_gap``: the widest |loss -
    reference loss| / |reference loss| of the checked steps;
    ``grad_gap``: the worst leaf's norm of (first gradient - the
    reference's) over the larger of that leaf's and the median leaf's
    reference norm; ``change_gap``: the worst step and leaf's norm of (the
    program's change of the parameters - the reference's) over the larger
    of the reference's norm and the step's median leaf's, so that a change
    of the wrong size or direction shows; ``stat_gap``: the worst
    step and batch norm's norm of (running mean, or variance, - the
    reference's) over the reference's change of it."""
    n = run.params["checked_steps"]
    if len(got["losses"]) != n or len(got["states"]) != n:
        return {k: float("inf") for k in ("loss_gap", "grad_gap",
                                          "change_gap", "stat_gap")}
    w0 = _weights(run)
    losses = torch.stack([torch.as_tensor(x).to(run.device)
                          for x in got["losses"]]).double()
    want_l = want["losses"].double()
    loss_gap = float(((losses - want_l).abs()
                      / want_l.abs().clamp(min=1e-30)).max())

    keys = sorted(want["grads"])
    g_norm = {k: _norm(want["grads"][k]) for k in keys}
    med = float(torch.tensor(list(g_norm.values())).median())
    grad_gap = max(_norm(got["grads"][k] - want["grads"][k])
                   / max(g_norm[k], med, 1e-30) for k in keys)

    change_gap = stat_gap = 0.0
    for k in range(n):
        before = got["states"][k - 1] if k else {
            "params": w0, "stats": w0}
        mine, theirs = got["states"][k], want["states"][k]
        c_want = {key: _norm(theirs["params"][key] - before["params"][key])
                  for key in keys}
        med = float(torch.tensor(list(c_want.values())).median())
        for key in keys:
            apart = _norm(mine["params"][key] - theirs["params"][key])
            change_gap = max(change_gap,
                             apart / max(c_want[key], med, 1e-30))
        for key, s in theirs["stats"].items():
            moved = _norm(s - before["stats"][key])
            stat_gap = max(stat_gap, _norm(mine["stats"][key] - s)
                           / max(moved, 1e-30))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "stat_gap": stat_gap}
