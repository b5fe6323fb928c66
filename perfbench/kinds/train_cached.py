"""The flagship trained from the int8 device cache
(``multimodal_model --device_mining --device_cache``): epochs of
``HondaExperiment.run_cached_epoch`` back to back, each step one
``make_cached_body_step`` around ``make_mm_fused_step``.

Set-up writes the configuration's Honda-layout directory under
``TMPDIR`` from the seed (deleted when the process ends), builds the
experiment, the cache (timed: ``cache_build_s``), the model with the
benchmark's weights, the optimizer and the fused step, and drives that
one step object through ``warm_epochs`` epochs.  Its first
``checked_steps`` steps are what the reference follows: each step's
loss, the first gradient (from Adam's first moment after step 1) and the
parameters after the last checked step.  The window then runs whole
epochs of the same object until ``--seconds`` have passed.

Parameters: ``warm_epochs``, ``checked_steps``, ``margin_range`` (the
class margins' range).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import time

import torch

from perfbench import honda_data
from perfbench.harness import sub_seed
from perfbench.reference import flagship as ref


class State:
    pass


def _seeds(run):
    """The program's seed (``--seed`` of the trainer) and the generators
    the trainer seeds from it: the plan (the cache's RandomState), the
    dropout (seed + 1), the miners (seed + 2) and the gather (seed + 3)."""
    s = sub_seed(run.seed, 0)
    return s, {"plan": s, "dropout": s + 1, "mine": s + 2, "gather": s + 3}


def _train_config(run, root):
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    c = run.config
    keys = ("feat", "network", "n_input", "n_h", "n_w", "n_C", "emb_dim",
            "num_seg", "batch_size", "event_per_batch", "sess_per_batch",
            "label_num", "max_epochs", "static_epochs", "learning_rate",
            "keep_prob", "optimizer", "alpha", "lambda_l2", "num_negative",
            "triplet_per_batch", "lambda_multimodal", "multimodal_epochs",
            "no_joint", "multimodal_select", "metric", "device_cache_gb",
            "steps_per_dispatch")
    seed, _ = _seeds(run)
    return TrainConfig(DATA_ROOT=root, name=run.cell.name, seed=seed,
                       device_mining=True, device_cache=True,
                       **{k: c[k] for k in keys}).resolve()


def setup(run):
    from multimodal_similarity_tpu_torch.train.cached_steps import (
        make_cached_body_step)
    from multimodal_similarity_tpu_torch.train.trainers import (
        multimodal_model as mm)
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    p, c, dev = run.params, run.config, run.device
    st = State()
    st.run = run
    root = tempfile.mkdtemp(prefix="perfbench_honda_")
    atexit.register(shutil.rmtree, root, True)
    st.root = root
    t0 = time.perf_counter()
    written = honda_data.write(root, c, sub_seed(run.seed, 1), dev)
    run.log(f"data: {written} bytes in {time.perf_counter() - t0:.2f} s")
    cfg = _train_config(run, root)
    exp = HondaExperiment(cfg, modalities=cfg.feat, supports_int8=True,
                          result_dir=os.path.join(root, "results"))
    run.synchronize()
    t0 = time.perf_counter()
    cache = exp.build_cache(dev)
    run.synchronize()
    run.counters["cache_build_s"] = time.perf_counter() - t0
    if cache is None:
        raise RuntimeError("the device cache declined the directory")
    model = mm.build_model(cfg, dev, sensors=c["sensors_dim"],
                           segment=c["segment_dim"])
    weights = ref.make_weights(c, sub_seed(run.seed, 2), dev)
    model.load_state_dict(weights, strict=True)
    opt = mm.mm_optimizer(cfg, model)
    _, seeds = _seeds(run)
    margins = ref.class_margins(sub_seed(run.seed, 3), *p["margin_range"],
                                dev)
    fused = mm.make_mm_fused_step(
        model, opt, cfg,
        torch.Generator(device=dev).manual_seed(seeds["mine"]))
    step = make_cached_body_step(
        lambda ev, lab, m, lr: fused(*ev, lab, m, margins, 1.0, lr), cache,
        torch.Generator(device=dev).manual_seed(seeds["gather"]))

    core = [(k, prm) for k, prm in model.named_parameters()
            if k in ref.CORE]
    st.checked = {"losses": [], "grads": None, "params": None}
    st.host_in_step = 0.0
    n_checked = p["checked_steps"]

    def timed(plan, lr):
        t = time.perf_counter()
        with run.spans("cached_fused_step"):
            out = step(plan, lr)
        st.host_in_step += time.perf_counter() - t
        k = len(st.checked["losses"])
        if k < n_checked:
            st.checked["losses"].append(out["loss"].detach().clone())
            if k == 0:
                # Adam's first moment after one step is (1 - beta1) g; a
                # step that left the state alone has none
                st.checked["grads"] = {
                    name: (opt.state[prm]["exp_avg"].clone()
                           / (1.0 - ref.ADAM_BETAS[0])
                           if "exp_avg" in opt.state[prm]
                           else torch.zeros_like(prm))
                    for name, prm in core}
            if k == n_checked - 1:
                st.checked["params"] = {name: prm.detach().clone()
                                        for name, prm in core}
        return out

    st.exp, st.cache, st.model, st.opt = exp, cache, model, opt
    st.timed, st.step_no, st.epoch = timed, 0, 0
    st.lr = cfg.learning_rate
    st.echo = lambda e, s, sc: mm._echo(cfg, e, s, sc["loss"],
                                        sc["triplet_count"],
                                        sc["hard_count"],
                                        sc["struct_count"])
    for _ in range(p["warm_epochs"]):
        _epoch(st)
    if len(st.checked["losses"]) < n_checked:
        raise RuntimeError(f"{p['warm_epochs']} warm epochs ran fewer than "
                           f"{n_checked} steps")
    return st


def _epoch(st):
    st.step_no = st.exp.run_cached_epoch(st.cache, st.timed, st.lr,
                                         st.step_no, st.epoch, st.echo)
    st.epoch += 1


def window(st, seconds):
    run = st.run
    run.synchronize()
    start = st.step_no
    st.host_in_step = 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _epoch(st)
    run.synchronize()
    window_s = time.perf_counter() - t0
    steps = st.step_no - start
    run.window_s = window_s
    run.counters.update(attempted=steps, failed=0, steps=steps,
                        host_in_step_s=st.host_in_step)
    run.log(f"{steps} optimizer steps in {window_s:.3f} s")
    return {"train_step_ms": 1e3 * window_s / steps}


def outputs(st):
    """The checked steps' readings, and the directory the reference reads
    the same raw features from."""
    return dict(st.checked, root=st.root)


def release(st):
    st.exp.close()
    st.exp = st.cache = st.model = st.opt = st.timed = None


def _reference_steps(run, got, control):
    c, p = run.config, run.params
    _, seeds = _seeds(run)
    return ref.run_steps(
        got["root"], c, seeds, ref.make_weights(c, sub_seed(run.seed, 2),
                                                  run.device),
        ref.class_margins(sub_seed(run.seed, 3), *p["margin_range"],
                          run.device),
        p["checked_steps"], run.device, control=control)


def reference(run, got):
    return _reference_steps(run, got, control=False)


def control(run, got):
    """The reference put in the program's place at TF32: its readings in
    the form of ``got``."""
    out = _reference_steps(run, got, control=True)
    return {"losses": list(out["losses"]), "grads": out["grads"],
            "params": out["params"], "root": got["root"]}


def compare(run, got, want):
    """``loss_gap``: the widest |loss - reference loss| / |reference loss|
    of the checked steps; ``grad_gap``: the worst leaf's |norm of the first
    gradient - the reference's| over the larger of that leaf's and the
    median leaf's reference norm; ``change_gap``: the same of the
    parameters' change over the checked steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    w0 = ref.make_weights(run.config, sub_seed(run.seed, 2), run.device)
    losses = torch.stack([torch.as_tensor(x) for x in got["losses"]]
                         ).double().cpu()
    want_l = want["losses"].double().cpu()
    if losses.shape != want_l.shape:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    loss_gap = float(((losses - want_l).abs()
                      / want_l.abs().clamp(min=1e-30)).max())

    def norms(d):
        return {k: float(torch.linalg.vector_norm(v.double())) for k, v
                in d.items()}

    g_got, g_want = norms(got["grads"]), norms(want["grads"])
    c_got = norms({k: got["params"][k] - w0[k] for k in ref.CORE})
    c_want = norms({k: want["params"][k] - w0[k] for k in ref.CORE})
    med_g = float(torch.tensor(list(g_want.values())).median())
    med_c = float(torch.tensor(list(c_want.values())).median())
    grad_gap = max(abs(g_got[k] - g_want[k]) / max(g_want[k], med_g, 1e-30)
                   for k in ref.CORE)
    moved = [k for k in ref.CORE if g_want[k] >= 1e-3 * med_g]
    change_gap = max(abs(c_got[k] - c_want[k]) / max(c_want[k], med_c,
                                                      1e-30)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
