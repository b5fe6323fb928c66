"""The port's run control (``utils/profiling.py``,
``utils/watchdog.py``, ``utils/preemption.py`` and their wiring into the
trainers) against the JAX package's: the scenarios of the JAX package's
``tests/test_utils.py`` on the port's copies, the trainers' stop at the
same step as the JAX trainers', the resume from that checkpoint, the
watchdog on a stalled run, ``--profile_dir`` on the CPU and a real SIGTERM
to a trainer process."""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.trainer import validate
from multimodal_similarity_tpu_torch.utils import (
    StepWatchdog, preemption, profiling)
from multimodal_similarity_tpu_torch.utils.preemption import PreemptionGuard
from multimodal_similarity_tpu_torch.utils.watchdog import (
    install_hang_watchdog)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the classes --------------------------------------------------------


def test_step_watchdog_fires_and_cancels():
    fired = []
    wd = StepWatchdog(timeout=0.05, on_timeout=lambda: fired.append(1))
    with wd.step():
        time.sleep(0.12)          # exceeds the deadline: fires
    assert wd.fired == 1
    with wd.step():
        pass                      # a fast step: cancelled
    time.sleep(0.1)
    assert wd.fired == 1


def test_watchdog_beat_keeps_single_timer():
    fired = []
    wd = StepWatchdog(timeout=0.05, on_timeout=lambda: fired.append(1))
    for _ in range(5):
        wd.beat()
    time.sleep(0.15)
    wd.cancel()
    assert fired == [1]  # stale timers from earlier beats never fire


def test_step_window_profiler_resume_relative(monkeypatch, tmp_path):
    """The trace window is relative to the FIRST observed step, so a run
    resumed at step 101 still traces ``num_steps`` steps (102-104)."""
    calls = []
    monkeypatch.setattr(profiling, "_start_profile",
                        lambda: calls.append(("start",)) or object())
    monkeypatch.setattr(profiling, "_stop_profile",
                        lambda prof, path: calls.append(("stop", path))
                        or path)
    prof = profiling.StepWindowProfiler(str(tmp_path), num_steps=3)
    for step in range(101, 110):
        prof.update(step)
    prof.close()
    assert calls == [("start",), ("stop", str(
        tmp_path / "trace_steps102-104.pt.trace.json"))]
    sp = profiling.StepWindowProfiler(str(tmp_path), num_steps=3)
    sp.update(101)                   # the first step: starts the window
    assert sp._active
    sp.update(102)
    sp.update(103)
    assert sp._active                # 2 steps in the window so far
    sp.update(104)                   # the 3rd: the window is complete
    assert not sp._active and sp._done
    interrupted = profiling.StepWindowProfiler(str(tmp_path), num_steps=5)
    interrupted.update(1)
    interrupted.update(2)
    interrupted.close()              # an open window is written on close
    assert interrupted.trace_path.endswith("trace_steps2-2.pt.trace.json")
    assert profiling.StepWindowProfiler("", num_steps=3)._done


def test_preemption_guard_signal_and_restore():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            assert not guard.should_stop
            os.kill(os.getpid(), signal.SIGUSR1)
            assert guard.wait(2.0) and guard.should_stop
            # the previously installed handler chained
            assert seen == [signal.SIGUSR1]
        # restored: a new signal reaches only the old handler
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert seen == [signal.SIGUSR1] * 2
        assert not guard._installed
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_preemption_guard_escalates_a_late_repeat(monkeypatch):
    """A repeat after the grace window restores the previous disposition
    and re-delivers the signal; a quick duplicate does not."""
    raised = []
    monkeypatch.setattr(preemption.signal, "raise_signal", raised.append)
    prev = signal.signal(signal.SIGUSR1, lambda s, f: None)
    try:
        guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
        guard._handle(signal.SIGUSR1, None)
        guard._handle(signal.SIGUSR1, None)      # duplicate: ignored
        assert raised == [] and guard._installed
        guard._signal_time -= guard.ESCALATE_AFTER_S + 1
        guard._handle(signal.SIGUSR1, None)
        assert raised == [signal.SIGUSR1] and not guard._installed
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_preemption_guard_reasserts_own_handler_on_poll(monkeypatch):
    """The poll re-asserts the OS disposition even when getsignal already
    reports THIS guard's handler; ANOTHER live guard's handler is skipped
    (nested guards)."""
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        asserted = []
        real_signal = signal.signal
        monkeypatch.setattr(
            preemption.signal, "signal",
            lambda sig, h: asserted.append((sig, h)) or real_signal(sig, h))
        guard.should_stop
        assert (signal.SIGUSR1, guard._handle) in asserted
        inner = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
        try:
            asserted.clear()
            guard.should_stop
            assert asserted == []
            assert signal.getsignal(signal.SIGUSR1) == inner._handle
        finally:
            inner.restore()


def test_preemption_guard_inert_off_main_thread():
    out = {}

    def worker():
        g = PreemptionGuard().install()   # must not raise off the main
        out["installed"] = g._installed
        g.request_stop()
        out["stops"] = g.should_stop

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out == {"installed": False, "stops": True}


def test_sync_should_stop_throttles_collective(monkeypatch):
    """With more than one process the collective runs only on every
    ``every``-th lockstep step (plus forced syncs without a step); one
    process never calls it."""
    calls = []
    monkeypatch.setattr(preemption, "any_process",
                        lambda flag: calls.append(flag) or flag)
    g = PreemptionGuard()  # not installed: a flag only
    fired = [s for s in range(1, 17)
             if preemption.sync_should_stop(g, 2, step=s, every=8)]
    assert len(calls) == 2 and fired == []
    g.request_stop()
    assert not preemption.sync_should_stop(g, 2, step=9, every=8)
    assert preemption.sync_should_stop(g, 2, step=16, every=8)
    n = len(calls)
    assert preemption.sync_should_stop(g, 2)
    assert len(calls) == n + 1
    assert preemption.sync_should_stop(g, 1, step=3)
    assert len(calls) == n + 1


def test_any_process_over_gloo(tmp_path):
    """The collective itself: an all-reduce(MAX) of the flag over a
    one-rank gloo group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        assert preemption.any_process(True)
        assert not preemption.any_process(False)
        g = PreemptionGuard()
        g.request_stop()
        assert preemption.sync_should_stop(g, 2, step=8, every=8)
    finally:
        dist.destroy_process_group()


def test_install_hang_watchdog_fires_stop_and_dumps(capfd):
    """A stalled step fires the watchdog, which dumps every thread's
    traceback and requests a stop on the guard."""
    assert install_hang_watchdog("t", 0.0, None) is None  # disabled
    guard = PreemptionGuard()
    wd = install_hang_watchdog("t", 0.08, guard)
    try:
        for _ in range(3):
            time.sleep(0.03)
            wd.beat()
        assert not guard.should_stop
        time.sleep(0.2)  # a stall: no heartbeat
        assert guard.should_stop
        assert wd.fired == 1
        err = capfd.readouterr().err
        assert "watchdog" in err and "thread dump" in err
        assert "Current thread" in err or "Thread" in err  # faulthandler
    finally:
        wd.cancel()


def test_validate_beats_per_chunk():
    """Validation beats a hang watchdog per embedded chunk and once after
    the metrics, as the JAX ``validate`` does."""
    beats = []
    feats = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    labels = np.asarray([1, 1, 2, 2, 3, 3, 1, 2, 3, 1])
    metrics, _ = validate(lambda x: x * 2.0, feats, labels,
                          torch.device("cpu"), chunk=4,
                          beat=lambda: beats.append(1))
    assert len(beats) == 3 + 1
    assert np.isfinite(metrics["val_mAP"])


# -- the trainers -----------------------------------------------------------


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("honda_rc"))
    generate_synthetic_honda(
        root, n_sessions=5, frames_per_session=300,
        modal_dims={"resnet": (2, 2, 8), "sensors": (8,)},
        class_scale=1.0, noise_scale=1.0, seed=0)
    return root


def _kw(root, **kw):
    d = dict(DATA_ROOT=root, name="t", network="rtsn", feat="sensors",
             n_input=8, emb_dim=16, num_seg=3, sess_per_batch=1,
             max_epochs=1, triplet_per_batch=24, batch_size=32,
             learning_rate=0.01, keep_prob=1.0, silent_mode=True,
             log_flush_every=1)
    d.update(kw)
    return d


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _firing_guard(base, fire_after=2):
    """A guard class whose ``should_stop`` turns true from its
    ``fire_after + 1``-th poll on (installs nothing)."""
    class FiringGuard(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self._checks = 0

        def install(self):
            return self

        def restore(self):
            pass

        @property
        def should_stop(self):
            self._checks += 1
            if self._checks > fire_after:
                self.request_stop()
            return self._stop.is_set()
    return FiringGuard


TRAINERS = {
    "base_model_batchhard": {},
    "pddm_model": {},
    "unimodal_pretrain_sae": {"network": "seq2seq"},
}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_stops_where_jax_does(synth_root, tmp_path, monkeypatch,
                                      name):
    """A stop requested at the guard's third poll (as the JAX package's
    ``test_honda_experiment_trainers_preempt`` does): the port's trainer
    stops at the same step as the JAX trainer, short of its 50 epochs, and
    checkpoints exactly that step."""
    import importlib

    from multimodal_similarity_tpu.utils import preemption as jax_pre
    jax_mod = importlib.import_module(
        f"multimodal_similarity_tpu.train.trainers.{name}")
    mod = importlib.import_module(
        f"multimodal_similarity_tpu_torch.train.trainers.{name}")
    monkeypatch.setattr(jax_pre, "PreemptionGuard",
                        _firing_guard(jax_pre.PreemptionGuard))
    monkeypatch.setattr(preemption, "PreemptionGuard",
                        _firing_guard(preemption.PreemptionGuard))
    kw = _kw(synth_root, max_epochs=50, **TRAINERS[name])
    state, _, _ = jax_mod.train(JaxTrainConfig(**kw).resolve(),
                                event_budget=48,
                                result_dir=str(tmp_path / "jax"))
    res = mod.train(TrainConfig(**kw).resolve(), event_budget=48,
                    result_dir=str(tmp_path / "port"), device="cpu")
    assert res.step == int(state.step) <= 4
    path = os.path.join(res.result_dir, f"t.ckpt-{res.step}")
    assert os.path.exists(path)
    assert load_checkpoint(path, res.model) == res.step


def test_stop_then_resume(synth_root, tmp_path, monkeypatch, capsys):
    """``base_model_batchhard`` stopped at step s checkpoints s with the
    parameters and Adam state it stopped with (bit for bit); a run resumed
    from that checkpoint with ``--model_path`` starts at step s + 1, in the
    epoch step s belongs to, and its loss trace equals that of a run that
    restores the same checkpoint (rtol 1e-6).  Its steps up to s equal the
    uninterrupted run's (rtol 1e-6).  The resumed run draws its batches
    from the loader's seed again, as the JAX trainer does, so its later
    steps are not the uninterrupted run's."""
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    kw = _kw(synth_root, max_epochs=3, network="rtsn")
    full = base_model_batchhard.train(
        TrainConfig(**kw).resolve(), event_budget=48,
        result_dir=str(tmp_path / "full"), device="cpu")
    with monkeypatch.context() as m:
        m.setattr(preemption, "PreemptionGuard",
                  _firing_guard(preemption.PreemptionGuard, fire_after=4))
        stopped = base_model_batchhard.train(
            TrainConfig(**kw).resolve(), event_budget=48,
            result_dir=str(tmp_path / "stop"), device="cpu")
    assert "preemption signal: checkpointed at step 4" in \
        capsys.readouterr().out
    s = stopped.step
    assert s == 4 < full.step
    ckpt = os.path.join(stopped.result_dir, f"t.ckpt-{s}")
    model = build_encoder("rtsn", num_seg=3, emb_dim=16, n_input=8)
    opt = build_optimizer("ADAM", model, 0.01)
    assert load_checkpoint(ckpt, model, opt) == s
    for a, b in zip(model.parameters(), stopped.model.parameters()):
        assert torch.equal(a, b)
    assert opt.state_dict()["state"][0]["step"] == \
        stopped.optimizer.state_dict()["state"][0]["step"]
    full_loss = [r["loss"] for r in _records(full.result_dir) if "loss" in r]
    stop_loss = [r["loss"] for r in _records(stopped.result_dir)
                 if "loss" in r]
    np.testing.assert_allclose(stop_loss, full_loss[:s], rtol=1e-6)

    runs = []
    for tag in ("resume", "again"):
        res = base_model_batchhard.train(
            TrainConfig(**dict(kw, model_path=ckpt)).resolve(),
            event_budget=48, result_dir=str(tmp_path / tag), device="cpu")
        recs = [r for r in _records(res.result_dir) if "loss" in r]
        # the epoch of step s runs whole again, as in the JAX trainer
        assert recs[0]["step"] == s + 1 and res.step == s + 3 * (3 - s // 3)
        runs.append([r["loss"] for r in recs])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-6)


def test_watchdog_stops_and_checkpoints_stalled_run(synth_root, tmp_path,
                                                    capfd):
    """``--watchdog_secs`` end to end, as the JAX package's test: a tiny
    deadline fires before the first step completes, requests a stop, and
    the trainer checkpoints that step instead of running its 50 epochs;
    the thread dump goes to stderr."""
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    res = base_model_batchhard.train(
        TrainConfig(**_kw(synth_root, max_epochs=50,
                          watchdog_secs=0.01)).resolve(),
        event_budget=48, result_dir=str(tmp_path / "wd"), device="cpu")
    assert 1 <= res.step <= 2
    assert glob.glob(str(tmp_path / "wd" / f"t.ckpt-{res.step}"))
    err = capfd.readouterr().err
    assert "watchdog: no step completed" in err and "thread dump" in err


def test_profile_dir_writes_step_window_trace(synth_root, tmp_path):
    """``--profile_dir`` on the CPU: one epoch of three steps with
    ``--profile_steps 2`` writes the trace of steps 2-3 (the window after
    the first step), a Chrome trace holding the steps' operators; the
    watchdog is armed and cancelled without firing."""
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard)
    prof = tmp_path / "prof"
    res = base_model_batchhard.train(
        TrainConfig(**_kw(synth_root, profile_dir=str(prof),
                          profile_steps=2, watchdog_secs=60.0)).resolve(),
        event_budget=48, result_dir=str(tmp_path / "p"), device="cpu")
    assert res.step == 3
    assert sorted(os.listdir(prof)) == ["trace_steps2-3.pt.trace.json"]
    with open(prof / "trace_steps2-3.pt.trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in n or "matmul" in n or "mm" == n for n in names)


def test_sigterm_checkpoints_exact_step(synth_root, tmp_path):
    """A real SIGTERM to ``python -m multimodal_similarity_tpu_torch
    train.base_model_batchhard --device cpu`` once two steps are logged:
    the process exits 0, says which step it checkpointed, and that
    checkpoint holds that step."""
    import pathlib
    results = pathlib.Path(synth_root) / "results"
    args = [sys.executable, "-m", "multimodal_similarity_tpu_torch",
            "train.base_model_batchhard", "--device", "cpu",
            "--DATA_ROOT", synth_root, "--name", "sig", "--network", "rtsn",
            "--feat", "sensors",
            "--n_input", "8", "--emb_dim", "16", "--num_seg", "3",
            "--sess_per_batch", "1", "--event_per_batch", "48",
            "--batch_size", "32", "--max_epochs", "100000",
            "--log_flush_every", "1", "--silent_mode"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            files = glob.glob(str(results / "sig_*" / "metrics.jsonl"))
            if files and sum(1 for line in open(files[0])
                             if '"loss"' in line) >= 2:
                break
            assert proc.poll() is None, proc.communicate()[0]
            time.sleep(0.05)
        else:
            pytest.fail("the trainer logged no two steps in 120 s")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    import re
    m = re.search(r"preemption signal: checkpointed at step (\d+)", out)
    assert m, out
    step = int(m.group(1))
    assert step >= 2
    model = build_encoder("rtsn", num_seg=3, emb_dim=16, n_input=8)
    (ckpt,) = glob.glob(str(results / "sig_*" / f"sig.ckpt-{step}"))
    assert load_checkpoint(ckpt, model) == step
