"""Shared scaffolding for the Honda-track trainers: dataset preparation,
the session loader, the validation preload, the result dir, logging and
checkpointing, the train feed (the loader's batches uploaded on the feed
thread, or the device feature cache (``--device_cache``) with its epoch of
fused cached steps) and run control: the ``--profile_dir`` step-window
trace, the SIGTERM guard with its checkpoint of the exact step, and the
``--watchdog_secs`` hang watchdog.  One or more modalities a loader row.
On a process mesh (parallel/mesh.py) process 0 owns the checkpoints, the
projector files and the trace; the others log under ``<name>_proc<pid>``,
and the stop decision is collective.  Under tensor parallelism
(parallel/tensor_parallel.py) the data mesh shards the sessions and the
cache, ownership stays with the world's process 0, and every rank of its
model group gathers the split state for its checkpoints."""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Callable, Iterable, List, Optional, Sequence

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import (
    SessionBatchLoader,
    load_validation_set,
    prepare_multimodal_dataset,
    tsn_prepare_input,
    tsn_prepare_input_test,
)
from multimodal_similarity_tpu_torch.data.device_cache import (
    DeviceFeatureCache, cache_budget_bytes, notice_window_shortfall)
from multimodal_similarity_tpu_torch.data.device_feed import device_prefetch
from multimodal_similarity_tpu_torch.parallel.multihost import (
    host_local_sessions)
from multimodal_similarity_tpu_torch.parallel.tensor_parallel import (
    gather_state_tp)
from multimodal_similarity_tpu_torch.train.cached_steps import (
    dispatch_plan_window)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    CheckpointManager)
from multimodal_similarity_tpu_torch.train.run_control import RunControl
from multimodal_similarity_tpu_torch.train.trainer import setup_experiment
from multimodal_similarity_tpu_torch.utils.logging import (
    DeferredStepLogs,
    MetricsLogger,
    write_projector_metadata,
)
from multimodal_similarity_tpu_torch.utils.profiling import span


class HondaExperiment:
    """Loader + validation arrays + bookkeeping for one experiment run."""

    def __init__(self, cfg: TrainConfig, *,
                 modalities: Optional[List[str]] = None,
                 event_budget: Optional[int] = None,
                 result_dir: Optional[str] = None,
                 limit_label_num: bool = True,
                 val_sessions: Optional[Sequence[str]] = None,
                 supports_int8: bool = False, mesh=None, tp=None,
                 session_shard: bool = False,
                 loader_seed: Optional[int] = None):
        """``modalities``: the feature names a loader row holds (default
        the first of ``cfg.feat``); the loader's batches carry them as
        ``events``, ``events2``, ``events3``, and ``val_extra`` holds the
        validation arrays of all but the first.  ``limit_label_num``: train
        on the first ``cfg.label_num`` sessions only (``labeled_sessions``
        are those ids either way); ``val_sessions``: validate on these in
        place of ``cfg.val_session``; ``supports_int8``: the trainer
        dequantizes --int8_features batches in its step (elsewhere the flag
        raises).  ``mesh`` (a parallel.ProcessMesh) makes this process one
        rank of a multi-process run; ``session_shard`` (``--multihost``)
        then loads only this rank's sessions (``host_local_sessions``) with
        the global lockstep batch count, each epoch truncated to it.
        ``tp`` (a parallel.TPMesh) makes it one rank of a data x model
        mesh: ``mesh`` is then its data mesh (None at a data axis of one),
        whose rows shard the sessions, and the world's rank owns the
        artifacts.  ``loader_seed`` seeds the loader (default
        ``cfg.seed``)."""
        self.mesh, self.tp = mesh, tp
        owner = tp.world if tp is not None else mesh
        self._pid, self._pcount = ((owner.rank, owner.size)
                                   if owner is not None else (0, 1))
        # the data rows that shard the sessions and the cache's budget
        self._row, self._rows = ((mesh.rank, mesh.size) if mesh is not None
                                 else (0, 1))
        if self._pid > 0:
            # per-process result scratch: process 0 owns the artifacts
            cfg = dataclasses.replace(cfg, name=f"{cfg.name}_proc{self._pid}")
            if result_dir is not None:
                result_dir = f"{result_dir}_proc{self._pid}"
        self.cfg = cfg
        if cfg.int8_features and not supports_int8:
            raise ValueError(
                "--int8_features is not supported by this trainer (it "
                "requires a device-fed step that dequantizes inline); "
                "supported: base_model (facenet), base_model_batchhard, "
                "base_model_lifted, multimodal_model --device_mining")
        if modalities is None:
            modalities = [cfg.feat if isinstance(cfg.feat, str)
                          else cfg.feat[0]]
        self.modalities = list(modalities)
        self.result_dir = setup_experiment(cfg, result_dir=result_dir)
        self.logger = MetricsLogger(self.result_dir)
        self.ckpt = CheckpointManager(self.result_dir, cfg.name)
        self.event_budget = event_budget or cfg.event_per_batch

        def prepare(sessions):
            return prepare_multimodal_dataset(
                cfg.feature_root, sessions, self.modalities, cfg.label_root,
                cfg.label_type)

        self.train_set = prepare(cfg.train_session)
        if limit_label_num:
            self.train_set = self.train_set[: cfg.label_num]
        self.labeled_sessions = set(cfg.train_session[: cfg.label_num])
        self.local_set = self.train_set
        self.lockstep = None  # --multihost: every rank's batches an epoch
        if session_shard and self._rows > 1:
            self.local_set = host_local_sessions(self.train_set, self._row,
                                                 self._rows)
            self.lockstep = ((len(self.train_set) // self._rows)
                             // cfg.sess_per_batch)
        self.batch_per_epoch = (self.lockstep if self.lockstep is not None
                                else len(self.local_set)
                                // cfg.sess_per_batch)
        # checked before the loader is built: an empty or short session
        # shard fails with this message, not the loader's
        if self.batch_per_epoch < 1 or not self.local_set:
            raise ValueError(
                f"{len(self.train_set)} train sessions < sess_per_batch="
                f"{cfg.sess_per_batch}"
                + (f" x {self._rows} processes" if self.lockstep is not None
                   else ""))
        self.loader = SessionBatchLoader(
            self.local_set, sess_per_batch=cfg.sess_per_batch,
            event_budget=self.event_budget,
            prepare_funcs=[functools.partial(tsn_prepare_input,
                                             cfg.num_seg)]
            * len(self.modalities),
            seed=cfg.seed if loader_seed is None else loader_seed)

        val_set = prepare(list(val_sessions or cfg.val_session))
        prep_test = functools.partial(tsn_prepare_input_test, cfg.num_seg)
        self.val_feats, self.val_labels, val_sess, val_bound = \
            load_validation_set([[r[0], r[-1]] for r in val_set], prep_test)
        self.val_extra = [
            load_validation_set([[r[m], r[-1]] for r in val_set],
                                prep_test)[0]
            for m in range(1, len(self.modalities))]
        write_projector_metadata(self.result_dir, self.val_labels, val_sess,
                                 val_bound)
        self._deferred = DeferredStepLogs(
            self.logger, flush_every=cfg.log_flush_every,
            echo=not cfg.silent_mode)
        self.last_cached_aux = None  # the last cached step's scalars
        self._cached = self._plans = self._stream = None  # open_feed's

        # the trace window, the SIGTERM guard and the watchdog; each
        # logged step advances the window and beats the watchdog, and so
        # does each validation chunk and cached session (control.beat_fn)
        self.control = RunControl(cfg, self._pid, self._pcount)

    @property
    def is_chief(self) -> bool:
        """True on process 0, which owns checkpoints and projector files."""
        return self._pid == 0

    def save(self, model, optimizer, step: int) -> None:
        """The epoch checkpoint, written by process 0.  Under tensor
        parallelism every rank calls it: the ranks of process 0's model
        group first gather the whole state (``gather_state_tp``), so the
        file is the one a run without it writes."""
        if self.tp is None:
            if self.is_chief:
                self.ckpt.save(model, optimizer, step)
        elif self.tp.data.rank == 0:
            state = gather_state_tp(model, optimizer)
            if self.is_chief:
                self.ckpt.save(model, optimizer, step, state)

    def preempted(self, step: int, model, optimizer) -> bool:
        """At an epoch's end (after an early stop, or not): on a preemption
        signal or a fired watchdog, checkpoint the exact ``step`` (process 0)
        so ``--model_path`` resumes with no lost step, report, and tell the
        caller to leave its loop.  The decision is collective on a mesh."""
        self.flush_logs()  # the queued steps are part of the saved run
        return self.control.preempted(
            step, lambda s: self.save(model, optimizer, s),
            collective_save=self.tp is not None)

    def loader_epoch(self):
        """One epoch of loader batches; under ``session_shard`` truncated
        to the lockstep count inside the loader (its RNG then draws for no
        batch that is dropped)."""
        return self.loader.epoch(max_batches=self.lockstep)

    # -- the device feature cache --------------------------------------------

    def build_cache(self, device, modality_modes=None, mesh=None
                    ) -> Optional[DeviceFeatureCache]:
        """``--device_cache``: this experiment's train windows (every
        modality) on ``device`` as int8, or None when the flag is off or
        the estimate exceeds ``--device_cache_gb`` (the trainer then
        streams).  A built cache sets ``batch_per_epoch`` to its plan's.

        On a process mesh the cache is built over it: ``mesh``, or without
        one the experiment's own mesh of two or more ranks, each rank
        holding its shard; the budget is rounded up to a multiple of the
        ranks.  Under ``--multihost`` (a session-sharded experiment) the
        caller passes its mesh; the cache plans from the full session list
        with the global budget (``event_budget`` x processes).  On a mesh a
        declined build streams: the JAX trainer's retry of an unsharded
        cache on one host's devices has no counterpart when a rank is a
        process (ROADMAP D6)."""
        cfg = self.cfg
        if not cfg.device_cache:
            return None
        if cfg.bf16_features:
            raise ValueError("--device_cache stores int8; it excludes "
                             "--bf16_features")
        budget = self.event_budget
        if self.lockstep is not None:
            if mesh is None:
                raise ValueError(
                    "--device_cache under --multihost needs the trainer's "
                    "global mesh passed to build_cache")
            budget = self.event_budget * self._rows
        else:
            mesh = mesh if mesh is not None else self.mesh
            if mesh is not None:
                budget = -(-budget // mesh.size) * mesh.size
        cache = DeviceFeatureCache.build(
            self.train_set, n_seg=cfg.num_seg,
            sess_per_batch=cfg.sess_per_batch, event_budget=budget,
            seed=cfg.seed, device=device, mesh=mesh,
            budget_bytes=cache_budget_bytes(cfg.device_cache_gb),
            modality_modes=modality_modes, beat=self.control.beat_fn,
            verbose=not cfg.silent_mode)
        if cache is not None:
            self.batch_per_epoch = cache.batches_per_epoch
            if self.lockstep is None:
                self.event_budget = budget
            if cfg.steps_per_dispatch > 1:
                notice_window_shortfall(cache, cfg.steps_per_dispatch,
                                        cfg.name, cfg.silent_mode)
        return cache

    def run_cached_epoch(self, cache: DeviceFeatureCache, fused: Callable,
                         lr: float, step_host: int, epoch: int,
                         echo: Optional[Callable] = None,
                         plans: Optional[Sequence] = None) -> int:
        """One epoch of the cache's plans (or the given host ``plans``)
        through the fused step ``fused(plan, lr)``, in
        ``--steps_per_dispatch`` windows issued back to back.  Scalars are
        logged deferred, ``train_time`` a window's host time a step;
        ``echo(epoch, step, scalars)`` gives a step's echo line.  The last
        step's device scalars stay on ``last_cached_aux``.  The stop is
        polled after each window.  Returns the new step count."""
        k = self.cfg.steps_per_dispatch
        if plans is None:
            with span("cache.plan"):
                plans = [p["packed"] for p in cache.epoch_plans()]
        for start in range(0, len(plans), k):
            win = plans[start:start + k]
            t0 = time.time()
            aux_list = dispatch_plan_window(win, lr, fused=fused,
                                            device=cache.device)
            dt = (time.time() - t0) / len(win)
            for aux in aux_list:
                step_host += 1
                self.last_cached_aux = aux
                self._log_step(step_host, aux, dt, lr, epoch, echo)
            if self.control.stop_requested(step_host):
                break
        self.flush_logs()
        return step_host

    # -- the train feed -------------------------------------------------------

    def open_feed(self, device, batches: Iterable, device_keys: Sequence[str],
                  cached: Optional[tuple] = None,
                  plans: Optional[Callable] = None, **casts) -> None:
        """The run's train feed, read by ``run_epoch`` and closed by
        ``close``: ``cached`` (a (cache, fused step) pair from
        ``build_cache``) gathers every batch on the device, from an epoch
        of ``plans()`` when given; otherwise ``batches`` (loader batches,
        None for a draw to skip) go up on the feed thread with
        ``device_keys`` and ``casts`` (data/device_feed.py)."""
        self._cached, self._plans = cached, plans
        self._stream = None if cached is not None else device_prefetch(
            batches, device, device_keys=tuple(device_keys), **casts)

    def run_epoch(self, step: Callable, lr: float, step_host: int,
                  epoch: int, echo: Optional[Callable] = None) -> int:
        """One epoch of the open feed: the cached epoch, or
        ``step(batch, lr)`` on each of ``batch_per_epoch`` streamed
        batches (a None batch or result is skipped).  Scalars are logged
        deferred, ``train_time`` the step's host enqueue interval (the
        device time shows in the flush cadence).  The stop is polled after
        every step; the caller checkpoints it with ``preempted``.  Returns
        the new step count."""
        if self._cached is not None:
            return self.run_cached_epoch(
                *self._cached, lr, step_host, epoch, echo,
                plans=None if self._plans is None else self._plans())
        for batch in itertools.islice(self._stream, self.batch_per_epoch):
            if batch is None:
                continue
            t0 = time.time()
            aux = step(batch, lr)
            if aux is None:
                continue
            step_host += 1
            self._log_step(step_host, aux, time.time() - t0, lr, epoch, echo)
            if self.control.stop_requested(step_host):
                break
        self.flush_logs()
        return step_host

    def _log_step(self, step_host, aux, dt, lr, epoch, echo):
        self.log_deferred(
            step_host, aux, {"train_time": dt, "learning_rate": lr},
            echo_fn=(None if echo is None else
                     lambda sc: echo(epoch, step_host, sc)))

    def log(self, step: int, scalars, echo: str = ""):
        self.flush_logs()  # keep the JSONL stream step-ordered
        self.control.step_done(step)
        self.logger.log(step, {k: float(v) for k, v in scalars.items()})
        if echo and not self.cfg.silent_mode:
            print(echo)

    def log_deferred(self, step: int, device_scalars, host_scalars=None,
                     echo_fn=None):
        """``log`` without the per-step device-to-host readback: the step's
        device scalars are queued and read every --log_flush_every steps.
        The watchdog beats after the append, so after any readback it
        made: a wedged device stalls that readback and the beats stop."""
        self._deferred.append(step, device_scalars, host_scalars, echo_fn)
        self.control.step_done(step)

    def flush_logs(self):
        """Block until every queued step's scalars are logged."""
        self._deferred.flush()

    def close(self):
        if self._stream is not None:
            self._stream.close()  # cancels the feed and loader threads
        self._deferred.close()
        self.control.close()
        self.logger.close()
