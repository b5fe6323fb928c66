"""Shared scaffolding for the Honda-track trainers: dataset preparation,
the session loader, the validation preload, the result dir, logging and
checkpointing.  One or more modalities a loader row; single process."""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import (
    SessionBatchLoader,
    load_validation_set,
    prepare_multimodal_dataset,
    tsn_prepare_input,
    tsn_prepare_input_test,
)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    CheckpointManager)
from multimodal_similarity_tpu_torch.train.trainer import setup_experiment
from multimodal_similarity_tpu_torch.utils.logging import (
    DeferredStepLogs,
    MetricsLogger,
    write_projector_metadata,
)


class HondaExperiment:
    """Loader + validation arrays + bookkeeping for one experiment run."""

    def __init__(self, cfg: TrainConfig, *,
                 modalities: Optional[List[str]] = None,
                 event_budget: Optional[int] = None,
                 result_dir: Optional[str] = None,
                 limit_label_num: bool = True,
                 val_sessions: Optional[Sequence[str]] = None,
                 supports_int8: bool = False):
        """``modalities``: the feature names a loader row holds (default
        the first of ``cfg.feat``); the loader's batches carry them as
        ``events``, ``events2``, ``events3``, and ``val_extra`` holds the
        validation arrays of all but the first.  ``limit_label_num``: train
        on the first ``cfg.label_num`` sessions only (``labeled_sessions``
        are those ids either way); ``val_sessions``: validate on these in
        place of ``cfg.val_session``; ``supports_int8``: the trainer
        dequantizes --int8_features batches in its step (elsewhere the flag
        raises)."""
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
        self.batch_per_epoch = len(self.train_set) // cfg.sess_per_batch
        if self.batch_per_epoch < 1:
            raise ValueError(f"{len(self.train_set)} train sessions < "
                             f"sess_per_batch={cfg.sess_per_batch}")
        self.loader = SessionBatchLoader(
            self.train_set, sess_per_batch=cfg.sess_per_batch,
            event_budget=self.event_budget,
            prepare_funcs=[functools.partial(tsn_prepare_input,
                                             cfg.num_seg)]
            * len(self.modalities),
            seed=cfg.seed)

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

    def log(self, step: int, scalars, echo: str = ""):
        self.flush_logs()  # keep the JSONL stream step-ordered
        self.logger.log(step, {k: float(v) for k, v in scalars.items()})
        if echo and not self.cfg.silent_mode:
            print(echo)

    def log_deferred(self, step: int, device_scalars, host_scalars=None,
                     echo_fn=None):
        """``log`` without the per-step device-to-host readback: the step's
        device scalars are queued and read every --log_flush_every steps."""
        self._deferred.append(step, device_scalars, host_scalars, echo_fn)

    def flush_logs(self):
        """Block until every queued step's scalars are logged."""
        self._deferred.flush()

    def close(self):
        self._deferred.close()
        self.logger.close()
