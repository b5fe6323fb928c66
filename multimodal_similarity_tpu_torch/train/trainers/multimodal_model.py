"""Flagship semi-supervised multimodal trainer
(``scripts/train_multimodal_model.sh``).

Three branches in one ``nn.ModuleDict`` named as the JAX params: the
trainable core video encoder (``modality_core``), and the sensors and
segment branches (``modality_sensors`` / ``modality_segment``, each an RTSN
``encoder`` with emb_dim 32 and a ``pddm`` head), restored from
``pddm_model`` checkpoints (``--sensors_path`` / ``--segment_path``).  The
branch encoders are frozen; with ``--no_joint`` the whole branches are.
Each loader batch:

1. facenet semi-hard triplets from the core embeddings of the labeled
   budget;
2. from epoch ``--multimodal_epochs`` on, the fused PDDM pseudo-similarity
   0.5 (sensors + segment) of the budget's events;
3. hard mining (same-label pairs of low similarity, other-label pairs of
   high similarity) and structure mining (far negatives of a hard
   negative's class, with per-class margins from ``dist_dict``, the mean
   pairwise validation distance of each class);
4. one step on the three masked triplet groups, ``loss1 + (loss2 + 0.3
   loss3) * lambda_multimodal``.

Two paths.  The default mines on the host as the reference does: the
three modalities go up on the feed thread (data/device_feed.py), labels
stay on the host, and the main thread reads back the core distances and
the fused [n, n] similarity for ``select_triplets_facenet`` and
``select_triplets_mul``; each step is logged with a readback.
``--device_mining`` runs ``make_mm_fused_step``: the semi-hard miner, the
PDDM rows of the sampled anchors and ``mine_hard_structure_triplets_rowwise``
on the device, with no readback (``log_deferred``).  With it,
``--device_cache`` keeps the three modalities on the device as int8 and a
fused step gathers each batch there (train/cached_steps.py), with the
class-margin table and the multimodal switch as epoch constants;
``--steps_per_dispatch`` K runs K such steps back to back.

With ``--device_mining`` on more than one process (``torchrun``, or
``--multihost`` with the coordinator flags) the fused step is
data-parallel (ROADMAP D6): under ``torchrun`` every rank draws the global
batch and keeps its rows; under ``--multihost`` each rank loads its
session shard into its slice of the budget, for the global lockstep batch
count, and the step gathers labels and mask.  The cache is sharded over
the ranks.  Process 0 writes the checkpoints, ``dist_dict`` and the
projector files.  The host miners are single-process: ``--multihost``
without ``--device_mining`` raises, as in JAX.  No CUDA kernel of
``csrc/`` is on either path.

With ``--device_mining`` and --model_parallel N the ranks form a data x
model mesh (parallel/tensor_parallel.py): the whole state (the core, the
branch encoders and the PDDM heads, with their Adam moments) is
column-sharded over each model group, and its data axis takes the place
of the processes above (at a data axis of one, every rank runs the
single-device fused step).  Without ``--device_mining`` the flag raises,
as in JAX.

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.multimodal_model --DATA_ROOT <dir> --feat resnet,sensors,segment --sensors_path <ckpt> --segment_path <ckpt> ...
(``--device_mining`` for the fused step; ``--device cpu`` runs on the CPU;
the default is ``cuda``.)
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import LABEL_TRANSFER
from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, feature_keys, take_features)
from multimodal_similarity_tpu_torch.models import (
    BRANCH_EMB_DIM, PDDM, RTSN, build_encoder, score_all_pairs_sym,
    score_rows)
from multimodal_similarity_tpu_torch.models.encoders import Dropout
from multimodal_similarity_tpu_torch.ops.distances import cdist_rows
from multimodal_similarity_tpu_torch.ops.losses import triplet_loss_masked
from multimodal_similarity_tpu_torch.ops.mining import (
    mine_hard_structure_triplets_rowwise,
    mine_semihard_triplets_from_embeddings, select_triplets_facenet)
from multimodal_similarity_tpu_torch.parallel.data_parallel import (
    backward_once, gather_rows, gather_shares, share, sum_gradients)
from multimodal_similarity_tpu_torch.parallel.mesh import replicate
from multimodal_similarity_tpu_torch.parallel.ring_mining import (
    all_gather_rows)
from multimodal_similarity_tpu_torch.train.cached_steps import (
    make_cached_body_step)
from multimodal_similarity_tpu_torch.train.checkpoints import (
    load_checkpoint, restore_encoder_params)
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, l2_normalize, make_embed_fn)
from multimodal_similarity_tpu_torch.train.trainer import (
    epoch_of_step, validate)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.train.trainers._loop import (
    loader_batches)
from multimodal_similarity_tpu_torch.train.trainers.base_model_batchhard \
    import TrainResult, _check_supported, process_mesh, shard_for_tp
from multimodal_similarity_tpu_torch.utils.profiling import (
    count, recording, span)

BRANCHES = ("modality_sensors", "modality_segment")
# the flagship's mining thresholds and hard triplets an anchor
THRESHOLD_UP, THRESHOLD_DOWN, TRIPLET_PER_EVENT = 0.8, 0.2, 3


def select_triplets_mul(triplet_input_idx, lab, sim_prob, dist_dict,
                        triplet_per_batch, triplet_per_event=2,
                        threshold_up=0.65, threshold_down=0.35, rng=None,
                        mine_struct=True):
    """Hard + structure mining from pseudo-similarities on the host, a
    copy of the JAX package's: the same ``RandomState`` gives the same
    indices.  ``sim_prob`` is a host float array (NaN on the diagonal).
    ``mine_struct=False`` is the hard-mining-only ablation: no structure
    triplets, and at most ``triplet_per_batch`` mined triplets."""
    rng = rng or np.random
    lab = np.asarray(lab).reshape(-1, 1)

    triplet_selected = []
    for i in range(0, len(triplet_input_idx), 3):
        triplet = (triplet_input_idx[i], triplet_input_idx[i + 1],
                   triplet_input_idx[i + 2])
        if triplet not in triplet_selected:
            triplet_selected.append(triplet)

    triplet_count = len(triplet_selected)
    adjacency = np.equal(lab, lab.T)

    struct_selected: List[tuple] = []
    margins: List[float] = []
    for i in rng.permutation(lab.shape[0]):
        if lab[i] > 0:
            hard_pos = np.where(np.logical_and(
                adjacency[i], sim_prob[i] < threshold_down))[0]
            hard_neg = np.where(np.logical_and(
                ~adjacency[i], sim_prob[i] > threshold_up))[0]

            if len(hard_pos) == 0:
                all_pos = np.where(adjacency[i])[0]
                if len(all_pos) == 1:
                    continue
                sim = sim_prob[i, all_pos]
                hard_pos = np.array([all_pos[np.nanargmin(sim)]], "int32")
            if len(hard_neg) == 0:
                all_neg = np.where(~adjacency[i])[0]
                if len(all_neg) == 1:
                    continue
                sim = sim_prob[i, all_neg]
                hard_neg = np.array([all_neg[np.nanargmax(sim)]], "int32")

            hard_comb = [(hp, hn) for hn in hard_neg for hp in hard_pos]
            rng.shuffle(hard_comb)
            for count in range(min(triplet_per_event, len(hard_comb))):
                hp, hn = hard_comb[count]
                triplet = (i, hp, hn)
                if triplet not in triplet_selected:
                    triplet_selected.append(triplet)
                    if not mine_struct:
                        continue
                    far_neg = np.where(np.logical_and(
                        np.squeeze(lab) == lab[hn],
                        sim_prob[i] < threshold_down))[0]
                    if len(far_neg):
                        fn = rng.choice(far_neg)
                        triplet = (i, hn, fn)
                        if triplet not in struct_selected:
                            struct_selected.append(triplet)
                            margins.append(dist_dict[int(lab[fn, 0])][-1])

        if (len(struct_selected) + len(triplet_selected) - triplet_count
                >= triplet_per_batch):
            break

    if not mine_struct:
        triplet_selected = triplet_selected[: triplet_count
                                            + triplet_per_batch]
    hard_count = len(triplet_selected) - triplet_count
    struct_selected = struct_selected[: triplet_per_batch - hard_count]
    struct_count = len(struct_selected)
    margins = margins[:struct_count]

    triplet_input_idx = [idx for tri in triplet_selected + struct_selected
                         for idx in tri]
    return triplet_input_idx, margins, triplet_count, hard_count, struct_count


def select_triplets_mul_hard(triplet_input_idx, lab, sim_prob,
                             triplet_per_batch, triplet_per_event=2,
                             threshold_up=0.65, threshold_down=0.35,
                             rng=None):
    """The hard-mining-only ablation: :func:`select_triplets_mul` without
    the structure term."""
    flat, _, triplet_count, hard_count, _ = select_triplets_mul(
        triplet_input_idx, lab, sim_prob, {}, triplet_per_batch,
        triplet_per_event, threshold_up, threshold_down, rng=rng,
        mine_struct=False)
    return flat, triplet_count, hard_count


def init_dist_dict(val_embeddings: torch.Tensor, val_labels,
                   metric: str) -> Dict[int, list]:
    """Per-class mean pairwise distance of the validation embeddings (exact
    differences), for every label 0..max; 0.0 for an empty class."""
    val_labels = np.asarray(val_labels).reshape(-1)
    dist_dict: Dict[int, list] = {}
    for i in range(int(np.max(val_labels)) + 1):
        dist_dict[i] = [_class_mean_distance(val_embeddings, val_labels, i,
                                             metric)]
    return dist_dict


def _class_mean_distance(emb: torch.Tensor, labels: np.ndarray, label: int,
                         metric: str) -> float:
    rows = np.where(labels == label)[0]
    if not rows.size:
        return 0.0
    temp = emb[torch.from_numpy(rows).to(emb.device)]
    return float(cdist_rows(temp, temp, metric).mean())


def margin_table(dist_dict: Dict[int, list],
                 device: torch.device) -> torch.Tensor:
    """The fused step's per-class margins: the latest ``dist_dict`` entry
    of every label the training batches can carry (the LABEL_TRANSFER
    range, and every validation class), 0.0 where the validation set has
    none, so no label reads another class's margin."""
    n_classes = max(max(dist_dict), max(LABEL_TRANSFER.values())) + 1
    return torch.tensor([dist_dict.get(c, [0.0])[-1]
                         for c in range(n_classes)],
                        dtype=torch.float32, device=device)


def _pad_triplets(idx: List[int], margins: List[float], counts, tri_cap: int):
    """[a,p,n,...] flat list -> fixed arrays: gather index [3*tri_cap],
    per-group masks [tri_cap], margins [tri_cap] (a copy of the JAX
    package's)."""
    triplet_count, hard_count, struct_count = counts
    total = triplet_count + hard_count + struct_count
    total = min(total, tri_cap)
    gather = np.zeros(3 * tri_cap, np.int32)
    flat = np.asarray(idx[: 3 * total], np.int32).reshape(-1, 3)
    gather[: 3 * total] = flat.reshape(-1)
    m_lab = np.zeros(tri_cap, np.float32)
    m_hard = np.zeros(tri_cap, np.float32)
    m_struct = np.zeros(tri_cap, np.float32)
    marg = np.zeros(tri_cap, np.float32)
    m_lab[: min(triplet_count, total)] = 1.0
    h_end = min(triplet_count + hard_count, total)
    m_hard[min(triplet_count, total): h_end] = 1.0
    s_end = min(total, tri_cap)
    m_struct[h_end: s_end] = 1.0
    marg[h_end: s_end] = np.asarray(margins[: s_end - h_end], np.float32)
    return gather, m_lab, m_hard, m_struct, marg


def build_model(cfg: TrainConfig, device: torch.device,
                **branch_dims: int) -> nn.ModuleDict:
    """The core encoder of ``cfg`` as ``modality_core``, and for each
    ``<name>=<input dim>`` of ``branch_dims`` (``sensors``, ``segment``)
    a branch ``modality_<name>`` of an RTSN ``encoder`` (emb_dim 32) and a
    ``pddm`` head, in the JAX trainers' scope names (``convert.py`` maps
    the nested flax params by name).  Weights are drawn from ``cfg.seed``
    in that order; the core's dropout from ``cfg.seed + 1``.  The branches
    stay in eval mode: the trainers run their encoders without dropout, as
    the JAX ones do."""
    init_gen = torch.Generator().manual_seed(cfg.seed)
    mods = {"modality_core": build_encoder(
        cfg.network, num_seg=cfg.num_seg, emb_dim=cfg.emb_dim,
        n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w, n_C=cfg.n_C,
        keep_prob=cfg.keep_prob, generator=init_gen,
        dropout_generator=torch.Generator(device=device).manual_seed(
            cfg.seed + 1))}
    for name, dim in branch_dims.items():
        mods[f"modality_{name}"] = nn.ModuleDict({
            "encoder": RTSN(n_seg=cfg.num_seg, emb_dim=BRANCH_EMB_DIM,
                            n_input=dim, keep_prob=cfg.keep_prob,
                            generator=init_gen),
            "pddm": PDDM(BRANCH_EMB_DIM, init_gen)}).eval()
    return nn.ModuleDict(mods).to(device)


def restore_branch(branch: nn.Module, path: str,
                   subkey: Optional[str] = None) -> None:
    """Copy the parameters of a ``pddm_model`` checkpoint (groups
    ``encoder`` and ``pddm``) that ``branch`` also has into it; the rest
    keep their values (the JAX ``_graft``).  With ``subkey``, a checkpoint
    that has that group gives only its parameters, the group's prefix
    dropped (a bare encoder restored from a ``pddm_model`` checkpoint)."""
    saved = restore_encoder_params(path, subkey=subkey)
    state = branch.state_dict()
    state.update({k: v for k, v in saved.items() if k in state})
    branch.load_state_dict(state)


def mm_optimizer(cfg: TrainConfig, model: nn.Module):
    """The configured optimizer with both branches frozen under
    ``--no_joint``, else their encoders alone (the PDDM heads then take
    the 0.1 branch scale)."""
    frozen = BRANCHES if cfg.no_joint else tuple(f"{b}/encoder"
                                                 for b in BRANCHES)
    return build_optimizer(cfg.optimizer, model, cfg.learning_rate,
                           frozen_scopes=frozen)


def _mm_update(model: nn.Module, optimizer, cfg: TrainConfig, tri_events,
               mask_lab, mask_hard, mask_struct, margins,
               learning_rate: float, mesh=None) -> dict:
    """Train-mode forward of the [a, p, n, a, p, n, ...] rows, the three
    masked triplet losses, one optimizer step; device scalars.  On a
    ``mesh`` ``tri_events`` is this rank's ``share`` of the rows: the
    embeddings are gathered into the one global loss, this rank's rows
    take its gradient, and the gradients are summed over the ranks."""
    with span("mm.forward_loss"):
        core = model["modality_core"]
        core.train()
        optimizer.zero_grad(set_to_none=True)
        n_rows = 3 * mask_lab.shape[0]
        if mesh is None:
            emb = core(tri_events)
        else:
            with Dropout.global_rows(n_rows, share(n_rows, mesh)):
                emb = core(tri_events)
        if cfg.normalized:
            emb = l2_normalize(emb)
        if mesh is not None:
            emb = gather_shares(emb, n_rows, mesh)
        tri = emb.reshape(mask_lab.shape[0], 3, -1)
        a, p, n = tri[:, 0], tri[:, 1], tri[:, 2]
        loss1 = triplet_loss_masked(a, p, n, mask_lab, cfg.alpha)
        loss2 = triplet_loss_masked(a, p, n, mask_hard, cfg.alpha)
        basic = torch.clamp(((a - p) ** 2).sum(1) - ((a - n) ** 2).sum(1)
                            + margins, min=0.0)
        loss3 = (basic * mask_struct).sum() / torch.clamp(mask_struct.sum(),
                                                          min=1.0)
        total = loss1 + (loss2 + loss3 * 0.3) * cfg.lambda_multimodal
        reg = (cfg.lambda_l2 * l2_regularization(model) if cfg.lambda_l2
               else None)
    with span("mm.backward"):
        if mesh is None:
            (total if reg is None else total + reg).backward()
        else:
            backward_once(total, reg, mesh)
            sum_gradients(model, mesh)
        if reg is not None:
            total = total + reg
    with span("mm.optimizer"):
        apply_gradients(optimizer, learning_rate)
    return {"loss": total.detach(), "metric_loss1": loss1.detach(),
            "metric_loss2": loss2.detach(), "metric_loss3": loss3.detach()}


def fused_similarity(model: nn.Module, eve_sensors: torch.Tensor,
                     eve_segment: torch.Tensor) -> torch.Tensor:
    """[N] sensors and segment events -> the fused [N, N] PDDM similarity
    0.5 (sensors + segment), upper-triangle tiles of min(128, N) rows."""
    out = []
    with torch.no_grad():
        for scope, x in zip(BRANCHES, (eve_sensors, eve_segment)):
            emb = model[scope]["encoder"](x)
            out.append(score_all_pairs_sym(model[scope]["pddm"].score, emb,
                                           block=min(128, emb.shape[0])))
    return 0.5 * (out[0] + out[1])


def _caps(cfg: TrainConfig):
    """The fused step's triplets a step: (semi-hard, hard, structure)."""
    return (cfg.triplet_per_batch, cfg.triplet_per_batch,
            cfg.triplet_per_batch // 2)


def make_mm_fused_step(model: nn.Module, optimizer, cfg: TrainConfig,
                       generator: Optional[torch.Generator],
                       hard_only: bool = False, mesh=None,
                       gather_smalls: bool = False) -> Callable:
    """The fused flagship step, no host readback: the eval-mode core
    embedding of the budget and the semi-hard miner; the branch encoders,
    both PDDMs' rows for the sampled anchors and the row-wise hard +
    structure miner; the gather of the mined triplets in the feed's
    storage type; the train-mode re-forward and the three masked losses
    (the structure term dropped under ``hard_only``).

    Returns step(events, eve_sensors, eve_segment, labels, mask,
    class_margins, use_multimodal, learning_rate) -> device scalars.
    ``events`` is dense or the int8 feed's {"q", "scale"}; ``generator``
    (on the device) drives both miners' draws.

    On a ``mesh`` (a parallel.ProcessMesh) the three modalities are this
    rank's rows [r m, (r + 1) m) of the global batch and the step is
    data-parallel: each rank embeds its rows, the core and branch
    embeddings are all-gathered (no gradient) and every rank mines the
    same triplets from the same draws, the mined rows reach the ranks that
    re-forward them in one all-to-all (``gather_rows``), each rank takes
    the gradient of the one global loss for its share and the gradients
    are summed.  The dropout masks are drawn for the whole batch and
    sliced, so every random stream is the one device's.
    ``gather_smalls`` (``--multihost``): labels and mask arrive as this
    rank's rows too and are all-gathered first."""
    _, hard_cap, struct_cap = _caps(cfg)
    core_embed = make_embed_fn(model["modality_core"], cfg.normalized)

    def gathered(x):
        return x if mesh is None else all_gather_rows(x, mesh)

    def step(events, eve_sensors, eve_segment, labels, mask, class_margins,
             use_multimodal: float, learning_rate: float):
        if mesh is not None and gather_smalls:
            labels, mask = gathered(labels), gathered(mask)
        with span("mm.embed"):
            emb = gathered(core_embed(dequant_features(events)))
        with span("mm.mine_semihard"):
            lab = mine_semihard_triplets_from_embeddings(
                emb, labels, generator, cfg.triplet_per_batch,
                alpha=cfg.alpha, num_negative=cfg.num_negative, valid=mask,
                metric=cfg.metric)
        with torch.no_grad():
            with span("mm.branches"):
                embs = [gathered(model[s]["encoder"](dequant_features(x)))
                        for s, x in zip(BRANCHES, (eve_sensors, eve_segment))]

            def sim_rows(rows):
                with span("mm.pddm"):
                    return 0.5 * sum(
                        score_rows(model[s]["pddm"].score, e, rows)
                        for s, e in zip(BRANCHES, embs))

            with span("mm.mine_rowwise"):
                mul = mine_hard_structure_triplets_rowwise(
                    sim_rows, labels, class_margins, generator,
                    hard_budget=hard_cap, struct_budget=struct_cap,
                    threshold_up=THRESHOLD_UP, threshold_down=THRESHOLD_DOWN,
                    valid=mask)
        lab_t = lab.anchor.shape[0]

        def zeros(k):
            return torch.zeros(k, device=lab.mask.device)

        with span("mm.take"):
            gather = torch.cat([
                torch.stack([lab.anchor, lab.positive, lab.negative],
                            dim=1).reshape(-1),
                mul.hard.reshape(-1), mul.struct.reshape(-1)])
            mm = mul.hard_mask * use_multimodal
            sm = (torch.zeros_like(mul.struct_mask) if hard_only
                  else mul.struct_mask * use_multimodal)
            if mesh is None:
                tri_events = take_features(events, gather)
            else:
                rows = events["q"] if isinstance(events, dict) else events
                tri_events = gather_rows(events, gather, mesh, rows.shape[0])
            tri_events = dequant_features(tri_events)
            masks = (torch.cat([lab.mask, zeros(hard_cap + struct_cap)]),
                     torch.cat([zeros(lab_t), mm, zeros(struct_cap)]),
                     torch.cat([zeros(lab_t + hard_cap), sm]),
                     torch.cat([zeros(lab_t + hard_cap), mul.margins]))
        aux = _mm_update(model, optimizer, cfg, tri_events, *masks,
                         learning_rate, mesh)
        aux.update(triplet_count=lab.mask.sum(), hard_count=mm.sum(),
                   struct_count=sm.sum(), active_count=lab.active_count)
        return aux

    return step


def make_host_step(model: nn.Module, optimizer, cfg: TrainConfig,
                   device: torch.device, dist_dict: Dict[int, list],
                   mine_rng: random.Random, mul_rng: np.random.RandomState,
                   hard_only: bool = False) -> Callable:
    """The reference's host-mining step: run(batch, learning_rate,
    multimodal) -> the step's scalars (device tensors and host counts), or
    None when the facenet miner finds no triplet.  The batch's three
    modalities are on ``device``, its labels on the host.  The core
    distances and the fused similarity are read back for the NumPy miners;
    the mined rows are gathered on the device (cast to bf16 under
    --bf16_features, as the JAX trainer casts them)."""
    tri_cap = 2 * cfg.triplet_per_batch
    core_embed = make_embed_fn(model["modality_core"], cfg.normalized)

    def run(batch, learning_rate: float, multimodal: bool = True):
        n = int(batch["num_events"])
        labels = batch["labels"][:n]
        emb = embed_in_chunks(core_embed, batch["events"][:n], device)
        dists = cdist_rows(emb, emb, cfg.metric).cpu().numpy()
        idx, active_count = select_triplets_facenet(
            labels, dists, cfg.triplet_per_batch, cfg.alpha,
            cfg.num_negative, rng=mine_rng)
        if not idx:
            return None
        counts, margins = (len(idx) // 3, 0, 0), []
        if multimodal:
            sim = fused_similarity(model, batch["events2"],
                                   batch["events3"])[:n, :n].cpu().numpy()
            np.fill_diagonal(sim, np.nan)
            if hard_only:
                idx, t, h = select_triplets_mul_hard(
                    idx, labels.reshape(-1, 1), sim, cfg.triplet_per_batch,
                    TRIPLET_PER_EVENT, THRESHOLD_UP, THRESHOLD_DOWN,
                    rng=mul_rng)
                counts = (t, h, 0)
            else:
                idx, margins, *counts = select_triplets_mul(
                    idx, labels, sim, dist_dict, cfg.triplet_per_batch,
                    TRIPLET_PER_EVENT, THRESHOLD_UP, THRESHOLD_DOWN,
                    rng=mul_rng)
        gather, *masks = (torch.from_numpy(a).to(device) for a in
                          _pad_triplets(idx, margins, counts, tri_cap))
        tri_events = batch["events"].index_select(0, gather.long())
        if cfg.bf16_features:
            tri_events = tri_events.to(torch.bfloat16)
        aux = _mm_update(model, optimizer, cfg, tri_events, *masks,
                         learning_rate)
        aux.update(active_count=active_count, triplet_count=counts[0],
                   hard_count=counts[1], struct_count=counts[2])
        return aux

    return run


def rank_batches(exp: HondaExperiment, mesh=None, multihost: bool = False):
    """Loader batches epoch after epoch, for the feed thread.  On a
    ``mesh`` without --multihost every rank draws the global batch and
    keeps its rows of the three modalities (labels and mask stay global);
    under --multihost the loader's batch is this rank's rows already."""
    for b in loader_batches(exp):
        if mesh is not None and not multihost:
            rows = mesh.rows(len(b["events"]))
            for key in ("events", "events2", "events3"):
                b[key] = b[key][rows]
        yield b


def _echo(cfg, epoch, step, loss, tri, hard, struct, fused=True):
    """A step's echo line.  While a profile records, the fused step's
    (``fused``) mined triplets that fired are counted (``mm.semihard_fired``,
    ``mm.hard_fired``, ``mm.struct_fired``) against the rows it pads every
    miner to (``mm.triplet_budget``: ``triplet_per_batch`` semi-hard, as
    many hard and half as many structure triplets a step)."""
    if fused and recording():
        count("mm.semihard_fired", tri)
        count("mm.hard_fired", hard)
        count("mm.struct_fired", struct)
        count("mm.triplet_budget", sum(_caps(cfg)))
    return (f"[{cfg.name}] epoch {epoch + 1} step {step} loss {loss:.4f} "
            f"tri/hard/struct {tri:.0f}/{hard:.0f}/{struct:.0f}")


def train(cfg: TrainConfig, hard_only: bool = False,
          device_mining: bool = False, event_budget: Optional[int] = None,
          result_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train on ``device`` (default ``cuda``; raises when no card is
    visible and the CPU was not asked for).  ``device_mining`` runs the
    fused step, ``hard_only`` drops the structure term.  ``--model_path``
    restores a port checkpoint (weights, optimizer state and step)."""
    name = "multimodal_model_hardonly" if hard_only else "multimodal_model"
    if cfg.multihost and not device_mining:
        raise NotImplementedError(
            "--multihost requires --device_mining (the fused step; host "
            "miners are single-process)")
    _check_supported(cfg, name, data_parallel=device_mining, multihost=True,
                     tensor_parallel=True)
    if cfg.int8_features and not device_mining:
        raise ValueError("--int8_features requires --device_mining (the "
                         "device-fed path); the host miners gather dense "
                         "features")
    if cfg.device_cache and not device_mining:
        raise ValueError("--device_cache requires --device_mining (the "
                         "fused device-fed step)")
    device = resolve_device(device)
    event_budget = event_budget or cfg.event_per_batch
    mesh = tp = None
    if device_mining:
        # the budget rounded up to a multiple of the processes (of the data
        # axis under --model_parallel); on a mesh the rank's own device
        mesh, event_budget, device, tp = process_mesh(cfg, event_budget,
                                                      device)
    elif cfg.model_parallel > 1:
        raise ValueError("--model_parallel requires --device_mining "
                         "(the fused jitted step)")
    if cfg.multihost and mesh is None and tp is None:
        raise RuntimeError("--multihost needs >= 2 devices across processes")
    rows = mesh.size if mesh is not None else 1
    modalities = cfg.feat if isinstance(cfg.feat, list) else \
        ["resnet", "sensors", "segment"]
    # --multihost: this rank loads its session shard into its slice of the
    # budget, for the global lockstep batch count
    exp = HondaExperiment(cfg, modalities=modalities,
                          supports_int8=device_mining,
                          event_budget=(event_budget // rows
                                        if cfg.multihost else event_budget),
                          result_dir=result_dir,
                          limit_label_num=(cfg.task == "supervised"),
                          mesh=mesh, tp=tp, session_shard=cfg.multihost)
    model = build_model(cfg, device, sensors=exp.val_extra[0].shape[-1],
                        segment=exp.val_extra[1].shape[-1])
    for scope, path in zip(BRANCHES, (cfg.sensors_path, cfg.segment_path)):
        if path:
            restore_branch(model[scope], path)
    optimizer = mm_optimizer(cfg, model)
    step_host = 0
    if cfg.model_path:
        step_host = load_checkpoint(cfg.model_path, model, optimizer)
    if tp is not None:
        replicate([p.data for p in model.parameters()], tp.world)
        shard_for_tp(cfg, model, optimizer, tp)
        if not cfg.silent_mode:
            print(f"[{cfg.name}] data-parallel fused step over {rows} "
                  f"devices x {cfg.model_parallel} model-parallel"
                  + (f" on {rows} hosts" if cfg.multihost else ""))
    elif mesh is not None:
        replicate([p.data for p in model.parameters()], mesh)
        if not cfg.silent_mode:
            print(f"[{cfg.name}] data-parallel fused step over {mesh.size} "
                  "processes" + (" (multihost)" if cfg.multihost else ""))

    embed_fn = make_embed_fn(model["modality_core"], cfg.normalized)
    val_x = torch.from_numpy(exp.val_feats).to(device)
    val_labels = exp.val_labels.reshape(-1)
    dist_dict = init_dist_dict(embed_in_chunks(embed_fn, val_x, device),
                               val_labels, cfg.metric)
    if device_mining:
        mine_gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
        fused = make_mm_fused_step(model, optimizer, cfg, mine_gen,
                                   hard_only=hard_only, mesh=mesh,
                                   gather_smalls=cfg.multihost)
        keys, casts = (("events", "events2", "events3", "labels", "mask"),
                       feature_keys(cfg))
    else:
        # config-seeded host-miner streams: the JAX trainer's draws
        host_step = make_host_step(
            model, optimizer, cfg, device, dist_dict,
            random.Random(cfg.seed), np.random.RandomState(cfg.seed),
            hard_only=hard_only)
        keys, casts = ("events", "events2", "events3"), {}

    # --device_cache: the three modalities stay on the device (on a mesh,
    # each rank its shard); a step is one plan upload and one fused gather
    # + mine + train, the margin table and the multimodal switch its epoch
    # constants (None: stream).  A cached batch's labels and mask are the
    # whole batch's on every rank.
    cache = exp.build_cache(device, mesh=mesh) if device_mining else None
    consts = {}
    cached = None
    if cache is not None:
        cached_fused = (fused if not cfg.multihost else make_mm_fused_step(
            model, optimizer, cfg, mine_gen, hard_only=hard_only,
            mesh=mesh))
        cached = (cache, make_cached_body_step(
            lambda ev, lab, m, lr: cached_fused(*ev, lab, m, consts["cm"],
                                                consts["mm"], lr),
            cache, torch.Generator(device=device).manual_seed(cfg.seed + 3)))

    def run(batch, lr):
        if device_mining:
            return fused(batch["events"], batch["events2"], batch["events3"],
                         batch["labels"], batch["mask"], consts["cm"],
                         consts["mm"], lr)
        # None: the facenet miner found no triplet
        return host_step(batch, lr, consts["mm"] > 0)

    def echo(e, s, sc):
        return _echo(cfg, e, s, sc["loss"], sc["triplet_count"],
                     sc["hard_count"], sc["struct_count"],
                     fused=device_mining)

    metrics = {}
    exp.open_feed(device, rank_batches(exp, mesh, cfg.multihost), keys,
                  cached=cached, **casts)
    try:
        epoch = epoch_of_step(step_host, exp.batch_per_epoch)
        while epoch < cfg.max_epochs:
            lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                        cfg.static_epochs, cfg.max_epochs,
                                        decay_base=0.01)
            step_at_epoch_start = step_host
            # epoch constants: dist_dict changes only at validation
            consts.update(mm=float(epoch >= cfg.multimodal_epochs),
                          cm=(margin_table(dist_dict, device)
                              if device_mining else None))
            step_host = exp.run_epoch(run, lr, step_host, epoch, echo)
            if exp.preempted(step_host, model, optimizer):
                break
            if step_host == step_at_epoch_start:
                print(f"[{cfg.name}] epoch {epoch + 1}: no trainable batch; "
                      "stopping")
                break
            metrics, val_emb = validate(embed_fn, val_x, val_labels, device,
                                        beat=exp.control.beat_fn)
            exp.log(step_host, metrics,
                    f"[{cfg.name}] epoch {epoch + 1} val mAP "
                    f"{metrics['val_mAP']:.4f}")
            if (epoch + 1) == 50 or (epoch + 1) % 200 == 0:
                for label, values in dist_dict.items():
                    values.append(_class_mean_distance(
                        val_emb, val_labels, label, cfg.metric))
                if exp.is_chief:
                    with open(os.path.join(exp.result_dir, "dist_dict.pkl"),
                              "wb") as f:
                        pickle.dump(dist_dict, f)
            exp.save(model, optimizer, step_host)
            epoch = epoch_of_step(step_host, exp.batch_per_epoch)
    finally:
        exp.close()
    return TrainResult(model, optimizer, step_host, metrics, exp.result_dir)


def main(argv=None):
    """The trainer CLI: the JAX trainer's flags, plus ``--device`` (default
    ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    cfg = TrainConfig.parse(rest)
    train(cfg, device_mining=cfg.device_mining, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
