"""Plain reference of the flagship's cached training step
(``multimodal_model --device_mining --device_cache``): from the raw
feature files and the seeds, the first steps' losses, the first step's
gradients and the parameters after the steps.

One step, as the configuration defines it:

1. the batch plan: the session loader's draws from
   ``RandomState(seed)`` (shuffle the sessions, group ``sess_per_batch``,
   permute the group's events, keep the first ``event_per_batch``);
2. each modality's windows quantized to int8 with max-abs scales per
   (event, frame[, channel]); one TSN frame a segment drawn by uniforms
   from the gather generator, modality by modality; dequantized as
   ``bf16(q) * bf16(scale)``;
3. the eval-mode core embedding (ConvRTSN: a relu 1x1 channel embedding,
   a TF LSTM cell with forget bias 1 over the segments, the last output,
   l2-normalised); semi-hard triplets drawn by Gumbel-max from the mining
   generator (class-balanced anchors, a uniform positive, ``num_negative``
   uniform semi-hard negatives an anchor-positive pair);
4. the sensors and segment RTSN branches, the PDDM similarity of the
   sampled anchors' rows (0.5 of each branch's), hard positives and
   negatives and structure far negatives drawn from the same generator,
   with the class margins;
5. the train-mode re-forward (dropout at 1 - keep_prob from the dropout
   generator) of the mined rows, the three masked triplet losses
   ``loss1 + (loss2 + 0.3 loss3) * lambda_multimodal``, the gradients of
   the core, one Adam step (eps 0.1).

The weights are made here from a seed (``make_weights``) and handed to
the program as its initial state.  ``control`` rounds every product's
operands to TF32 in the forward passes."""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import tf32

# the loader's event filters and length cap (the Honda track's)
MIN_LENGTH, MIN_LENGTH_BACKGROUND, MAX_LENGTH = 5, 15, 45
# raw 11-class annotation -> the 7 goal classes
LABEL_TRANSFER = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 1, 7: 6, 8: 4,
                  9: 5, 10: 0}
N_CLASSES = max(LABEL_TRANSFER.values()) + 1
SUFFIX = {"resnet": ".npy", "sensors": "_sensors_normalized.npy",
          "segment": "_seg_sp.npy"}
# the flagship's mining thresholds
THRESHOLD_UP, THRESHOLD_DOWN = 0.8, 0.2
BRANCHES = ("sensors", "segment")
# the branches' PDDM output layers, scaled so the pseudo-similarities
# spread over [0, 1] as trained branches' do
PDDM_SCALE, PDDM_SHIFT = 100.0, -3.0
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 0.1
_NEG_INF, _POS_INF = -1e30, 1e30


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter of the flagship in order: the core ConvRTSN, then
    each branch's RTSN encoder (emb_dim ``branch_emb_dim``) and PDDM."""
    e, b = cfg["emb_dim"], cfg["branch_emb_dim"]
    hw_c = cfg["n_h"] * cfg["n_w"] * cfg["n_C"]
    out = [("modality_core.embed.conv1x1.weight", (cfg["n_C"],
                                                   cfg["n_input"])),
           ("modality_core.embed.conv1x1.bias", (cfg["n_C"],)),
           ("modality_core.lstm.cell.kernel.weight", (4 * e, hw_c + e)),
           ("modality_core.lstm.cell.kernel.bias", (4 * e,))]
    for br in BRANCHES:
        p = f"modality_{br}."
        out += [(p + "encoder.fc1.weight", (b, cfg[f"{br}_dim"])),
                (p + "encoder.fc1.bias", (b,)),
                (p + "encoder.lstm.cell.kernel.weight", (4 * b, 2 * b)),
                (p + "encoder.lstm.cell.kernel.bias", (4 * b,))]
        for layer, (o, i) in (("u", (b, b)), ("v", (b, b)),
                              ("c", (b, 2 * b)), ("s", (2, b))):
            out += [(p + f"pddm.score.{layer}.weight", (o, i)),
                    (p + f"pddm.score.{layer}.bias", (o,))]
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights normal of variance 1 / fan-in from one draw, biases zero;
    each PDDM output layer's weights times PDDM_SCALE and its
    similar-class bias PDDM_SHIFT."""
    shapes = param_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    n = sum(math.prod(s) for _, s in shapes if len(s) == 2)
    flat = torch.randn(n, generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        if len(shape) == 2:
            size = shape[0] * shape[1]
            w = flat[off:off + size].reshape(shape) * shape[1] ** -0.5
            off += size
            if name.endswith("pddm.score.s.weight"):
                w = w * PDDM_SCALE
            out[name] = w.contiguous()
        else:
            bias = torch.zeros(shape, device=device)
            if name.endswith("pddm.score.s.bias"):
                bias[1] = PDDM_SHIFT
            out[name] = bias
    return out


def class_margins(seed: int, lo: float, hi: float, device) -> torch.Tensor:
    """The structure term's per-class margins (an epoch constant the
    trainer takes from validation distances), from the seed."""
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.uniform(lo, hi, N_CLASSES), dtype=torch.float32,
                        device=device)


# ---------------------------------------------------------------------------
# data: layout, plans, the TSN gather of int8 frames
# ---------------------------------------------------------------------------

def _sessions(root: str, name: str) -> List[str]:
    with open(os.path.join(root, name)) as f:
        return f.read().split()


class Data:
    """The train sessions' events (their label pickles), the batch plans
    and the gathered int8 batches."""

    def __init__(self, root: str, cfg: dict, seed: int, device):
        self.root, self.cfg, self.device = root, cfg, device
        self.sessions = _sessions(root, "train_session.txt")[
            :cfg["label_num"]]
        self.starts, self.lens, self.labels, self.owner = [], [], [], []
        self.session_ids = []
        base = 0
        for k, sess in enumerate(self.sessions):
            with open(os.path.join(root, "labels", f"{sess}_goal.pkl"),
                      "rb") as f:
                lab = pickle.load(f)
            ids = []
            for i in range(len(lab["G"])):
                length = lab["s"][i + 1] - lab["s"][i]
                if length <= MIN_LENGTH or (lab["G"][i] == 0 and length
                                            < MIN_LENGTH_BACKGROUND):
                    continue
                self.starts.append(int(lab["s"][i]))
                self.lens.append(int(min(length, MAX_LENGTH)))
                self.labels.append(LABEL_TRANSFER[int(lab["G"][i])])
                self.owner.append(k)
                ids.append(base)
                base += 1
            self.session_ids.append(np.asarray(ids, np.int32))
        self.label_table = np.asarray(self.labels, np.int32)
        self.rng = np.random.RandomState(seed)
        self.sess_per_batch = min(cfg["sess_per_batch"],
                                  len(self.sessions))
        self._feats = {}

    def epoch_plans(self) -> List[np.ndarray]:
        """One epoch of (event ids, mask), budget long."""
        per = self.cfg["event_per_batch"]
        spb = self.sess_per_batch
        bpe = len(self.sessions) // spb
        order = self.rng.permutation(len(self.sessions))
        plans = []
        for b in range(bpe):
            idx = np.concatenate([self.session_ids[i]
                                  for i in order[b * spb:(b + 1) * spb]])
            n = idx.shape[0]
            take = (self.rng.permutation(n)[:per] if n > per
                    else self.rng.permutation(n))
            idx = idx[take]
            mask = np.ones(idx.shape[0], np.float32)
            pad = per - idx.shape[0]
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, np.int32)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            plans.append((idx, mask))
        return plans

    def _file(self, k: int, modality: str):
        key = (k, modality)
        if key not in self._feats:
            self._feats[key] = np.load(os.path.join(
                self.root, "features", self.sessions[k] + SUFFIX[modality]),
                mmap_mode="r")
        return self._feats[key]

    def frames(self, ids: np.ndarray, frame: np.ndarray,
               modality: str) -> torch.Tensor:
        """[n, n_seg, ...] f32 frames ``frame`` [n, n_seg] (counted from
        each event's start) of events ``ids``, on the device."""
        owner = np.asarray(self.owner)[ids]
        start = np.asarray(self.starts)[ids]
        out = np.empty(frame.shape + self._file(0, modality).shape[1:],
                       np.float32)
        for k in np.unique(owner):
            rows = np.flatnonzero(owner == k)
            out[rows] = self._file(k, modality)[start[rows, None]
                                                + frame[rows]]
        return torch.from_numpy(out).to(self.device)

    def gather(self, ids: np.ndarray, mask: np.ndarray,
               gen: torch.Generator):
        """Each modality's batch as int8 (q, scale) at its drawn TSN
        frames, and the labels and mask, on the device.  A scale spans
        one frame (and channel), so only the drawn frames are quantized."""
        dev = self.device
        n_seg = self.cfg["num_seg"]
        lens = torch.as_tensor(np.asarray(self.lens, np.int64)[ids],
                               device=dev)
        out = []
        for m in ("resnet",) + BRANCHES:
            u = torch.rand((len(ids), n_seg), generator=gen, device=dev)
            avg = torch.clamp(lens // n_seg, min=1)
            base = torch.arange(n_seg, device=dev)[None, :] * avg[:, None]
            offs = (u * avg[:, None].to(torch.float32)).to(torch.int32)
            frame = torch.minimum(base + offs, (lens - 1)[:, None])
            out.append(quantize(self.frames(ids, frame.cpu().numpy(), m)))
        valid = torch.as_tensor(mask, device=dev)
        labels = (torch.as_tensor(self.label_table[ids], device=dev)
                  * valid.to(torch.int32))
        return out, labels, valid


def quantize(x: torch.Tensor):
    """Symmetric int8 with max-abs scales per (event, frame) of flat
    features [N, S, D], per (event, frame, channel) of maps [N, S, h, w,
    C]: scale = max|x| / 127 and q = round-half-even(x / scale) clamped to
    +-127, both IEEE f32 divisions."""
    axes = (2, 3) if x.ndim == 5 else (2,)
    amax = x.abs().amax(dim=axes, keepdim=True).clamp(min=1e-12)
    # IEEE division by a tensor: a CUDA division by a Python number
    # multiplies by its reciprocal, which rounds differently
    scale = amax / amax.new_tensor(127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.bfloat16) * scale.to(torch.bfloat16)).float()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model:
    """The flagship's forward passes over a dict of weights."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 control: bool = False):
        self.w, self.cfg, self.control = w, cfg, control

    def linear(self, x, name):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.control:
            # TF32 operands in the forward; gradients pass straight through
            x = x + (tf32(x) - x).detach()
            w = w + (tf32(w) - w).detach()
        return F.linear(x, w, b)

    def lstm(self, x, name, hidden):
        c = h = x.new_zeros((x.shape[0], hidden))
        for t in range(x.shape[1]):
            gates = self.linear(torch.cat([x[:, t], h], -1), name)
            i, j, f, o = gates.chunk(4, -1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h

    def core(self, x, dropout_gen=None):
        """ConvRTSN [B, S, h, w, C] -> [B, emb]; train-mode dropout when
        ``dropout_gen`` is given."""
        h = torch.relu(self.linear(x, "modality_core.embed.conv1x1"))
        h = h.flatten(-3)
        if dropout_gen is not None:
            rate = 1.0 - self.cfg["keep_prob"]
            keep = torch.rand(h.shape, generator=dropout_gen,
                              device=h.device) >= rate
            h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
        return self.lstm(h, "modality_core.lstm.cell.kernel",
                         self.cfg["emb_dim"])

    def branch(self, br, x):
        b, s = x.shape[0], x.shape[1]
        p = f"modality_{br}.encoder."
        h = torch.relu(self.linear(x.reshape(b * s, -1), p + "fc1"))
        return self.lstm(h.reshape(b, s, -1), p + "lstm.cell.kernel",
                         self.cfg["branch_emb_dim"])

    def pddm_rows(self, br, emb, rows):
        """Similar-class probabilities of ``rows`` against every row."""
        p = f"modality_{br}.pddm.score."
        n, h = emb.shape[0], rows.shape[0]
        a = emb[rows].repeat_interleave(n, dim=0)
        b = emb.repeat(h, 1)
        uu = l2_normalize(torch.relu(self.linear((a - b).abs(), p + "u")))
        vv = l2_normalize(torch.relu(self.linear(0.5 * (a + b), p + "v")))
        c = torch.relu(self.linear(torch.cat([uu, vv], -1), p + "c"))
        return torch.softmax(self.linear(c, p + "s"), -1)[:, 1].reshape(h, n)

    def sqdist(self, a, b):
        prod = (tf32(a) @ tf32(b).T) if self.control else a @ b.T
        return torch.clamp((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                           - 2.0 * prod, min=0.0)


def l2_normalize(x, eps=1e-10):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                       min=eps))


# ---------------------------------------------------------------------------
# mining
# ---------------------------------------------------------------------------

def _gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def _categorical(g, allowed, logits=None):
    """argmax(g + logits), logits -1e30 where not allowed; the first
    maximum on ties."""
    base = torch.zeros_like(g) if logits is None else logits
    return torch.argmax(g + torch.where(allowed, base,
                                        torch.full_like(base, _NEG_INF)), 1)


def semihard(model, emb, labels, valid, gen, cfg):
    """(anchor, positive, negative, mask) of the semi-hard triplets."""
    n, dev = labels.shape[0], labels.device
    t, r = cfg["triplet_per_batch"], cfg["num_negative"]
    pairs = -(-t // r)
    draws = [_gumbel((pairs, n), gen, dev) for _ in range(2 + r)]
    vb = valid.to(torch.bool)
    same_all = labels[:, None] == labels[None, :]
    count = (same_all & vb[None, :]).sum(1).to(torch.float32)
    can_anchor = (labels > 0) & vb & (count >= 2)
    anchors = _categorical(draws[0], can_anchor.expand(pairs, n),
                           (-torch.log(count)).expand(pairs, n))
    same = labels[anchors][:, None] == labels[None, :]
    notself = anchors[:, None] != torch.arange(n, device=dev)
    positives = _categorical(draws[1], same & notself & vb)
    d = model.sqdist(emb[anchors], emb)
    pos = d.gather(1, positives[:, None])
    ok = ~same & vb & (d - pos < cfg["alpha"]) & (pos < d)
    negatives = torch.stack([_categorical(g, ok) for g in draws[2:]], 1)
    mask = ok.any(1).repeat_interleave(r)[:t].float()
    return (anchors.repeat_interleave(r)[:t],
            positives.repeat_interleave(r)[:t], negatives.reshape(-1)[:t],
            mask * can_anchor.any().float())


def hard_structure(sim_rows, labels, valid, margins, gen, cfg):
    """(hard [H, 3], hard mask, struct [S, 3], struct mask, margins)."""
    n, dev = labels.shape[0], labels.device
    hb = cfg["triplet_per_batch"]
    s = min(hb // 2, hb)
    g_a, g_p, g_n, g_f = (_gumbel((rows, n), gen, dev)
                          for rows in (hb, hb, hb, s))
    vb = valid.to(torch.bool)
    fg = (labels > 0) & vb
    anchors = _categorical(g_a, fg.expand(hb, n))
    sim = sim_rows(anchors)
    same = labels[anchors][:, None] == labels[None, :]
    notself = anchors[:, None] != torch.arange(n, device=dev)
    same_a = same & notself & vb
    diff_a = ~same & vb
    hp = same_a & (sim < THRESHOLD_DOWN)
    hard_pos = torch.where(hp.any(1), _categorical(g_p, hp), torch.argmin(
        torch.where(same_a, sim, torch.full_like(sim, _POS_INF)), 1))
    hn = diff_a & (sim > THRESHOLD_UP)
    hard_neg = torch.where(hn.any(1), _categorical(g_n, hn), torch.argmax(
        torch.where(diff_a, sim, torch.full_like(sim, -_POS_INF)), 1))
    hard_mask = (fg[anchors] & same_a.any(1) & diff_a.any(1)).float()
    s_hn = hard_neg[:s]
    fn = ((labels[None, :] == labels[s_hn][:, None])
          & (sim[:s] < THRESHOLD_DOWN) & vb)
    far = _categorical(g_f, fn)
    struct_mask = hard_mask[:s] * fn.any(1).float()
    m_idx = labels[far].long().clamp(max=margins.shape[0] - 1)
    return (torch.stack([anchors, hard_pos, hard_neg], 1), hard_mask,
            torch.stack([anchors[:s], s_hn, far], 1), struct_mask,
            margins[m_idx] * struct_mask)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _triplet(a, p, n, mask, margin):
    basic = torch.clamp(((a - p) ** 2).sum(1) - ((a - n) ** 2).sum(1)
                        + margin, min=0.0)
    return (basic * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def step_loss(model, batch, margins, gens, cfg):
    """The step's total loss (with its graph to the core's weights)."""
    (mods, labels, valid) = batch
    mine_gen, drop_gen = gens
    feats = [dequant(q, s) for q, s in mods]
    with torch.no_grad():
        emb = l2_normalize(model.core(feats[0]))
        lab = semihard(model, emb, labels, valid, mine_gen, cfg)
        embs = [model.branch(br, x) for br, x in zip(BRANCHES, feats[1:])]

        def sim_rows(rows):
            return 0.5 * (model.pddm_rows(BRANCHES[0], embs[0], rows)
                          + model.pddm_rows(BRANCHES[1], embs[1], rows))

        hard, hmask, struct, smask, smarg = hard_structure(
            sim_rows, labels, valid, margins, mine_gen, cfg)
    gather = torch.cat([torch.stack(lab[:3], 1).reshape(-1),
                        hard.reshape(-1), struct.reshape(-1)])
    q, s = mods[0]
    rows = dequant(q[gather], s[gather])
    emb = l2_normalize(model.core(rows, drop_gen))
    t = lab[3].shape[0]
    hb, sb = hmask.shape[0], smask.shape[0]
    zeros = lambda k: torch.zeros(k, device=emb.device)  # noqa: E731
    tri = emb.reshape(-1, 3, emb.shape[1])
    a, p, n = tri[:, 0], tri[:, 1], tri[:, 2]
    m_lab = torch.cat([lab[3], zeros(hb + sb)])
    m_hard = torch.cat([zeros(t), hmask, zeros(sb)])
    m_struct = torch.cat([zeros(t + hb), smask])
    marg = torch.cat([zeros(t + hb), smarg])
    loss1 = _triplet(a, p, n, m_lab, cfg["alpha"])
    loss2 = _triplet(a, p, n, m_hard, cfg["alpha"])
    loss3 = _triplet(a, p, n, m_struct, marg)
    return loss1 + (loss2 + loss3 * 0.3) * cfg["lambda_multimodal"]


CORE = ("modality_core.embed.conv1x1.weight",
        "modality_core.embed.conv1x1.bias",
        "modality_core.lstm.cell.kernel.weight",
        "modality_core.lstm.cell.kernel.bias")


def run_steps(root: str, cfg: dict, seeds: dict, weights: dict,
              margins: torch.Tensor, n_steps: int, device,
              control: bool = False) -> dict:
    """The first ``n_steps`` steps from ``weights``: ``losses`` a step,
    ``grads`` (the core's first-step gradients) and ``params`` (the core
    after the steps), on the device.  ``seeds``: ``plan``, ``gather``,
    ``mine``, ``dropout``."""
    data = Data(root, cfg, seeds["plan"], device)
    w = {k: v.clone() for k, v in weights.items()}
    for k in CORE:
        w[k].requires_grad_(True)
    model = Model(w, cfg, control)
    gens = {k: torch.Generator(device=device).manual_seed(seeds[k])
            for k in ("gather", "mine", "dropout")}
    m1 = {k: torch.zeros_like(w[k]) for k in CORE}
    m2 = {k: torch.zeros_like(w[k]) for k in CORE}
    lr = cfg["learning_rate"]
    (b1, b2), losses, grads = ADAM_BETAS, [], None
    plans = []
    for step in range(1, n_steps + 1):
        if not plans:
            plans = data.epoch_plans()
        ids, mask = plans.pop(0)
        batch = data.gather(ids, mask, gens["gather"])
        loss = step_loss(model, batch, margins,
                         (gens["mine"], gens["dropout"]), cfg)
        g = torch.autograd.grad(loss, [w[k] for k in CORE])
        losses.append(loss.detach())
        if grads is None:
            grads = {k: gk.detach().clone() for k, gk in zip(CORE, g)}
        with torch.no_grad():
            for k, gk in zip(CORE, g):
                m1[k].lerp_(gk, 1 - b1)
                m2[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                denom = (m2[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(
                    ADAM_EPS)
                w[k].addcdiv_(m1[k], denom, value=-lr / (1 - b1 ** step))
    return {"losses": torch.stack(losses),
            "grads": grads,
            "params": {k: w[k].detach() for k in CORE}}
