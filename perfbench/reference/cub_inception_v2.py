"""Plain reference of the end-to-end CUB training step
(``scripts/CUB_tensorflow.sh``: ``base_CUB --network inception_v2 --loss
triplet``, with ``src/base_CUB.py``'s 224 crops of 256 x 256 images), in
functional PyTorch over a dict of weights.

One step, as the configuration defines it:

1. the batch: the reference's class-balanced draw (``base_model_CUB.py``
   251-261) from ``RandomState(seed)``: a class, 5-10 of its images, until
   the batch holds ``max(batch_size, 32)``, cut to that;
2. ``tf.random_crop``: offsets uniform in [0, 256 - 224] on each axis
   (both ends included), drawn from a generator on the device seeded with
   seed + 2, the height's for the batch then the width's; the window
   scaled to [-1, 1] as (x - 0.5) * 2;
3. slim's InceptionV2 (``inception_v2.py`` of tensorflow/models research/
   slim, ``inception_v2_base`` to ``Mixed_5c`` at depth_multiplier 1) in
   training mode: the depthwise-separable 7x7 stem (depthwise multiplier
   min(64 // 3, 8) = 8, stride 2), MaxPool_2a, Conv2d_2b_1x1, Conv2d_2c_3x3,
   MaxPool_3a, Mixed_3b to Mixed_5c (two stride-2 reductions, Mixed_4a and
   Mixed_5a; Mixed_5c's pool branch a max pool), every convolution
   followed by beta-only batch norm (eps 0.001) and relu, TF ``SAME``
   padding everywhere (a stride-2 window on an even size pads its odd
   cell after; max pools pad with -inf; average pools leave padded cells
   out of the mean); then AvgPool_1a, at 224 a 7x7 VALID pool of the 7x7
   map, the mean over it, to 1024 features;
4. ``CUBLayer``: one dense layer to ``emb_dim`` (dropout at keep_prob 1.0
   is the identity), then ``tf.nn.l2_normalize`` (the squared sum floored
   at 1e-10);
5. ``tf.contrib.losses.metric_learning.triplet_semihard_loss`` at margin
   ``alpha``, in contrib's steps (the pairwise distances of the Gram
   expansion with its error mask and zeroed diagonal, the tiled
   comparison, ``masked_minimum`` / ``masked_maximum``), but over
   euclidean distances, as the JAX package and the port take them (see
   the departures below);
6. the gradients by autograd; the tower's scaled by 0.1 (the reference's
   multiplier on the pretrained branch); one Adam step (betas 0.9 / 0.999,
   eps 0.1, as optax and ``torch.optim.Adam`` place it: on the
   bias-corrected root);
7. the running statistics: mean and variance moved by 1 - 0.9997 towards
   the batch's.

Departures from slim, each as the port and the JAX package make it:

* **Batch variance.**  The biased batch variance is taken as E[x^2] -
  E[x]^2 (clamped at 0), in float32, and the normalisation as (x - mean)
  * rsqrt(var + eps) + beta: flax's fast variance, which the port
  computes in this order.  slim's fused batch norm takes the variance by
  cuDNN's two-pass form, and moves the running variance by the unbiased
  (n / (n - 1)) one; at a 7x7 map of a batch of 32, n = 1568.  Computed in
  the program's order, the tower's forward rounds as the program's does,
  so the semi-hard selection, a comparison of distances, makes the same
  choices in both; the comparison then measures the step's arithmetic, not
  the coin flips of near ties.
* **Weights.**  Seeded (``make_weights``) in place of the ImageNet
  checkpoint the published run grafts; the betas, the head's bias and the
  running statistics nonzero, so that a dropped term shows.
* **Adam's epsilon** on the bias-corrected root (optax's form) where TF1's
  ``AdamOptimizer`` adds it to the uncorrected one.
* **Distances of the semi-hard loss.**  TF 1.x contrib's
  ``metric_loss_ops.py`` builds the loss on ``pairwise_distance(embeddings,
  squared=True)``, squared euclidean distances (the source as published;
  no copy of it is in the repository).  The JAX package, the port and this
  reference take ``squared=False``, euclidean distances: the margin of
  0.2 then sits on another scale, and the semi-hard choices can differ.
  This reference shares the program's reading, so it cannot see that
  departure.
* **Class draw.**  With fewer classes than a batch needs, the drawn set is
  cleared and drawn again (the port's ``sample_cub_batch``); the reference
  would draw forever.  A split of 100 classes never reaches it.

``conv_shapes`` lists the tower's convolutions and ``step_flops`` counts a
step's products from them.  ``run_steps`` turns TF32 off (matmul and
cuDNN); ``control`` rounds every product's operands (the convolutions',
the head's and the Gram product's) to TF32, straight through in the
backward."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import tf32

EPS, DECAY = 0.001, 0.9997
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 0.1
TOWER, HEAD = "InceptionV2.", "CUBLayer.fc."
TOWER_SCALE = 0.1
FEATURES = 1024
L2_EPS = 1e-10

# slim's block table at depth_multiplier 1: (scope, Branch_0, Branch_1
# (1x1, 3x3), Branch_2 (1x1, 3x3), Branch_3's 1x1, pool); Branch_2's two
# 3x3 convolutions are of one width; a reduction block strides its last
# 3x3 of Branch_0 and Branch_1 and max-pools
BLOCKS = (
    ("Mixed_3b", 64, (64, 64), (64, 96), 32, "avg"),
    ("Mixed_3c", 64, (64, 96), (64, 96), 64, "avg"),
    ("Mixed_4a", None, (128, 160), (64, 96), None, "reduce"),
    ("Mixed_4b", 224, (64, 96), (96, 128), 128, "avg"),
    ("Mixed_4c", 192, (96, 128), (96, 128), 128, "avg"),
    ("Mixed_4d", 160, (128, 160), (128, 160), 96, "avg"),
    ("Mixed_4e", 96, (128, 192), (160, 192), 96, "avg"),
    ("Mixed_5a", None, (128, 192), (192, 256), None, "reduce"),
    ("Mixed_5b", 352, (192, 320), (160, 224), 128, "avg"),
    ("Mixed_5c", 352, (192, 320), (192, 224), 128, "max"),
)

# (weight key prefix, cin, cout, kernel, stride, groups, batch-norm key)
Conv = Tuple[str, int, int, int, int, int, Optional[str]]


def conv_shapes() -> List[Conv]:
    """Every convolution of the tower, in order; keys are the state-dict
    keys of the trainer's ``CUBNet`` (``InceptionV2.<slim scope>``, the
    scopes flattened with ``_``)."""
    out: List[Conv] = [
        (TOWER + "Conv2d_1a_7x7_depthwise", 3, 24, 7, 2, 3, None),
        (TOWER + "Conv2d_1a_7x7_pointwise", 24, 64, 1, 1, 1,
         TOWER + "Conv2d_1a_7x7_BatchNorm")]

    def conv(name, cin, cout, k, stride=1):
        out.append((TOWER + name, cin, cout, k, stride, 1,
                    TOWER + name + "_BatchNorm"))

    conv("Conv2d_2b_1x1", 64, 64, 1)
    conv("Conv2d_2c_3x3", 64, 192, 3)
    cin = 192
    for name, b0, b1, b2, b3, pool in BLOCKS:
        if pool == "reduce":
            conv(f"{name}_Branch_0_Conv2d_0a_1x1", cin, b1[0], 1)
            conv(f"{name}_Branch_0_Conv2d_1a_3x3", b1[0], b1[1], 3, 2)
            conv(f"{name}_Branch_1_Conv2d_0a_1x1", cin, b2[0], 1)
            conv(f"{name}_Branch_1_Conv2d_0b_3x3", b2[0], b2[1], 3)
            conv(f"{name}_Branch_1_Conv2d_1a_3x3", b2[1], b2[1], 3, 2)
            cin += b1[1] + b2[1]
            continue
        conv(f"{name}_Branch_0_Conv2d_0a_1x1", cin, b0, 1)
        conv(f"{name}_Branch_1_Conv2d_0a_1x1", cin, b1[0], 1)
        conv(f"{name}_Branch_1_Conv2d_0b_3x3", b1[0], b1[1], 3)
        conv(f"{name}_Branch_2_Conv2d_0a_1x1", cin, b2[0], 1)
        conv(f"{name}_Branch_2_Conv2d_0b_3x3", b2[0], b2[1], 3)
        conv(f"{name}_Branch_2_Conv2d_0c_3x3", b2[1], b2[1], 3)
        conv(f"{name}_Branch_3_Conv2d_0b_1x1", cin, b3, 1)
        cin = b0 + b1[1] + b2[1] + b3
    return out


def make_weights(seed: int, emb_dim: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and running statistic of tower and head from
    ``seed``, on the device: kernels normal of variance 1 / fan-in (one
    draw for all), betas and the head's bias normal of standard deviation
    0.01, the head's kernel normal of variance 1 / 1024, running means
    normal of standard deviation 0.1 and running variances uniform in
    [0.5, 2)."""
    convs = conv_shapes()
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [cout * cin // groups * k * k
             for _, cin, cout, k, _, groups, _ in convs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    n_bn = sum(cout for _, _, cout, _, _, _, bn in convs if bn)
    betas = torch.randn(n_bn, generator=g, device=device) * 0.01
    means = torch.randn(n_bn, generator=g, device=device) * 0.1
    variances = 0.5 + 1.5 * torch.rand(n_bn, generator=g, device=device)
    out, off, boff = {}, 0, 0
    for (key, cin, cout, k, _, groups, bn), size in zip(convs, sizes):
        fan_in = cin // groups * k * k
        out[key + ".weight"] = (flat[off:off + size].reshape(
            cout, cin // groups, k, k) * fan_in ** -0.5)
        off += size
        if bn:
            out[bn + ".bias"] = betas[boff:boff + cout]
            out[bn + ".running_mean"] = means[boff:boff + cout]
            out[bn + ".running_var"] = variances[boff:boff + cout]
            boff += cout
    out[HEAD + "weight"] = torch.randn(emb_dim, FEATURES, generator=g,
                                       device=device) * FEATURES ** -0.5
    out[HEAD + "bias"] = torch.randn(emb_dim, generator=g,
                                     device=device) * 0.01
    return {k: v.contiguous() for k, v in out.items()}


def trained(weights: Dict[str, torch.Tensor]) -> List[str]:
    """The keys of the parameters a step trains (not the statistics)."""
    return [k for k in weights if not k.endswith(("running_mean",
                                                  "running_var"))]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_images(seed: int, classes: int, per_class: int, size: int,
                device, chunk: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """The training split as the trainer holds it: host float32 images
    [classes * per_class, size, size, 3] in [0, 1], each 0.6 x its
    class's pattern (an 8 x 8 x 3 uniform grid, bilinearly upsampled) +
    0.4 x uniform noise of its own, drawn on the device from ``seed``;
    and 0-based labels, ``per_class`` rows a class in class order."""
    g = torch.Generator(device=device).manual_seed(seed)
    low = torch.rand(classes, 3, 8, 8, generator=g, device=device)
    patterns = F.interpolate(low, size=(size, size), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)
    labels = np.repeat(np.arange(classes, dtype=np.int64), per_class)
    lab = torch.from_numpy(labels).to(device)
    out = np.empty((len(labels), size, size, 3), np.float32)
    host = torch.from_numpy(out)
    for a in range(0, len(labels), chunk):
        b = min(a + chunk, len(labels))
        noise = torch.rand((b - a, size, size, 3), generator=g,
                           device=device)
        host[a:b].copy_(0.6 * patterns[lab[a:b]] + 0.4 * noise)
    return out, labels


def class_index(labels: np.ndarray) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for i, label in enumerate(labels):
        out.setdefault(int(label), []).append(i)
    return out


def draw_batch(class_idx: Dict[int, list], batch: int,
               rng: np.random.RandomState) -> np.ndarray:
    """The reference's class-balanced draw (``base_model_CUB.py``
    251-261)."""
    keys = list(class_idx)
    chosen, rows = set(), []
    while len(rows) < batch:
        if len(chosen) == len(keys):
            chosen.clear()
        c = keys[rng.randint(len(keys))]
        if c not in chosen:
            chosen.add(c)
            take = rng.randint(5, 11)
            rows.extend(rng.permutation(class_idx[c])[:take])
    return np.asarray(rows[:batch], np.int64)


def random_crop(images: torch.Tensor, crop: int,
                generator: torch.Generator) -> torch.Tensor:
    """``tf.random_crop`` of each image [B, H, W, 3], scaled to [-1, 1]."""
    b, h, w, _ = images.shape
    ox = torch.randint(0, h - crop + 1, (b,), generator=generator,
                       device=images.device).tolist()
    oy = torch.randint(0, w - crop + 1, (b,), generator=generator,
                       device=images.device).tolist()
    out = torch.stack([images[i, x:x + crop, y:y + crop]
                       for i, (x, y) in enumerate(zip(ox, oy))])
    return (out - 0.5) * 2.0


# ---------------------------------------------------------------------------
# the tower and the loss
# ---------------------------------------------------------------------------

def _round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32, the gradient passed straight through."""
    return x + (tf32(x) - x).detach()


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF ``SAME``: ceil(size / stride) outputs, the padding's odd cell
    after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """(x, the symmetric padding left to the operation): an uneven
    ``SAME`` split is padded here."""
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k,
                                                         stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Tower:
    """``Tower(weights, control)(x [B, H, W, 3]) -> [B, 1024]`` in training
    mode; ``stats`` receives each batch norm's (key, batch mean, batch
    variance), ``record`` (a list) each convolution's (cout, cin / groups,
    k, k, h, w)."""

    def __init__(self, weights: Dict[str, torch.Tensor],
                 control: bool = False, record: Optional[list] = None):
        self.w, self.control, self.record = weights, control, record
        self.spec = {c[0]: c for c in conv_shapes()}
        self.stats: List[Tuple[str, torch.Tensor, torch.Tensor]] = []

    def conv(self, key: str, x: torch.Tensor) -> torch.Tensor:
        _, _, _, k, stride, groups, bn = self.spec[key]
        w = self.w[key + ".weight"]
        x, pad = pad_same(x, k, stride)
        if self.control:
            x, w = _round(x), _round(w)
        y = F.conv2d(x, w, None, stride, pad, 1, groups)
        if self.record is not None:
            self.record.append(tuple(w.shape) + tuple(y.shape[2:]))
        return y if bn is None else torch.relu(self.batch_norm(bn, y))

    def batch_norm(self, key: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        self.stats.append((key, mean.detach(), var.detach()))
        mul = torch.rsqrt(var + EPS)
        beta = self.w[key + ".bias"]
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + beta[None, :, None, None])

    def block(self, spec, x: torch.Tensor) -> torch.Tensor:
        name, _, _, _, _, pool = spec

        def c(branch, h):
            return self.conv(f"{TOWER}{name}_{branch}", h)

        if pool == "reduce":
            r0 = c("Branch_0_Conv2d_1a_3x3", c("Branch_0_Conv2d_0a_1x1", x))
            r1 = c("Branch_1_Conv2d_1a_3x3", c("Branch_1_Conv2d_0b_3x3",
                                               c("Branch_1_Conv2d_0a_1x1",
                                                 x)))
            return torch.cat([r0, r1, max_pool_same(x, 2)], 1)
        r0 = c("Branch_0_Conv2d_0a_1x1", x)
        r1 = c("Branch_1_Conv2d_0b_3x3", c("Branch_1_Conv2d_0a_1x1", x))
        r2 = c("Branch_2_Conv2d_0c_3x3", c("Branch_2_Conv2d_0b_3x3",
                                           c("Branch_2_Conv2d_0a_1x1", x)))
        if pool == "avg":
            p = F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        else:
            p = max_pool_same(x, 1)
        return torch.cat([r0, r1, r2, c("Branch_3_Conv2d_0b_1x1", p)], 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous()
        h = self.conv(TOWER + "Conv2d_1a_7x7_pointwise",
                      self.conv(TOWER + "Conv2d_1a_7x7_depthwise", h))
        h = max_pool_same(h, 2)
        h = self.conv(TOWER + "Conv2d_2c_3x3",
                      self.conv(TOWER + "Conv2d_2b_1x1", h))
        h = max_pool_same(h, 2)
        for spec in BLOCKS:
            h = self.block(spec, h)
        return h.mean(dim=(2, 3))


def max_pool_same(x: torch.Tensor, stride: int, k: int = 3):
    x, pad = pad_same(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride, padding=pad)


def head(weights, feats: torch.Tensor, control: bool = False):
    """``CUBLayer`` then ``tf.nn.l2_normalize``."""
    w, b = weights[HEAD + "weight"], weights[HEAD + "bias"]
    if control:
        feats, w = _round(feats), _round(w)
    emb = F.linear(feats, w, b)
    return emb * torch.rsqrt(torch.clamp((emb * emb).sum(1, keepdim=True),
                                         min=L2_EPS))


def pairwise_distance(x: torch.Tensor, control: bool = False):
    """contrib's ``pairwise_distance(x, squared=False)``."""
    sq = (x * x).sum(1)
    gram = (_round(x) @ _round(x).T) if control else x @ x.T
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    error = d2 <= 0.0
    d = torch.sqrt(d2 + error.to(d2.dtype) * 1e-16)
    d = d * (~error).to(d.dtype)
    return d * (1.0 - torch.eye(x.shape[0], dtype=d.dtype, device=d.device))


def masked_maximum(data, mask):
    lo = data.amin(1, keepdim=True)
    return ((data - lo) * mask).amax(1, keepdim=True) + lo


def masked_minimum(data, mask):
    hi = data.amax(1, keepdim=True)
    return ((data - hi) * mask).amin(1, keepdim=True) + hi


def triplet_semihard_loss(labels: torch.Tensor, emb: torch.Tensor,
                          margin: float, control: bool = False):
    """contrib's ``triplet_semihard_loss`` in its steps, over euclidean
    distances where contrib takes squared ones."""
    n = labels.shape[0]
    pdist = pairwise_distance(emb, control)
    labels = labels.reshape(n, 1)
    adjacency = labels == labels.T
    adjacency_not = ~adjacency
    pdist_tile = pdist.repeat(n, 1)
    mask = adjacency_not.repeat(n, 1) & (pdist_tile
                                         > pdist.T.reshape(-1, 1))
    mask_final = (mask.float().sum(1, keepdim=True) > 0.0).reshape(n, n).T
    negatives_outside = masked_minimum(pdist_tile, mask.float()).reshape(
        n, n).T
    negatives_inside = masked_maximum(pdist, adjacency_not.float()).repeat(
        1, n)
    semi_hard = torch.where(mask_final, negatives_outside, negatives_inside)
    loss_mat = margin + pdist - semi_hard
    mask_positives = adjacency.float() - torch.eye(n, device=emb.device)
    return (torch.clamp(loss_mat * mask_positives, min=0.0).sum()
            / mask_positives.sum())


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def run_steps(images: np.ndarray, labels: np.ndarray, cfg: dict, seed: int,
              weights: Dict[str, torch.Tensor], n_steps: int, device,
              control: bool = False,
              forced: Optional[List[dict]] = None) -> dict:
    """The first ``n_steps`` steps from ``weights`` on the host split
    ``images`` / ``labels``: ``losses`` (one a step), ``grads`` (the first
    step's, the tower's scaled by 0.1, as the optimizer sees them) and
    ``states``, each step's ``params``, ``stats`` (the running
    statistics) and Adam's moments ``m`` and ``v`` after it, on the device.
    ``seed`` is the trainer's ``--seed``.  With ``forced`` (a program's
    ``states`` in that form) each step from the second on starts from the
    state the program reached before it, in place of its own; the draws
    and crops follow the seed as before.  Turns TF32 off for the process:
    the configuration states float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {k: v.detach().clone() for k, v in weights.items()}
    keys = trained(w)
    class_idx = class_index(labels)
    rng = np.random.RandomState(seed)
    crop_gen = torch.Generator(device=device).manual_seed(seed + 2)
    batch, lr = max(cfg["batch_size"], 32), cfg["learning_rate"]
    m1 = {k: torch.zeros_like(w[k]) for k in keys}
    m2 = {k: torch.zeros_like(w[k]) for k in keys}
    (b1, b2), losses, grads, states = ADAM_BETAS, [], None, []
    for step in range(1, n_steps + 1):
        if forced is not None and step > 1:
            before = forced[step - 2]
            w = {k: v.clone() for part in ("params", "stats")
                 for k, v in before[part].items()}
            m1 = {k: v.clone() for k, v in before["m"].items()}
            m2 = {k: v.clone() for k, v in before["v"].items()}
        for k in keys:
            w[k].requires_grad_(True)
        rows = draw_batch(class_idx, batch, rng)
        x = torch.from_numpy(images[rows]).to(device)
        y = torch.from_numpy(labels[rows]).to(device)
        tower = Tower(w, control)
        emb = head(w, tower(random_crop(x, cfg["crop"], crop_gen)), control)
        loss = triplet_semihard_loss(y, emb, cfg["alpha"], control)
        g = torch.autograd.grad(loss, [w[k] for k in keys])
        g = [gk * TOWER_SCALE if k.startswith(TOWER) else gk
             for k, gk in zip(keys, g)]
        losses.append(loss.detach())
        if grads is None:
            grads = {k: gk.detach().clone() for k, gk in zip(keys, g)}
        with torch.no_grad():
            w = {k: v.detach() for k, v in w.items()}
            for k, gk in zip(keys, g):
                m1[k].lerp_(gk, 1 - b1)
                m2[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                denom = (m2[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(
                    ADAM_EPS)
                w[k].addcdiv_(m1[k], denom, value=-lr / (1 - b1 ** step))
            for key, mean, var in tower.stats:
                w[key + ".running_mean"] = (w[key + ".running_mean"] * DECAY
                                            + (1.0 - DECAY) * mean)
                w[key + ".running_var"] = (w[key + ".running_var"] * DECAY
                                           + (1.0 - DECAY) * var)
        states.append({"params": {k: w[k].clone() for k in keys},
                       "stats": {k: v.clone() for k, v in w.items()
                                 if k not in keys},
                       "m": {k: v.clone() for k, v in m1.items()},
                       "v": {k: v.clone() for k, v in m2.items()}})
    return {"losses": torch.stack(losses), "grads": grads, "states": states}


def step_flops(batch: int, crop: int, emb_dim: int) -> float:
    """Model FLOPs of one training step at ``batch`` crops of ``crop``:
    each convolution's forward, weight gradient and input gradient (the
    first's input, the image, takes none), the head's three products and
    the loss's Gram product; shapes from a pass of the tower on the meta
    device.  A product of [m, k] by [k, n] counts 2 m k n."""
    weights = {}
    for key, cin, cout, k, _, groups, bn in conv_shapes():
        weights[key + ".weight"] = torch.empty(cout, cin // groups, k, k,
                                               device="meta")
        if bn:
            weights[bn + ".bias"] = torch.empty(cout, device="meta")
    record: list = []
    Tower(weights, record=record)(torch.empty(batch, crop, crop, 3,
                                              device="meta"))
    convs = [2.0 * math.prod(shape) * batch for shape in record]
    head_fwd = 2.0 * batch * FEATURES * emb_dim
    return (3 * sum(convs) - convs[0] + 3 * head_fwd
            + 2.0 * batch * batch * emb_dim)
