"""The end-to-end CUB trainer (``base_CUB --network inception_v2``) against
the benchmark's plain reference, ``perfbench/reference/cub_inception_v2.py``,
on the CPU at a small size: seeded weights, 112 images of 72 x 72 over 4
classes, 64-pixel crops.  The training-mode forward and its batch
statistics, three steps of ``CUBTrainer.step`` (losses, the first
gradient, the parameters and the running statistics), the reference's
imports, and ``train()`` through ``CUBTrainer`` against the loop it
replaced."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multimodal_similarity_tpu_torch.configs import TrainConfig  # noqa: E402
from multimodal_similarity_tpu_torch.data.cub import (  # noqa: E402
    sample_cub_batch)
from multimodal_similarity_tpu_torch.train.state import (  # noqa: E402
    build_optimizer, learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.trainers import (  # noqa: E402
    base_CUB)
from multimodal_similarity_tpu_torch.train.trainers._cub import (  # noqa: E402
    class_index)
from multimodal_similarity_tpu_torch.utils.logging import (  # noqa: E402
    MetricsLogger)
from perfbench.reference import cub_inception_v2 as ref  # noqa: E402

SIZE, CROP, CLASSES, PER_CLASS, EMB = 72, 64, 4, 28, 64


def _cfg(**kw):
    d = dict(name="ref", silent_mode=True, network="inception_v2",
             loss="triplet", emb_dim=EMB, batch_size=32, learning_rate=1e-3,
             optimizer="ADAM", keep_prob=1.0, alpha=0.2, seed=77)
    d.update(kw)
    return TrainConfig(**d).resolve()


@pytest.fixture(scope="module")
def split():
    return ref.make_images(5, CLASSES, PER_CLASS, SIZE, "cpu")


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(9, EMB, "cpu")


def _model(cfg, weights):
    model = base_CUB.build_model(cfg, "cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _rel(got, want, scale=None):
    scale = want.norm() if scale is None else scale
    return float((got - want).double().norm() / max(float(scale), 1e-30))


def test_weights_fill_the_trainers_model(weights):
    """The reference's weights name every parameter and running statistic
    of the trainer's ``CUBNet`` and nothing else; the tower holds
    10,153,336 parameters."""
    model = base_CUB.build_model(_cfg(), "cpu")
    assert set(model.state_dict()) == set(weights)
    for k, v in model.state_dict().items():
        assert v.shape == weights[k].shape, k
    assert sum(p.numel() for p in model.InceptionV2.parameters()) \
        == 10153336
    assert set(ref.trained(weights)) == {k for k, _ in
                                         model.named_parameters()}


def test_training_forward_and_batch_statistics(split, weights):
    """A training-mode forward of 8 random crops: the pooled features
    and each batch norm's running mean and variance after it agree with
    the reference's.  The reference runs the same float32 operations in
    the same order (its docstring says why), so they agree exactly here;
    rtol 1e-6 leaves room for another build's CPU kernels."""
    images, _ = split
    model = _model(_cfg(), weights)
    model.train()
    x = base_CUB.random_crop(torch.from_numpy(images[:8]), CROP,
                             torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model.InceptionV2(x)
        tower = ref.Tower(weights)
        want = tower(ref.random_crop(torch.from_numpy(images[:8]), CROP,
                                     torch.Generator().manual_seed(3)))
    assert got.shape == (8, ref.FEATURES)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert len(tower.stats) == sum(1 for c in ref.conv_shapes() if c[6])
    state = model.state_dict()
    for key, mean, var in tower.stats:
        for leaf, batch in (("running_mean", mean), ("running_var", var)):
            start = weights[f"{key}.{leaf}"]
            moved = start * ref.DECAY + (1.0 - ref.DECAY) * batch
            torch.testing.assert_close(state[f"{key}.{leaf}"], moved,
                                       rtol=1e-6, atol=1e-7)
    # the batch statistics are the batch's: the variance is biased
    h = torch.randn(4, 3, 5, 5)
    t = ref.Tower({"k.bias": torch.zeros(3)})
    t.batch_norm("k", h)
    _, mean, var = t.stats[0]
    torch.testing.assert_close(mean, h.mean(dim=(0, 2, 3)))
    torch.testing.assert_close(var, h.var(dim=(0, 2, 3), unbiased=False),
                               rtol=1e-5, atol=1e-6)


def _state(model, opt):
    named = list(model.named_parameters())
    return {"params": {k: p.detach().clone() for k, p in named},
            "stats": {k: b.clone() for k, b in model.named_buffers()},
            "m": {k: opt.state[p]["exp_avg"].clone() for k, p in named},
            "v": {k: opt.state[p]["exp_avg_sq"].clone() for k, p in named}}


def test_three_steps_match_the_reference(split, weights, tmp_path):
    """Three ``CUBTrainer.step`` calls against ``run_steps`` from the same
    weights, the same draws and crops, the reference running free and
    started at each step from the trainer's state before it.  Losses at
    rtol 1e-6 and the running statistics at 1e-6 of their change: the
    tower's forward is the same arithmetic, and the two semi-hard
    formulations (the port's, contrib's masked minimum) round the chosen
    distance apart by an ulp at most.  The first gradient at 1e-6 of the
    larger of the leaf's norm and the median leaf's (4e-8 seen: the two
    losses' backward passes round apart); the parameters at 1e-5 of their
    change (Adam's update written out against ``torch.optim.Adam``'s)."""
    images, labels = split
    cfg = _cfg()
    model = _model(cfg, weights)
    opt = build_optimizer("ADAM", model, cfg.learning_rate)
    trainer = base_CUB.CUBTrainer(cfg, model, opt, images, labels, CROP,
                                  "cpu", MetricsLogger(str(tmp_path)))
    losses, states = [], []
    for _ in range(3):
        losses.append(float(trainer.step(cfg.learning_rate)["loss"]))
        states.append(_state(model, opt))
    grads = {k: m / (1 - ref.ADAM_BETAS[0])
             for k, m in states[0]["m"].items()}
    assert trainer.steps == 3
    c = dict(batch_size=32, crop=CROP, learning_rate=1e-3, alpha=0.2)
    free = ref.run_steps(images, labels, c, cfg.seed, weights, 3, "cpu")
    forced = ref.run_steps(images, labels, c, cfg.seed, weights, 3, "cpu",
                           forced=states)
    # the reference states float32: it turns TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    for want in (free, forced):
        np.testing.assert_allclose(losses, want["losses"].numpy(),
                                   rtol=1e-6)
    assert min(losses) > 0
    norms = {k: float(g.norm()) for k, g in free["grads"].items()}
    med = float(np.median(list(norms.values())))
    for k, g in free["grads"].items():
        assert _rel(grads[k], g, max(norms[k], med)) <= 1e-6, k
    for step, got in enumerate(states):
        for want in (free["states"][step], forced["states"][step]):
            before = states[step - 1] if step else {"params": weights,
                                                    "stats": weights}
            changes = {k: float((p - before["params"][k]).norm())
                       for k, p in want["params"].items()}
            med = float(np.median(list(changes.values())))
            assert med > 0
            for k, p in want["params"].items():
                assert _rel(got["params"][k], p,
                            max(changes[k], med)) <= 1e-5, k
            for k, s in want["stats"].items():
                moved = (s - before["stats"][k]).norm()
                assert float(moved) > 0, k
                assert _rel(got["stats"][k], s, moved) <= 1e-6, k
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2, 3]
    assert [r["loss"] for r in logged] == pytest.approx(losses, rel=1e-7)


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys\n"
            "import perfbench.reference.cub_inception_v2\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multimodal_similarity_tpu', "
            "'multimodal_similarity_tpu_torch')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


def _old_loop(cfg, data, crop, steps):
    """``train()``'s loop body as it stood before ``CUBTrainer``: the
    losses of ``steps`` steps."""
    images = np.asarray(data["image_train"], np.float32)
    labels = np.asarray(data["label_train"]).reshape(-1)
    class_idx = class_index(labels)
    model = base_CUB.build_model(cfg, "cpu")
    optimizer = build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    step_fn = base_CUB.make_cub_step(
        model, optimizer, cfg, crop,
        torch.Generator().manual_seed(cfg.seed + 2))
    rng_np = np.random.RandomState(cfg.seed)
    out = []
    for epoch in range(steps):
        lr = learning_rate_schedule(epoch, cfg.learning_rate,
                                    cfg.static_epochs, steps)
        idx = sample_cub_batch(class_idx, max(cfg.batch_size, 32), rng_np)
        aux = step_fn(torch.from_numpy(images[idx]),
                      torch.from_numpy(labels[idx]), lr)
        out.append(float(aux["loss"]))
    return out


def test_train_gives_the_loss_trace_of_the_loop_it_replaced(tmp_path):
    """``train()`` through ``CUBTrainer`` on the ``ConvBackbone`` path: the
    loss trace of the inline loop it replaced, bit for bit, with a
    validation between steps."""
    rng = np.random.RandomState(4)
    lab = np.repeat(np.arange(6), 8)
    img = np.clip(rng.rand(6, 1, 1, 3)[lab]
                  + 0.3 * rng.rand(len(lab), 20, 20, 3), 0, 1)
    data = {"image_train": img.astype(np.float32), "label_train": lab,
            "image_test": img[:12].astype(np.float32),
            "label_test": lab[:12] + 1}
    cfg = _cfg(network="conv", emb_dim=16, max_epochs=4,
               learning_rate=1e-2, static_epochs=2)
    res = base_CUB.train(cfg, data=data, crop=16,
                         result_dir=str(tmp_path / "run"), device="cpu")
    with open(os.path.join(res.result_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    got = [r["loss"] for r in recs if "loss" in r]
    assert res.step == 4 and any("val_mAP" in r for r in recs)
    assert got == _old_loop(cfg, data, 16, 4)
