"""The port's semi-hard triplet trainer (``train/trainers/base_model.py``)
against the JAX trainer: one epoch on the same synthetic directory from the
same initial params with dropout off, per miner, and its CLI.  The JAX run
spreads the budget over the suite's virtual CPU devices (the data-parallel
fused step); both run in f32.  Tolerances at each assertion."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trainer import _cfg, _one_epoch_pair, _records

from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.train.trainers import base_model as jax_trainer
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.train.trainers import base_model

TRIPLETS = dict(triplet_per_batch=12, num_negative=3, alpha=0.2)


def jax_gumbel_draws(seed: int):
    """A stand-in for the port's Gumbel draw that replays the JAX trainer's
    key sequence: PRNGKey(seed), one split a step, then (k_mine, k_drop)
    and split(k_mine, 3) into the anchor, positive and negative keys."""
    state = {"rng": jax.random.PRNGKey(seed)}

    def draw(num_pairs, n, num_negative, generator, device):
        state["rng"], key = jax.random.split(state["rng"])
        k_mine, _ = jax.random.split(key)
        k_a, k_p, k_n = jax.random.split(k_mine, 3)

        def gumbel(k):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (num_pairs, n), jnp.float32))).to(device)

        return gumbel(k_a), gumbel(k_p), [
            gumbel(k) for k in jax.random.split(k_n, num_negative)]

    return draw


def rounded_dequant(x):
    """The JAX dequantization with the bf16 rounding it states kept: XLA's
    compiled step may keep q * scale in f32 (allow_excess_precision)."""
    if isinstance(x, dict) and "q" in x:
        return jax.lax.reduce_precision(
            x["q"].astype(jnp.float32)
            * x["scale"].astype(jnp.bfloat16).astype(jnp.float32),
            exponent_bits=8, mantissa_bits=7).astype(jnp.bfloat16)
    return x


@pytest.mark.parametrize("select,flag,pin", [
    pytest.param(select, flag, pin, id="-".join(
        [select, str(flag)] + ([] if pin else ["unpinned"])))
    for select, flag, pin in [
        ("random", None, True), ("facenet_host", None, True),
        ("facenet", None, True), ("random", "bf16_features", True),
        ("facenet_host", "bf16_features", True),
        ("facenet", "bf16_features", True),
        ("facenet", "int8_features", True),
        ("facenet", "int8_features", False)]])
def test_one_epoch_matches_jax_trainer(tmp_path, monkeypatch, select, flag,
                                       pin):
    """The loss trace within rtol 1e-4 and val mAP within atol 1e-3 of the
    JAX trainer's, in f32 and with each feature flag: the host miners draw
    from the same ``random.Random`` seed; the fused miner draws the JAX
    trainer's Gumbel values.  ``pin`` holds the JAX dequantization to the
    bf16 rounding it states (ROADMAP D1); the unpinned int8 case holds the
    JAX trainer as it is, its product left in f32 by XLA (5.5e-6 relative
    observed at this size), so a drift of the real JAX path still shows."""
    from multimodal_similarity_tpu.train import steps as jax_steps
    if select == "facenet":
        monkeypatch.setattr(mining, "_draw_gumbels", jax_gumbel_draws(
            TrainConfig().seed))
    if pin:
        monkeypatch.setattr(jax_steps, "dequant_features", rounded_dequant)
    (got_loss, got_map), (want_loss, want_map), steps = _one_epoch_pair(
        tmp_path, base_model.train, jax_trainer.train,
        triplet_select=select, **TRIPLETS, **({flag: True} if flag else {}))
    assert steps == len(want_loss) >= 3
    assert all(np.isfinite(got_loss)) and any(got_loss)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


def test_cli_runs_on_cpu(tmp_path):
    """``python -m ...base_model --device cpu`` trains an epoch with the
    fused miner and writes finite losses, a val mAP, the projector files
    and a checkpoint."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    args = ["--device", "cpu", "--DATA_ROOT", root, "--name", "cli",
            "--network", "convrtsn", "--triplet_select", "facenet",
            "--feat", "resnet", "--num_seg", "3", "--emb_dim", "16",
            "--n_input", "8", "--n_h", "2", "--n_w", "2", "--n_C", "4",
            "--event_per_batch", "48", "--triplet_per_batch", "12",
            "--sess_per_batch", "1", "--max_epochs", "1", "--silent_mode"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-m",
                    "multimodal_similarity_tpu_torch.train.trainers."
                    "base_model", *args],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    losses, maps = _records(str(run_dir))
    assert losses and all(np.isfinite(losses))
    assert len(maps) == 1 and np.isfinite(maps[0])
    names = os.listdir(run_dir)
    assert {"embedding_val.tsv", "projector_config.pbtxt",
            "metadata_val.tsv"} <= set(names)
    assert any(n.startswith("cli.ckpt-") for n in names)


def test_bad_options_and_missing_gpu_raise(tmp_path, monkeypatch):
    """An unknown miner, int8 with a host miner and --device_cache with a
    host miner raise before any data is read, and the default device
    raises when no card is visible."""
    cfg = _cfg(TrainConfig, DATA_ROOT=str(tmp_path))
    with pytest.raises(NotImplementedError, match="triplet_select"):
        base_model.train(_cfg(TrainConfig, DATA_ROOT=str(tmp_path),
                              triplet_select="hard"), device="cpu")
    with pytest.raises(ValueError, match="int8_features requires"):
        base_model.train(_cfg(TrainConfig, DATA_ROOT=str(tmp_path),
                              int8_features=True), device="cpu")
    with pytest.raises(ValueError,
                       match="device_cache requires --triplet_select facenet"):
        base_model.train(_cfg(TrainConfig, DATA_ROOT=str(tmp_path),
                              triplet_select="random", device_cache=True),
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        base_model.train(cfg)
