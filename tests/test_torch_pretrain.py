"""The port's unsupervised pretrain chain (``Seq2seqTSN`` / ``SAE``,
``unimodal_pretrain_sae``, the k-means of ``unimodal_pretrain_cluster``,
``unimodal_pretrain_pairsim``) and ``base_model_tf`` against the JAX
package on the same synthetic data from the same initial params (mapped by
convert.py and carried in through a step-0 port checkpoint or
``build_head``), dropout off, f32 on the CPU.  scikit-learn's ``KMeans``
is the k-means reference.  Tolerances at each assertion."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans
from test_torch_trainer import _cfg

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.data import prepare_dataset as jax_prepare
from multimodal_similarity_tpu.data import tsn as jax_tsn
from multimodal_similarity_tpu.models import SAE as JaxSAE
from multimodal_similarity_tpu.models import ConvLSTM as JaxConvLSTM
from multimodal_similarity_tpu.models import PairSim as JaxPairSim
from multimodal_similarity_tpu.models import Seq2seqTSN as JaxSeq2seq
from multimodal_similarity_tpu.train.trainers import base_model_tf as jax_tf
from multimodal_similarity_tpu.train.trainers import (
    unimodal_pretrain_cluster as jax_cluster)
from multimodal_similarity_tpu.train.trainers import (
    unimodal_pretrain_pairsim as jax_pairsim)
from multimodal_similarity_tpu.train.trainers import (
    unimodal_pretrain_sae as jax_sae)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.data import (
    generate_event_tfrecords, prepare_dataset, tsn_prepare_input_test)
from multimodal_similarity_tpu_torch.models import SAE, Seq2seqTSN
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.ops.kmeans import KMeans
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model_tf, unimodal_pretrain_cluster, unimodal_pretrain_pairsim,
    unimodal_pretrain_sae)

SENSORS = dict(feat="sensors", network="rtsn", num_seg=3, emb_dim=16,
               n_input=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _column(recs, key):
    return [r[key] for r in recs if key in r]


@pytest.fixture(scope="module")
def sensors_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrain") / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=500,
                             modal_dims={"sensors": (8,)}, seed=0,
                             length_range=(6, 20))
    return root


@pytest.fixture(scope="module")
def cluster_root(tmp_path_factory):
    """A larger sensors directory (about 360 train events) for the k-means
    comparison: 20 clusters need a few hundred rows to have one good
    partition."""
    root = str(tmp_path_factory.mktemp("cluster") / "data")
    generate_synthetic_honda(root, n_sessions=8, frames_per_session=1500,
                             modal_dims={"sensors": (8,)}, seed=3,
                             length_range=(6, 20))
    return root


# ---------------------------------------------------------------------------
# the autoencoders and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
def test_seq2seq_matches_flax(rng, reverse):
    """(hidden, x_recon) within atol 1e-5 of flax from the same params."""
    x = rng.randn(6, 3, 8).astype(np.float32)
    jm = JaxSeq2seq(n_seg=3, n_input=8, emb_dim=16, reverse=reverse)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_flax_params(Seq2seqTSN(3, 8, 16, reverse=reverse),
                          _np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_sae_matches_flax(rng):
    x = rng.randn(6, 24).astype(np.float32)
    jm = JaxSAE(n_input=24, emb_dim=16)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_flax_params(SAE(24, 16), _np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_convert_raw_leaves_and_their_errors():
    """Raw ``self.param`` leaves map by name without a transpose, the two
    LSTMs by the cell rule; a leftover leaf, a missing one and a wrong
    shape raise."""
    params = _np(JaxSeq2seq(n_seg=3, n_input=8, emb_dim=16).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 8)))["params"])
    tm = Seq2seqTSN(3, 8, 16)
    state = flax_to_state_dict(params, tm)
    np.testing.assert_array_equal(state["W_encode"].numpy(),
                                  params["W_encode"])
    np.testing.assert_array_equal(
        state["decoder.cell.kernel.weight"].numpy(),
        params["decoder"]["cell"]["kernel"]["kernel"].T)
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(dict(params, W_extra=params["b_encode"]), tm)
    with pytest.raises(KeyError, match="no JAX leaf.*b_decode2"):
        flax_to_state_dict({k: v for k, v in params.items()
                            if k != "b_decode2"}, tm)
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(dict(params, W_encode=params["W_encode"].T), tm)


# ---------------------------------------------------------------------------
# unimodal_pretrain_sae
# ---------------------------------------------------------------------------

def _sae_init(root, tmp_path, seed):
    """The JAX trainer's initial draw (its first key split) in a step-0
    port checkpoint."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    params = JaxSeq2seq(n_seg=3, n_input=8, emb_dim=16).init(
        key, jnp.zeros((2, 3, 8)))["params"]
    model = load_flax_params(Seq2seqTSN(3, 8, 16), _np(params))
    path = str(tmp_path / "init.pt")
    save_checkpoint(path, model, None, 0)
    return path, params


def test_sae_one_epoch_matches_jax_trainer(sensors_root, tmp_path):
    """One epoch of ``unimodal_pretrain_sae`` (Seq2seqTSN, keep_prob 1):
    the loss and MSE traces and ``val_mse`` within rtol 1e-4 of the JAX
    trainer's; a checkpoint."""
    kw = dict(SENSORS, DATA_ROOT=sensors_root, sess_per_batch=1,
              max_epochs=1, log_flush_every=1)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    pcfg.model_path, _ = _sae_init(sensors_root, tmp_path, jcfg.seed)
    _, jmetrics, jax_dir = jax_sae.train(jcfg, event_budget=32,
                                         result_dir=str(tmp_path / "jax"))
    res = unimodal_pretrain_sae.train(pcfg, event_budget=32,
                                      result_dir=str(tmp_path / "port"),
                                      device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    assert res.step == len(_column(want, "mse")) == 3
    for key in ("loss", "mse"):
        assert all(np.isfinite(_column(got, key)))
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(res.metrics["val_mse"], jmetrics["val_mse"],
                               rtol=1e-4)
    assert os.listdir(res.result_dir).count("t.ckpt-3") == 1


def test_sae_mode_trains_on_flat_rows(sensors_root, tmp_path):
    """``mode="sae"``: the tied autoencoder on the flattened 3 x 8
    segments (the JAX trainer builds it 8 wide and cannot run this mode:
    ROADMAP §3); finite, falling reconstruction error."""
    cfg = _cfg(TrainConfig, **dict(SENSORS, DATA_ROOT=sensors_root,
                                   sess_per_batch=1, max_epochs=2,
                                   log_flush_every=1))
    res = unimodal_pretrain_sae.train(cfg, mode="sae", event_budget=32,
                                      result_dir=str(tmp_path / "sae"),
                                      device="cpu")
    assert isinstance(res.model, SAE) and res.model.W_1.shape == (24, 16)
    mse = _column(_records(res.result_dir), "val_mse")
    assert len(mse) == 2 and np.isfinite(mse).all() and mse[1] < mse[0]
    with pytest.raises(ValueError, match="mode"):
        unimodal_pretrain_sae.train(cfg, mode="pca", device="cpu")


# ---------------------------------------------------------------------------
# k-means and unimodal_pretrain_cluster
# ---------------------------------------------------------------------------

def _same_partition(a, b):
    """Equal up to relabelling: each label of ``a`` maps to one of ``b``."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_kmeans_matches_sklearn_on_blobs(rng):
    """Six well-separated blobs: the same partition as scikit-learn's,
    centres and inertia within 1e-6 of its (relative), predict and
    transform as its."""
    centers = rng.randn(6, 5) * 20
    x = (centers[rng.randint(6, size=300)] + rng.randn(300, 5)
         ).astype(np.float32)
    sk = SkKMeans(6, n_init=5, random_state=0).fit(x)
    km = KMeans(6, n_init=5, seed=0).fit(x)
    assert _same_partition(km.labels_, sk.labels_)
    np.testing.assert_allclose(km.inertia_, sk.inertia_, rtol=1e-6)
    order = [int(np.argmin(((sk.cluster_centers_ - c) ** 2).sum(1)))
             for c in km.cluster_centers_]
    np.testing.assert_allclose(km.cluster_centers_,
                               sk.cluster_centers_[order], rtol=1e-5,
                               atol=1e-5)
    probe = rng.randn(40, 5).astype(np.float32) * 20
    assert _same_partition(km.predict(probe), sk.predict(probe))
    np.testing.assert_allclose(km.transform(probe),
                               sk.transform(probe)[:, order], rtol=1e-5)


def _jax_embeddings(root):
    """JAX Seq2seqTSN params and the train sessions' embeddings through the
    JAX trainer's ``_embed_sessions``."""
    cfg = _cfg(JaxTrainConfig, **dict(SENSORS, DATA_ROOT=root))
    params = JaxSeq2seq(n_seg=3, n_input=8, emb_dim=16).init(
        jax.random.PRNGKey(5), jnp.zeros((2, 3, 8)))["params"]
    ds = jax_prepare(cfg.feature_root, cfg.train_session, "sensors",
                     cfg.label_root)
    prep = lambda f: jax_tsn.tsn_prepare_input_test(3, f)  # noqa: E731
    emb, sessions, eids = jax_cluster._embed_sessions(
        JaxSeq2seq(n_seg=3, n_input=8, emb_dim=16), params, ds, prep)
    return params, emb, sessions, eids


def test_cluster_embeddings_kmeans_and_selection_match(cluster_root):
    """The port's session embeddings within 1e-5 of the JAX
    ``_embed_sessions``; its k-means inertia within 1% of scikit-learn's
    ``KMeans(20, n_init=20)`` on them; given scikit-learn's fitted centres,
    ``high_confidence`` picks the JAX ``_high_confidence``'s rows."""
    params, want, sessions_j, eids_j = _jax_embeddings(cluster_root)
    cfg = _cfg(TrainConfig, **dict(SENSORS, DATA_ROOT=cluster_root))
    model = load_flax_params(Seq2seqTSN(3, 8, 16), _np(params))
    import functools
    ds = prepare_dataset(cfg.feature_root, cfg.train_session, "sensors",
                         cfg.label_root)
    emb, sessions, eids = unimodal_pretrain_cluster.embed_sessions(
        model, ds, functools.partial(tsn_prepare_input_test, 3),
        torch.device("cpu"))
    np.testing.assert_allclose(emb, np.asarray(want), atol=1e-5)
    assert sessions == sessions_j and [tuple(map(int, e)) for e in eids] \
        == [tuple(map(int, e)) for e in eids_j]
    assert emb.shape[0] > 300

    sk = SkKMeans(20, n_init=20, random_state=cfg.seed).fit(emb)
    km = KMeans(20, n_init=20, seed=cfg.seed).fit(emb)
    np.testing.assert_allclose(km.inertia_, sk.inertia_, rtol=1e-2)

    km.cluster_centers_ = sk.cluster_centers_
    got = unimodal_pretrain_cluster.high_confidence(emb, km, sessions,
                                                    eids, 3)
    ref = jax_cluster._high_confidence(emb, sk, sessions, eids, 3)
    for g, w in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2:] == ref[2:]


def test_cluster_run_writes_the_jax_files(sensors_root, tmp_path):
    """``run`` on a port Seq2seqTSN checkpoint writes train_data.pkl and
    val_data.pkl with the JAX trainer's keys and types (20 clusters, at
    most 100 / 20 rows each) and the centres and inertia in
    kmeans_model.pkl."""
    cfg = _cfg(TrainConfig, **dict(SENSORS, DATA_ROOT=sensors_root))
    cfg.model_path, _ = _sae_init(sensors_root, tmp_path, 3)
    out = unimodal_pretrain_cluster.run(cfg, result_dir=str(tmp_path / "k"),
                                        device="cpu")
    with open(os.path.join(out, "kmeans_model.pkl"), "rb") as f:
        state = pickle.load(f)
    assert state["cluster_centers"].shape == (20, 16)
    assert np.isfinite(state["inertia"]) and state["inertia"] > 0
    for name, cap in (("train_data.pkl", 100), ("val_data.pkl", 20)):
        with open(os.path.join(out, name), "rb") as f:
            data = pickle.load(f)
        assert sorted(data) == ["boundaries", "feats", "labels", "sessions"]
        assert data["feats"].dtype == np.float32
        assert data["labels"].dtype == np.int32
        assert data["labels"].shape == (data["feats"].shape[0], 1)
        assert np.bincount(data["labels"][:, 0]).max() <= cap
        assert len(data["sessions"]) == len(data["boundaries"]) == \
            data["feats"].shape[0]
    with pytest.raises(ValueError, match="model_path"):
        unimodal_pretrain_cluster.run(_cfg(TrainConfig, **SENSORS),
                                      device="cpu")


# ---------------------------------------------------------------------------
# unimodal_pretrain_pairsim
# ---------------------------------------------------------------------------

def _cluster_files(tmp_path, rng):
    """train_data.pkl (5 clusters of 10-12 rows) and val_data.pkl."""
    out = tmp_path / "kmeans"
    out.mkdir()
    centers = rng.randn(5, 16) * 2
    for name, sizes in (("train_data.pkl", (12, 10, 11, 10, 12)),
                        ("val_data.pkl", (4, 4, 4, 4, 4))):
        labels = np.concatenate([np.full(n, i) for i, n in
                                 enumerate(sizes)]).astype(np.int32)
        feats = (centers[labels] + rng.randn(len(labels), 16)
                 ).astype(np.float32)
        with open(out / name, "wb") as f:
            pickle.dump({"feats": feats, "labels": labels[:, None],
                         "sessions": ["s"] * len(labels),
                         "boundaries": [(0, 1)] * len(labels)}, f)
    return str(out / "train_data.pkl")


def test_pairsim_matches_jax_trainer(tmp_path, monkeypatch, rng):
    """Two epochs (phase 0.5 then 1.0) of ``unimodal_pretrain_pairsim``
    from the JAX head's initial draw: the same pairs, and each epoch's
    loss and accuracy within rtol 1e-4 and val_acc equal."""
    path = _cluster_files(tmp_path, rng)
    kw = dict(SENSORS, DATA_ROOT=str(tmp_path), max_epochs=2,
              learning_rate=0.01)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    params = JaxPairSim(n_input=16).init(
        jax.random.PRNGKey(jcfg.seed), jnp.zeros((2, 16)),
        jnp.zeros((2, 16)), method="score")["params"]

    def head(cfg, n_input, device):
        h = unimodal_pretrain_pairsim.PairSim(n_input)
        return load_flax_params(h, _np(params)).to(device)

    monkeypatch.setattr(unimodal_pretrain_pairsim, "build_head", head)
    pairs = {"port": [], "jax": []}
    for tag, module in (("port", unimodal_pretrain_pairsim),
                        ("jax", jax_pairsim)):
        orig = module.enumerate_batch

        def record(*a, _orig=orig, _tag=tag, **k):
            for a_idx, b_idx in _orig(*a, **k):
                pairs[_tag].append((list(map(int, a_idx)),
                                    list(map(int, b_idx))))
                yield a_idx, b_idx

        monkeypatch.setattr(module, "enumerate_batch", record)
    _, jmetrics, jax_dir = jax_pairsim.train(
        jcfg, train_data_path=path, result_dir=str(tmp_path / "jax"))
    res = unimodal_pretrain_pairsim.train(
        pcfg, train_data_path=path, result_dir=str(tmp_path / "port"),
        device="cpu")
    assert pairs["port"] == pairs["jax"] and len(pairs["port"]) == 4
    got, want = _records(res.result_dir), _records(jax_dir)
    assert _column(got, "phase") == _column(want, "phase") == [0.5, 1.0]
    for key in ("loss", "acc"):
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, err_msg=key)
    assert _column(got, "val_acc") == _column(want, "val_acc")
    assert 0.0 <= res.metrics["val_acc"] <= 1.0


# ---------------------------------------------------------------------------
# base_model_tf
# ---------------------------------------------------------------------------

def _fold_in_draws(seed: int):
    """The port's Gumbel draw replaying the JAX trainer's keys: a step's
    key is fold_in(PRNGKey(seed), step), split into (k_mine, k_drop);
    k_mine splits into the anchor, positive and negative keys."""
    state = {"step": 0}

    def draw(num_pairs, n, num_negative, generator, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), state["step"])
        state["step"] += 1
        k_mine, _ = jax.random.split(key)
        k_a, k_p, k_n = jax.random.split(k_mine, 3)

        def gumbel(k):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (num_pairs, n), jnp.float32))).to(device)

        return gumbel(k_a), gumbel(k_p), [
            gumbel(k) for k in jax.random.split(k_n, num_negative)]

    return draw


def test_base_model_tf_matches_jax_trainer(sensors_root, tmp_path,
                                           monkeypatch):
    """One epoch of ``base_model_tf`` at sensors width (ConvLSTM on 1 x 1
    x 8 frames, MAX_LENGTH_FRAMES 45, 16 events a batch) on the port's
    TFRecords, the miner fed the JAX draws: the loss and triplet-count
    traces within rtol 1e-4, val mAP within atol 1e-5; a checkpoint."""
    kw = dict(DATA_ROOT=sensors_root, network="convlstm", feat="sensors",
              n_input=8, n_C=4, emb_dim=16, triplet_per_batch=16,
              MAX_LENGTH_FRAMES=45, max_epochs=1)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    jcfg.tfrecords_root = pcfg.tfrecords_root = str(tmp_path / "tfr")
    ds = prepare_dataset(pcfg.feature_root,
                         pcfg.train_session + pcfg.val_session, "sensors",
                         pcfg.label_root)
    assert generate_event_tfrecords(ds, pcfg.tfrecords_root,
                                    ["sensors"]) > 32
    params = JaxConvLSTM(max_time=45, emb_dim=16, n_input=8, n_h=1, n_w=1,
                         n_C=4).init(jax.random.PRNGKey(jcfg.seed),
                                     jnp.zeros((2, 45, 1, 1, 8)),
                                     jnp.ones((2,), jnp.int32))["params"]
    model = load_flax_params(base_model_tf.build_model(
        pcfg, (1, 1, 8), torch.device("cpu")), _np(params))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)
    monkeypatch.setattr(mining, "_draw_gumbels", _fold_in_draws(jcfg.seed))

    _, jmetrics, jax_dir = jax_tf.train(jcfg, event_per_batch=16,
                                        result_dir=str(tmp_path / "jax"))
    res = base_model_tf.train(pcfg, event_per_batch=16,
                              result_dir=str(tmp_path / "port"),
                              device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    assert res.step == len(_column(want, "loss")) >= 2
    for key in ("loss", "triplet_num", "active_count"):
        assert all(np.isfinite(_column(got, key)))
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, err_msg=key)
    assert any(_column(got, "loss"))
    np.testing.assert_allclose(res.metrics["val_mAP"], jmetrics["val_mAP"],
                               atol=1e-5)
    assert f"t.ckpt-{res.step}" in os.listdir(res.result_dir)


def test_base_model_tf_stops_and_watchdog(sensors_root, tmp_path,
                                         monkeypatch, capsys):
    """``base_model_tf``'s run control, as the JAX trainer's
    (``base_model_tf.py:122-160``): a stop requested at the guard's second
    poll ends the run after step 2 with that step checkpointed and
    reported; ``--watchdog_secs`` arms the watchdog, which the run
    cancels unfired."""
    from multimodal_similarity_tpu_torch.train import run_control
    from multimodal_similarity_tpu_torch.utils import preemption, watchdog

    class FiringGuard(preemption.PreemptionGuard):
        polls = 0

        @property
        def should_stop(self):
            FiringGuard.polls += 1
            if FiringGuard.polls > 1:
                self.request_stop()
            return self._stop.is_set()

    armed = []
    real_install = watchdog.install_hang_watchdog

    def install(*a):
        wd = real_install(*a)
        armed.append(wd)
        return wd

    monkeypatch.setattr(preemption, "PreemptionGuard", FiringGuard)
    monkeypatch.setattr(run_control, "install_hang_watchdog", install)
    pcfg = _cfg(TrainConfig, DATA_ROOT=sensors_root, network="convlstm",
                feat="sensors", n_input=8, n_C=4, emb_dim=16,
                triplet_per_batch=16, MAX_LENGTH_FRAMES=45, max_epochs=50,
                watchdog_secs=60.0)
    pcfg.tfrecords_root = str(tmp_path / "tfr")
    ds = prepare_dataset(pcfg.feature_root,
                         pcfg.train_session + pcfg.val_session, "sensors",
                         pcfg.label_root)
    generate_event_tfrecords(ds, pcfg.tfrecords_root, ["sensors"])
    res = base_model_tf.train(pcfg, event_per_batch=16,
                              result_dir=str(tmp_path / "port"),
                              device="cpu")
    assert res.step == 2
    assert "preemption signal: checkpointed at step 2" in \
        capsys.readouterr().out
    assert "t.ckpt-2" in os.listdir(res.result_dir)
    (wd,) = armed
    assert wd.fired == 0 and wd._timer is None


# ---------------------------------------------------------------------------
# CLIs and options
# ---------------------------------------------------------------------------

def test_clis_run_the_chain_on_cpu(sensors_root, tmp_path):
    """``main([... --device cpu])`` of the three pretrain CLIs, each on the
    last one's output: a checkpoint, the cluster files, a val_acc."""
    common = ["--device", "cpu", "--DATA_ROOT", sensors_root, "--feat",
              "sensors", "--n_input", "8", "--emb_dim", "16",
              "--silent_mode", "--max_epochs", "1"]
    unimodal_pretrain_sae.main(common + ["--name", "cli_sae",
                                         "--sess_per_batch", "1",
                                         "--event_per_batch", "32"])
    runs = sorted((p for p in os.listdir(os.path.join(sensors_root,
                                                      "results"))
                   if p.startswith("cli_sae")))
    run_dir = os.path.join(sensors_root, "results", runs[-1])
    (ckpt,) = [n for n in os.listdir(run_dir) if ".ckpt-" in n]
    unimodal_pretrain_cluster.main(common + ["--model_path",
                                             os.path.join(run_dir, ckpt)])
    (kdir,) = [n for n in os.listdir(run_dir) if n.startswith("kmeans_")]
    unimodal_pretrain_pairsim.main(common + [
        "--name", "cli_pairsim", "--model_path",
        os.path.join(run_dir, kdir, "x")])
    runs = [p for p in os.listdir(os.path.join(sensors_root, "results"))
            if p.startswith("cli_pairsim")]
    recs = _records(os.path.join(sensors_root, "results", runs[-1]))
    assert 0.0 <= recs[-1]["val_acc"] <= 1.0


def test_options_and_missing_gpu_raise(sensors_root, tmp_path,
                                       monkeypatch):
    """``--multihost`` raises D6's ValueError on ``base_model_tf`` (no
    multi-process path in JAX; its run control is checked in
    ``test_base_model_tf_stops_and_watchdog``); ``--device_cache`` raises
    D5's ValueError there and the reference's on the autoencoder trainer
    under ``--bf16_features`` (the cache stores int8); the default device
    raises when no card is visible; ``base_model_tf`` without records
    raises."""
    cfg = _cfg(TrainConfig, **dict(SENSORS, DATA_ROOT=sensors_root))
    with pytest.raises(ValueError, match="excludes --bf16_features"):
        unimodal_pretrain_sae.train(_cfg(TrainConfig, **dict(
            SENSORS, DATA_ROOT=sensors_root, device_cache=True,
            bf16_features=True)), device="cpu")
    with pytest.raises(ValueError, match="base_model_tf has no cached feed"):
        base_model_tf.train(_cfg(TrainConfig, DATA_ROOT=sensors_root,
                                 device_cache=True), device="cpu")
    with pytest.raises(ValueError, match="--multihost: base_model_tf has no "
                       "multi-process path"):
        base_model_tf.train(_cfg(TrainConfig, DATA_ROOT=sensors_root,
                                 multihost=True), device="cpu")
    tcfg = _cfg(TrainConfig, DATA_ROOT=sensors_root, feat="sensors",
                network="convlstm")
    tcfg.tfrecords_root = str(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="tfrecords"):
        base_model_tf.train(tcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (unimodal_pretrain_sae.train, base_model_tf.train,
               unimodal_pretrain_pairsim.train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg)
