"""The port's pair heads (PairSim, PairSim2, PDDM), its all-pairs scorers
and its semi-hard miner's label ranking against the JAX package, on the
same numpy inputs with the flax params mapped by convert.py.  Tolerances
at each assertion."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.models import heads as jh
from multimodal_similarity_tpu.ops.distances import self_distance
from multimodal_similarity_tpu.ops.mining import (
    mine_semihard_triplets as jax_mine,
    mine_semihard_triplets_from_embeddings as jax_mine_rows)
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.models import heads as th
from multimodal_similarity_tpu_torch.ops import mining

D = 8
HEADS = {"PairSim": (jh.PairSim, th.PairSim),
         "PairSim2": (jh.PairSim2, th.PairSim2),
         "PDDM": (jh.PDDM, th.PDDM)}


def _pair(name, seed=0):
    """A flax head initialised at width D, the port's head holding the same
    params (eval mode: dropout off), and the flax variables."""
    jcls, tcls = HEADS[name]
    jmod = jcls(n_input=D)
    e0 = jnp.zeros((2, D), jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(seed), e0, e0, method="score")
    tmod = load_flax_params(tcls(D), jax.tree.map(np.asarray,
                                                  variables["params"]))
    return jmod, variables, tmod.eval()


def _emb(rng, n):
    return rng.randn(n, D).astype(np.float32)


@pytest.mark.parametrize("name", list(HEADS))
def test_head_score_and_forward_match_flax(rng, name):
    """``score(a, b)`` and ``forward([a, b])``: logits and probabilities
    within 1e-6 of flax, dropout off."""
    jmod, variables, tmod = _pair(name)
    a, b = _emb(rng, 17), _emb(rng, 17)
    want_s = jmod.apply(variables, jnp.asarray(a), jnp.asarray(b),
                        method="score")
    want_f = jmod.apply(variables, jnp.asarray(np.stack([a, b], 1)))
    with torch.no_grad():
        got_s = tmod.score(torch.from_numpy(a), torch.from_numpy(b))
        got_f = tmod(torch.from_numpy(np.stack([a, b], 1)))
    for got, want in ((got_s, want_s), (got_f, want_f)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_pairsim_dropout_draws_from_its_generator(rng):
    """Training mode drops with the head's own generator: the same seed
    gives the same output, another seed another; eval mode drops
    nothing."""
    a, b = (torch.from_numpy(_emb(rng, 32)) for _ in range(2))

    def out(seed, train=True):
        head = th.PairSim(D, keep_prob=0.5,
                          generator=torch.Generator().manual_seed(0),
                          dropout_generator=torch.Generator().manual_seed(
                              seed))
        head.train(train)
        with torch.no_grad():
            return head.score(a, b)[0]

    assert torch.equal(out(1), out(1))
    assert not torch.equal(out(1), out(2))
    assert torch.equal(out(1, train=False), out(2, train=False))


SCORERS = {
    "all_pairs": (lambda f, e, b: jh.score_all_pairs(f, e, block=b),
                  lambda f, e, b: th.score_all_pairs(f, e, block=b)),
    "rows": (lambda f, e, b: jh.score_rows(
                 f, e, jnp.asarray([12, 0, 5, 5, 7]), block=b),
             lambda f, e, b: th.score_rows(
                 f, e, torch.tensor([12, 0, 5, 5, 7]), block=b)),
    "sym": (lambda f, e, b: jh.score_all_pairs_sym(f, e, block=b),
            lambda f, e, b: th.score_all_pairs_sym(f, e, block=b)),
}


@pytest.mark.parametrize("name,scorer", [
    (name, scorer) for name in HEADS for scorer in SCORERS
    if not (scorer == "sym" and name == "PairSim")])
def test_scorers_match_jax(rng, name, scorer):
    """Each scorer at a non-aligned N (13 rows, blocks of 4) within 1e-6
    of the JAX scorer on the same head; the symmetric scorer only for the
    swap-invariant heads (PairSim's concatenation order matters)."""
    jmod, variables, tmod = _pair(name)
    emb = _emb(rng, 13)
    jfn, tfn = SCORERS[scorer]
    want = jfn(functools.partial(jmod.apply, variables, method="score"),
               jnp.asarray(emb), 4)
    with torch.no_grad():
        got = tfn(tmod.score, torch.from_numpy(emb), 4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("block", [4, 5, 128])
@pytest.mark.parametrize("name", ["PairSim2", "PDDM"])
def test_symmetric_scorer_equals_full(rng, name, block, monkeypatch):
    """For the swap-invariant heads the symmetric scorer equals the full
    one (1e-6), also when a head call holds only part of the tile pairs
    (a small chunk bound)."""
    _, _, tmod = _pair(name, seed=1)
    emb = torch.from_numpy(_emb(rng, 23))
    with torch.no_grad():
        full = th.score_all_pairs(tmod.score, emb, block=block)
        monkeypatch.setattr(th, "_CHUNK_ELEMS", 3 * 16 * D)
        sym = th.score_all_pairs_sym(tmod.score, emb, block=block)
        rows = th.score_rows(tmod.score, emb, torch.arange(23), block=block)
    np.testing.assert_allclose(sym.numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_allclose(rows.numpy(), full.numpy(), atol=1e-6)


def _jax_draws(key):
    """The Gumbel arrays the JAX miner draws for ``key``."""
    def draw(num_pairs, n, num_negative, generator, device):
        k_a, k_p, k_n = jax.random.split(key, 3)

        def gumbel(k):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (num_pairs, n), jnp.float32))).to(device)

        return gumbel(k_a), gumbel(k_p), [
            gumbel(k) for k in jax.random.split(k_n, num_negative)]
    return draw


def _labels(kind, rng, n=48):
    """Float labels (distinct classes 0.25 apart), negative and sparse
    int64 labels, and labels where one foreground class has a single
    member (it may not anchor, but is a negative)."""
    if kind == "float":
        return rng.choice([0.0, 0.25, 0.5, 1.5, 2.75], size=n).astype(
            np.float32)
    if kind == "negative_sparse":
        return rng.choice([-7, -1, 0, 3, 90017, 2 ** 31 - 1],
                          size=n).astype(np.int64)
    labels = rng.randint(1, 4, size=n).astype(np.int64)
    labels[rng.randint(n)] = 9
    return labels


@pytest.mark.parametrize("miner", ["matrix", "rows"])
@pytest.mark.parametrize("kind", ["float", "negative_sparse",
                                  "single_member"])
def test_miner_ranks_labels_as_jax(monkeypatch, kind, miner):
    """The sort-rank of the raw labels: fed the JAX draws, both device
    miners pick the same anchors, positives, negatives, mask and active
    count as the JAX miners (exact), on float labels, negative and sparse
    int64 labels, and a single-member class."""
    rng = np.random.RandomState(3)
    labels = _labels(kind, rng)
    n = labels.shape[0]
    emb = (rng.randint(-2, 3, size=(n, 6))).astype(np.float32)
    valid = (np.arange(n) < n - 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(mining, "_draw_gumbels", _jax_draws(key))
    args = dict(alpha=2.5, num_negative=3)
    if miner == "matrix":
        dists = np.array(self_distance(jnp.asarray(emb)))
        want = jax_mine(jnp.asarray(dists), jnp.asarray(labels), key, 24,
                        valid=jnp.asarray(valid), **args)
        got = mining.mine_semihard_triplets(
            torch.from_numpy(dists), torch.from_numpy(labels), None, 24,
            valid=torch.from_numpy(valid), **args)
    else:
        want = jax_mine_rows(jnp.asarray(emb), jnp.asarray(labels), key, 24,
                             valid=jnp.asarray(valid), **args)
        got = mining.mine_semihard_triplets_from_embeddings(
            torch.from_numpy(emb), torch.from_numpy(labels), None, 24,
            valid=torch.from_numpy(valid), **args)
    assert float(want.mask.sum()) > 0
    for field in ("anchor", "positive", "negative", "mask"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    assert float(got.active_count) == float(want.active_count)
    if kind == "single_member":
        lone = int(np.flatnonzero(labels == 9)[0])
        assert lone not in got.anchor.numpy().tolist()


def test_miner_makes_no_data_sized_call(rng, monkeypatch):
    """The miners' ranking and sampling call nothing whose output size
    depends on the data, nor read a value back: ``torch.unique`` and its
    kin raise if called."""
    def forbidden(name):
        def raise_(*a, **k):
            raise AssertionError(f"{name} called while mining")
        return raise_

    for owner, name in ((torch, "unique"), (torch.Tensor, "unique"),
                        (torch, "unique_consecutive"), (torch, "nonzero"),
                        (torch.Tensor, "nonzero"), (torch, "masked_select"),
                        (torch.Tensor, "item"), (torch.Tensor, "tolist")):
        monkeypatch.setattr(owner, name, forbidden(name))
    labels = torch.from_numpy(rng.randint(0, 5, size=40))
    emb = torch.from_numpy(_emb(rng, 40))
    gen = torch.Generator().manual_seed(0)
    dists = torch.cdist(emb, emb) ** 2
    for mined in (mining.mine_semihard_triplets(dists, labels, gen, 12),
                  mining.mine_semihard_triplets_from_embeddings(
                      emb, labels, gen, 12)):
        assert mined.anchor.shape == (12,)
