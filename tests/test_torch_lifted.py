"""The port's lifted-structured stats, loss and gradient
(ops/kernels/lifted.py, lifted_tri.py) against the JAX package's Pallas
kernels (interpret mode on the CPU) and the dense oracles, on the same numpy
inputs.  On a CPU tensor the port runs its plain PyTorch versions; the CUDA
kernels themselves are checked against those versions on the card by
chip_smoke.py.

The f32 row forward (K4) and recompute backward (K5) run their products on
the card's tensor cores through 3xTF32; here their splits (``tf32_split``,
``tf32_split_t``), 3xTF32 models of their products, models of their column
split and combine, and their grid choosers are held to the JAX kernels and
to the plain versions.

Tolerances: f32 stats and losses 1e-4 (summation order of the distance
products and of the exponential sums differs between XLA and PyTorch);
gradients rtol 1e-3 / atol 1e-5 as the JAX package's own kernel tests; bf16
5e-2 (operand rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.ops.distances import self_distance
from multimodal_similarity_tpu.ops.losses import lifted_loss as jax_lifted
from multimodal_similarity_tpu.ops.pallas.lifted import (
    fused_lifted_stats as jax_fused_lifted, lifted_loss_pallas)
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.kernels import (
    LAUNCHES, fused_lifted_stats, lifted_loss_fused, reset_launch_counts)
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    POS_INF, Operands, pad_depth, prep_operands)
from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
    BWD_CHUNK, BWD_TILE, NEG_INF, _lse, _masks, bwd_grid, fwd_split,
    lifted_bwd, lifted_bwd_plain, lifted_fwd, lifted_fwd_plain, tf32_split,
    tf32_split_t)
from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import (
    lifted_fwd_tri, tri_block)
from multimodal_similarity_tpu_torch.ops.losses import lifted_loss

MARGIN = 0.5
BOUNDED = [pytest.param(False, id="row"), pytest.param(True, id="tri")]


def _clustered(rng, n=60, n_classes=5, dim=24, normed=False):
    labels = rng.randint(0, n_classes, size=n)
    centers = rng.randn(n_classes, dim)
    emb = (centers[labels] + 0.8 * rng.randn(n, dim)).astype(np.float32)
    if normed:
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    labels[:3] = 1
    return emb, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("bounded", BOUNDED)
def test_lifted_stats_match_dense_and_jax(rng, bounded):
    emb, labels = _clustered(rng, normed=bounded)
    fp, cn, nc = fused_lifted_stats(_t(emb), _t(labels), None, MARGIN,
                                    "f32", bounded)
    jfp, jcn, jnc = jax_fused_lifted(jnp.asarray(emb), jnp.asarray(labels),
                                     None, MARGIN, 16, "f32", bounded)
    want = jax_lifted(self_distance(jnp.asarray(emb)),
                      jnp.asarray(labels, jnp.float32), MARGIN)
    dense = lifted_loss(pairwise_distance(_t(emb), _t(emb)), _t(labels),
                        MARGIN)
    for got, j, w, p in ((fp, jfp, want[4], dense[4]),
                         (cn, jcn, want[5], dense[5])):
        _close(got, j)
        _close(got, w)
        _close(p, w)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))


@pytest.mark.parametrize("bounded", BOUNDED)
def test_lifted_valid_mask_nonaligned(rng, bounded):
    """N = 37 over blocks of 16, the last 7 rows invalid: the stats equal
    the JAX kernel's row for row, and the loss equals the dense loss of the
    30 valid rows alone."""
    emb, labels = _clustered(rng, n=37, dim=8, normed=bounded)
    valid = (np.arange(37) < 30).astype(np.float32)
    got = lifted_loss_fused(_t(emb), _t(labels), MARGIN, True,
                            valid=_t(valid), bounded=bounded)
    jax_got = lifted_loss_pallas(jnp.asarray(emb), jnp.asarray(labels),
                                 MARGIN, True, valid=jnp.asarray(valid),
                                 block=16, bounded=bounded)
    want = jax_lifted(self_distance(jnp.asarray(emb[:30])),
                      jnp.asarray(labels[:30], jnp.float32), MARGIN)
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-4)
    np.testing.assert_allclose(got[0].item(), float(jax_got[0]), rtol=1e-4)
    for i in (2, 3, 4, 5):
        _close(got[i], jax_got[i])


@pytest.mark.parametrize("bounded", BOUNDED)
def test_row_with_no_valid_negative(rng, bounded):
    """Class 1 is valid, class 2 all invalid: class-1 rows have no valid
    negative.  The row forward keeps the -1e30 sentinel (max -1e30 plus
    log of the column count), the triangular one floors its sum at 1e-30;
    each equals its JAX counterpart."""
    emb = rng.randn(20, 8).astype(np.float32)
    if bounded:
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = np.repeat([1, 2], 10)
    valid = (labels == 1).astype(np.float32)
    fp, cn, nc = fused_lifted_stats(_t(emb), _t(labels), _t(valid), MARGIN,
                                    "f32", bounded)
    jfp, jcn, jnc = jax_fused_lifted(jnp.asarray(emb), jnp.asarray(labels),
                                     jnp.asarray(valid), MARGIN, 16, "f32",
                                     bounded)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))
    assert (nc[:10] == 0).all() and (nc[10:] == 10).all()
    if bounded:
        np.testing.assert_allclose(cn[:10].numpy(), np.log(np.float32(1e-30)),
                                   rtol=1e-6)
    else:
        assert (cn[:10] == np.float32(-1e30)).all()
    np.testing.assert_allclose(cn.numpy(), np.asarray(jcn), rtol=1e-5,
                               atol=1e-4)
    _close(fp, jfp)
    # the gradient through such rows stays finite
    e = _t(emb).clone().requires_grad_(True)
    fp, cn, _ = fused_lifted_stats(e, _t(labels), _t(valid), MARGIN, "f32",
                                   bounded)
    (fp.sum() + cn[10:].sum()).backward()
    assert torch.isfinite(e.grad).all()


@pytest.mark.parametrize("bounded", BOUNDED)
def test_large_label_ids(rng, bounded):
    """Ids above 2^24 equal the JAX result on the same ids (which remaps
    them), and ids of 2^40 give the same stats as small ones: labels are
    compared as int64, never cast to float."""
    emb, _ = _clustered(rng, n=48, dim=16, normed=bounded)
    small = np.array([1, 2, 3] * 16, np.int64)
    ref = fused_lifted_stats(_t(emb), _t(small), None, MARGIN, "f32",
                             bounded)
    mid = small + (1 << 26)
    assert np.float32(mid[0]) == np.float32(mid[1])
    jfp, jcn, jnc = jax_fused_lifted(jnp.asarray(emb), jnp.asarray(mid),
                                     None, MARGIN, 16, "f32", bounded)
    got = fused_lifted_stats(_t(emb), _t(mid), None, MARGIN, "f32", bounded)
    _close(got[0], jfp)
    _close(got[1], jcn)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jnc))
    huge = fused_lifted_stats(_t(emb), _t(small + (1 << 40)), None, MARGIN,
                              "f32", bounded)
    for a, b in zip(huge, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("bounded", BOUNDED)
def test_loss_tuple_matches_jax(rng, weighted, bounded):
    emb, labels = _clustered(rng, n=50, normed=bounded)
    labels[10:14] = 0  # background anchors
    got = lifted_loss_fused(_t(emb), _t(labels), MARGIN, weighted,
                            bounded=bounded)
    jax_got = lifted_loss_pallas(jnp.asarray(emb), jnp.asarray(labels),
                                 MARGIN, weighted, block=16, bounded=bounded)
    assert len(got) == 6 and got[1].item() == 1.0
    np.testing.assert_allclose(got[0].item(), float(jax_got[0]), rtol=1e-4)
    for a, b in zip(got[2:], jax_got[2:]):
        _close(a, b)
    dense = lifted_loss(pairwise_distance(_t(emb), _t(emb)), _t(labels),
                        MARGIN, weighted)
    np.testing.assert_allclose(dense[0].item(), got[0].item(), rtol=1e-4)


@pytest.mark.parametrize("bounded", BOUNDED)
def test_gradients_match_jax(rng, bounded):
    emb, labels = _clustered(rng, n=48, dim=16, normed=bounded)
    e = _t(emb).clone().requires_grad_(True)
    lifted_loss_fused(e, _t(labels), MARGIN, True, bounded=bounded)[0] \
        .backward()

    def fused(x):
        return lifted_loss_pallas(x, jnp.asarray(labels), MARGIN, True,
                                  block=16, bounded=bounded)[0]

    def dense(x):
        return jax_lifted(self_distance(x), jnp.asarray(labels, jnp.float32),
                          MARGIN, True)[0]

    for fn in (fused, dense):
        g = np.asarray(jax.grad(fn)(jnp.asarray(emb)))
        np.testing.assert_allclose(e.grad.numpy(), g, rtol=1e-3, atol=1e-5)
    # and the port's own dense oracle under autograd
    e2 = _t(emb).clone().requires_grad_(True)
    lifted_loss(pairwise_distance(e2, e2), _t(labels), MARGIN)[0].backward()
    np.testing.assert_allclose(e.grad.numpy(), e2.grad.numpy(), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("bounded", BOUNDED)
def test_vjp_with_arbitrary_cotangents(rng, bounded):
    """The recompute backward (straight + transposed pass) against the JAX
    VJP for cotangents that are not the loss weights, with a valid mask
    and non-aligned N: invalid rows and padding contribute nothing."""
    emb, labels = _clustered(rng, n=45, dim=12, normed=bounded)
    valid = (rng.rand(45) > 0.2).astype(np.float32)
    g_fp = rng.randn(45).astype(np.float32)
    g_cn = rng.randn(45).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_lifted(
        x, jnp.asarray(labels), jnp.asarray(valid), MARGIN, 16, "f32",
        bounded)[:2], jnp.asarray(emb))
    want = np.asarray(vjp((jnp.asarray(g_fp), jnp.asarray(g_cn)))[0])
    e = _t(emb).clone().requires_grad_(True)
    fp, cn, _ = fused_lifted_stats(e, _t(labels), _t(valid), MARGIN, "f32",
                                   bounded)
    torch.autograd.backward((fp, cn), (_t(g_fp), _t(g_cn)))
    np.testing.assert_allclose(e.grad.numpy(), want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("bounded", BOUNDED)
def test_bf16_close_to_f32(rng, bounded):
    emb, labels = _clustered(rng, n=48, dim=16, normed=bounded)
    out = {}
    for precision in ("f32", "bf16"):
        e = _t(emb).clone().requires_grad_(True)
        res = lifted_loss_fused(e, _t(labels), MARGIN, True,
                                precision=precision, bounded=bounded)
        res[0].backward()
        out[precision] = (res[0].item(), res[4], res[5], e.grad)
    np.testing.assert_allclose(out["bf16"][0], out["f32"][0], rtol=5e-2)
    for a, b in zip(out["bf16"][1:], out["f32"][1:]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-2, atol=5e-2)


def test_cpu_path_counts_no_launch(rng):
    emb, labels = _clustered(rng, n=30)
    before = dict(LAUNCHES)
    for bounded in (False, True):
        e = _t(emb).clone().requires_grad_(True)
        lifted_loss_fused(e, _t(labels), MARGIN, bounded=bounded)[0] \
            .backward()
    assert LAUNCHES == before


def test_reset_launch_counts_covers_every_kernel():
    """One registry holds every kernel module's counts, and one reset
    clears them all."""
    assert {"batch_hard_stats_idx", "batch_hard_stats", "lifted_fwd",
            "lifted_bwd", "lifted_fwd_tri"} <= set(LAUNCHES)
    for key in LAUNCHES:
        LAUNCHES[key] = 3
    reset_launch_counts()
    assert set(LAUNCHES.values()) == {0}


def test_dispatch_by_device():
    """CPU operands take the plain versions; a device with no kernel
    raises rather than falling back."""
    emb = torch.randn(8, 4)
    ops = prep_operands(emb, torch.tensor([1, 1, 2, 2, 3, 3, 4, 4]),
                        torch.ones(8), "f32")
    assert len(lifted_fwd(ops, 0.2)) == 3 and len(lifted_fwd_tri(ops, 0.2))
    meta = Operands(*(t.to("meta") for t in ops))
    for call in (lambda: lifted_fwd(meta, 0.2),
                 lambda: lifted_fwd_tri(meta, 0.2),
                 lambda: lifted_bwd(meta, *(torch.zeros(8),) * 4, 0.2)):
        with pytest.raises(ValueError, match="no .* kernel for device"):
            call()


@pytest.mark.parametrize("n,sms,want", [(512, 132, 32), (960, 132, 32),
                                        (1024, 132, 64), (8192, 132, 64)])
def test_triangular_tile_choice(n, sms, want):
    assert tri_block(n, sms) == want


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: what the tensor core reads
    of an f32 operand in TF32."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


@pytest.mark.parametrize("case", ["random", "zeros", "negative", "huge"])
def test_tf32_split(rng, case):
    """hi + lo == x bit for bit, hi is a TF32 value (low 13 bits zero), the
    one nearest x (|lo| <= 2^-11 |x|, within 2^-10 as for truncation), for
    zeros, negatives and values at the 1e30 scale of the penalised
    norms."""
    x = rng.randn(257).astype(np.float32)
    if case == "zeros":
        x[::2] = 0.0
        x[1::4] = -0.0
    elif case == "negative":
        x = -np.abs(x) - 1e-3
    elif case == "huge":
        x = (x * 1e30).astype(np.float32)
    x = _t(x)
    hi, lo = tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & ((1 << 13) - 1)).any()
    assert bool((lo.abs() <= x.abs() * 2.0 ** -11).all())
    assert bool((lo.abs() <= (x - _tf32(x)).abs()).all())
    assert torch.equal(torch.signbit(hi[hi != 0]), torch.signbit(x[hi != 0]))


def _stats_from_inner(ops: Operands, inner: torch.Tensor, margin: float):
    """K4's statistics with the given inner products in place of the
    exact ones: lifted_fwd_plain's formulas, sentinels and f32 epilogue."""
    dist = torch.clamp((ops.sq[:, None] + ops.sq_pen[None, :]) - 2.0 * inner,
                       min=0.0)
    same, pos = _masks(ops)
    v_pos = torch.where(pos, dist, torch.zeros_like(dist)) \
        - (1.0 - ops.valid)[None, :] * POS_INF
    v_neg = torch.where(same, torch.full_like(dist, NEG_INF), margin - dist)
    nc = torch.where(same, torch.zeros_like(dist), ops.valid[None, :]).sum(1)
    return _lse(v_pos), _lse(v_neg), nc


def _no_negative_case(rng):
    emb = rng.randn(20, 8).astype(np.float32)
    labels = np.repeat([1, 2], 10)
    return emb, labels, (labels == 1).astype(np.float32)


@pytest.mark.parametrize("case", ["clustered", "unnormalised_x3",
                                  "no_valid_negative"])
def test_3xtf32_products_keep_jax_parity(rng, case):
    """The card's f32 K4 forms <e_i, e_j> as hi.hi + hi.lo + lo.hi with lo
    read as TF32 (csrc/wgmma_tf32.cuh).  Modelled here, in float64 and
    rounded to f32, those products give stats within 1e-4 of the JAX
    package's K4 (interpret mode): the parity claim of the 3xTF32 design,
    shown without the card.  Plain TF32 (hi.hi alone) is further off."""
    valid = None
    if case == "no_valid_negative":
        emb, labels, valid = _no_negative_case(rng)
    else:
        emb, labels = _clustered(rng)
        if case == "unnormalised_x3":
            emb = emb * 3.0
    valid_t = _t(valid) if valid is not None else torch.ones(len(labels))
    ops = prep_operands(_t(emb), _t(labels), valid_t, "f32")
    hi, lo = tf32_split(ops.opd)
    hi, lo = hi.double(), _tf32(lo).double()
    inner = (hi @ lo.T + lo @ hi.T + hi @ hi.T).float()
    fp, cn, nc = _stats_from_inner(ops, inner, MARGIN)
    jfp, jcn, jnc = jax_fused_lifted(
        jnp.asarray(emb), jnp.asarray(labels),
        None if valid is None else jnp.asarray(valid), MARGIN, 16, "f32",
        False)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))
    _close(fp, jfp)
    np.testing.assert_allclose(cn.numpy(), np.asarray(jcn), rtol=1e-5,
                               atol=1e-4)
    if case == "no_valid_negative":
        assert (cn[:10] == np.float32(-1e30)).all()
    # the split matters: TF32 alone moves the distances by about 2^-11
    exact = ops.opd.double() @ ops.opd.double().T
    err3 = float((inner.double() - exact).abs().max())
    err1 = float((hi @ hi.T - exact).abs().max())
    assert err3 * 100 < err1


def _split_model(ops: Operands, margin: float, split: int, block: int = 64):
    """The f32 K4's column split in plain PyTorch: per range of whole
    `block`-column tiles, each row's (max, sum of exp) of v_pos and v_neg
    (maxima from -FLT_MAX) and negative count; ranges merged in ascending
    order with lse_merge; fp = m + log(max(s, 1e-30))."""
    n = ops.sq.shape[0]
    dist = torch.clamp((ops.sq[:, None] + ops.sq_pen[None, :])
                       - 2.0 * (ops.opd @ ops.opd.T), min=0.0)
    same, pos = _masks(ops)
    v_pos = torch.where(pos, dist, torch.zeros_like(dist)) \
        - (1.0 - ops.valid)[None, :] * POS_INF
    v_neg = torch.where(same, torch.full_like(dist, NEG_INF), margin - dist)
    negs = torch.where(same, torch.zeros_like(dist), ops.valid[None, :])
    tiles = -(-n // block)
    per = -(-tiles // split)
    lowest = torch.finfo(torch.float32).min
    state = None
    for c0 in range(0, tiles * block, per * block):
        cols = slice(c0, min(n, c0 + per * block))
        part = []
        for v in (v_pos, v_neg):
            m = torch.clamp(v[:, cols].max(1).values, min=lowest)
            part += [m, torch.exp(v[:, cols] - m[:, None]).sum(1)]
        part.append(negs[:, cols].sum(1))
        if state is None:
            state = part
            continue
        for k in (0, 2):   # lse_merge into the running state
            m, s, om, os_ = state[k], state[k + 1], part[k], part[k + 1]
            mx = torch.maximum(m, om)
            state[k + 1] = s * torch.exp(m - mx) + os_ * torch.exp(om - mx)
            state[k] = mx
        state[4] = state[4] + part[4]
    pm, ps, qm, qs, nc = state
    return (pm + torch.log(torch.clamp(ps, min=1e-30)),
            qm + torch.log(torch.clamp(qs, min=1e-30)), nc)


@pytest.mark.parametrize("split", [1, 2, 4])
def test_column_split_and_combine(rng, split):
    """Per-range (max, sum) merged in ascending order equals the plain K4,
    with a range whose columns are all invalid (columns 64-127) and rows
    with no valid negative (label 7: its only other-label columns are the
    invalid ones, whose cn stays exactly -1e30)."""
    n = 200
    labels = np.full(n, 7)
    labels[64:128] = 9
    labels[150:170] = 3
    valid = np.ones(n, np.float32)
    valid[64:128] = 0.0
    labels[150:170] = 7   # no valid negative for any label-7 row
    emb = rng.randn(n, 12).astype(np.float32)
    ops = prep_operands(_t(emb), _t(labels), _t(valid), "f32")
    got = _split_model(ops, MARGIN, split)
    want = lifted_fwd_plain(ops, MARGIN)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    sentinel = want[1] <= -0.5e30
    assert bool(sentinel[labels == 7].all()) and not sentinel[64:128].any()
    assert torch.equal(got[1][sentinel], want[1][sentinel])
    assert bool((got[1][sentinel] == np.float32(-1e30)).all())
    _close(got[0], want[0], 1e-5)
    _close(got[1][~sentinel], want[1][~sentinel], 1e-5)


@pytest.mark.parametrize("n,sms,want", [
    (16, 132, 1), (300, 132, 5), (512, 132, 8), (777, 132, 7),
    (1000, 132, 8), (8192, 132, 1), (16384, 132, 1), (512, 16, 2)])
def test_fwd_split_table(n, sms, want):
    assert fwd_split(n, sms) == want


@pytest.mark.parametrize("sms", [16, 132])
def test_fwd_split_ranges_fill_without_passing(sms):
    """No range is empty, and row blocks times ranges stay within the SM
    count unless one range is all there is."""
    for n in range(1, 20000, 97):
        tiles = -(-n // 64)
        split = fwd_split(n, sms)
        per = -(-tiles // split)
        assert 1 <= split <= tiles and (split - 1) * per < tiles
        assert split == 1 or tiles * split <= sms


@pytest.mark.parametrize("d", [1, 7, 90])
def test_pad_depth_keeps_lifted_stats(rng, d):
    """The zero columns that f32 TMA rows need (a multiple of 4) leave the
    plain K4 bit-identical."""
    emb, labels = _clustered(rng, n=45, dim=d)
    valid = (rng.rand(45) > 0.2).astype(np.float32)
    ops = prep_operands(_t(emb) * 3.0, _t(labels), _t(valid), "f32")
    padded = pad_depth(ops.opd, 4)
    assert padded.shape == (45, -(-d // 4) * 4)
    assert torch.equal(padded[:, :d], ops.opd) and not padded[:, d:].any()
    for got, want in zip(lifted_fwd_plain(ops._replace(opd=padded), MARGIN),
                         lifted_fwd_plain(ops, MARGIN)):
        assert torch.equal(got, want)


def test_backward_past_1024_columns_matches_jax(rng):
    """d = 1536, past the 1024 columns the card's K5 holds in shared memory
    at once (it walks d in chunks there): the port's recompute backward
    against the JAX package's VJP through its K5 (interpret mode), with a
    valid mask and arbitrary cotangents.  Unit rows (taken through the row
    forward all the same): at this depth unnormalised rows have squared
    distances in the thousands, whose f32 rounding alone moves the
    softmax weights past the gradient tolerance."""
    emb, labels = _clustered(rng, n=24, dim=1536, normed=True)
    valid = (rng.rand(24) > 0.2).astype(np.float32)
    g_fp = rng.randn(24).astype(np.float32)
    g_cn = rng.randn(24).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_lifted(
        x, jnp.asarray(labels), jnp.asarray(valid), MARGIN, 16, "f32",
        False)[:2], jnp.asarray(emb))
    want = np.asarray(vjp((jnp.asarray(g_fp), jnp.asarray(g_cn)))[0])
    ops = prep_operands(_t(emb), _t(labels), _t(valid), "f32")
    fp, cn, _ = lifted_fwd_plain(ops, MARGIN)
    got = lifted_bwd_plain(ops, fp, cn, _t(g_fp), _t(g_cn), MARGIN)
    assert got.shape == (24, 1536)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)


def _coef_from_inner(ops: Operands, inner, fp, cn, g_fp, g_cn, margin):
    """C [N, N] of lifted_coefficients with the given inner products in
    place of the exact ones (row i's stats, column j's penalised norm)."""
    dist = torch.clamp((ops.sq[:, None] + ops.sq_pen[None, :]) - 2.0 * inner,
                       min=0.0)
    same, pos = _masks(ops)
    v_pos = dist - (1.0 - ops.valid)[None, :] * POS_INF
    soft_pos = torch.where(pos, torch.exp(v_pos - fp[:, None]),
                           torch.zeros_like(dist))
    soft_neg = torch.where(
        same, torch.zeros_like(dist),
        torch.exp((margin - dist) - cn[:, None]) * ops.valid[None, :])
    return g_fp[:, None] * soft_pos - g_cn[:, None] * soft_neg


def _product(a, b, products):
    """a @ b^T as the card forms it: "3xtf32" (hi lo + lo hi + hi hi, lo
    read as TF32), "tf32" (hi hi alone), "exact" (float64), all rounded to
    f32 at the end; or "f32" (a plain f32 product)."""
    if products == "f32":
        return a @ b.T
    if products == "exact":
        return (a.double() @ b.double().T).float()
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    ah, bh = ah.double(), bh.double()
    out = ah @ bh.T
    if products == "3xtf32":
        out = ah @ _tf32(bl).double().T + _tf32(al).double() @ bh.T + out
    return out.float()


def _bwd_model(ops: Operands, fp, cn, g_fp, g_cn, margin, ranges=1,
               products="3xtf32"):
    """The card's f32 K5 in plain PyTorch: S = the tile products, C = C_ij
    + C_ji from S (both directions read the same S, as the card does), per
    range of whole 64-column tiles and per 128-column chunk of the depth G
    = C E (split as well: C hi E lo + C lo E hi + C hi E hi) and the range's
    row sums of C, in f32; ranges added in ascending order; grad = 2
    (rowsum e - G)."""
    x = ops.opd
    n, d = x.shape
    inner = _product(x, x, products)
    c = (_coef_from_inner(ops, inner, fp, cn, g_fp, g_cn, margin)
         + _coef_from_inner(ops, inner.T, fp, cn, g_fp, g_cn, margin).T)
    tiles = -(-n // BWD_TILE)
    per = -(-tiles // ranges)
    g = rs = None
    for c0 in range(0, n, per * BWD_TILE):
        cols = slice(c0, min(n, c0 + per * BWD_TILE))
        part = torch.cat([_product(c[:, cols], x[cols, k0:k0 + BWD_CHUNK].T,
                                   products)
                          for k0 in range(0, d, BWD_CHUNK)], dim=1)
        part_rs = c[:, cols].sum(1)
        g = part if g is None else g + part
        rs = part_rs if rs is None else rs + part_rs
    return 2.0 * (rs[:, None] * x - g)


def _bwd_case(rng, case):
    """(emb, labels, valid, block) of a K5 model case: three 64-column
    tiles (so three column ranges) at N=150, unit rows or unit rows x 3 as
    chip_smoke.py's cases (at N=150, d=24 clustered rows of norm 6 give
    distances near 80, whose f32 rounding alone moves single gradient
    entries past the tolerance, the plain version's too)."""
    if case == "no_valid_negative":
        return (*_no_negative_case(rng), 16)
    if case == "deep_unit":   # three 128-column chunks of the depth
        emb, labels = _clustered(rng, n=40, dim=300, normed=True)
        return emb, labels, (rng.rand(40) > 0.1).astype(np.float32), 16
    emb, labels = _clustered(rng, n=150, dim=20, normed=True)
    valid = np.ones(150, np.float32)
    if case == "ragged_valid":
        valid = (rng.rand(150) > 0.2).astype(np.float32)
    elif case == "unnormalised_x3":
        emb = emb * 3.0
    return emb, labels, valid, 64


@pytest.mark.parametrize("case", ["clustered", "unnormalised_x3",
                                  "no_valid_negative", "ragged_valid",
                                  "deep_unit"])
def test_3xtf32_backward_keeps_jax_parity(rng, case):
    """The card's f32 K5 modelled in float64 products (both of them 3xTF32,
    C split too, the depth in 128-column chunks, the column ranges the
    chooser gives on 132 SMs added in ascending order) against the JAX
    package's VJP through its K5 (interpret mode), with arbitrary
    cotangents: the parity claim of the design, shown without the card.
    Plain TF32 (hi hi alone in both products) is further off."""
    emb, labels, valid, block = _bwd_case(rng, case)
    n, d = emb.shape
    g_fp = rng.randn(n).astype(np.float32)
    g_cn = rng.randn(n).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_lifted(
        x, jnp.asarray(labels), jnp.asarray(valid), MARGIN, block, "f32",
        False)[:2], jnp.asarray(emb))
    want = np.asarray(vjp((jnp.asarray(g_fp), jnp.asarray(g_cn)))[0])
    ops = prep_operands(_t(emb), _t(labels), _t(valid), "f32")
    fp, cn, _ = lifted_fwd_plain(ops, MARGIN)
    ranges, chunks = bwd_grid(n, d, 132)
    assert chunks == -(-d // BWD_CHUNK)
    stats = (fp, cn, _t(g_fp), _t(g_cn), MARGIN)
    got = _bwd_model(ops, *stats, ranges=ranges)
    assert got.shape == (n, d) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)
    exact = _bwd_model(ops, *stats, ranges=ranges, products="exact")
    plain = _bwd_model(ops, *stats, ranges=ranges, products="tf32")
    err3 = float((got - exact).abs().max())
    err1 = float((plain - exact).abs().max())
    assert err3 * 100 < err1


@pytest.mark.parametrize("n,d", [(1, 1), (45, 90), (64, 128), (130, 7)])
def test_tf32_split_t(rng, n, d):
    """hi^T + lo^T equals x^T bit for bit, hi^T is TF32, and the padding
    to whole 128-row chunks and 64-column tiles is zeros."""
    x = _t((rng.randn(n, d) * 3.0).astype(np.float32))
    rows, cols = -(-d // BWD_CHUNK) * BWD_CHUNK, -(-n // BWD_TILE) * BWD_TILE
    hi_t, lo_t = tf32_split_t(x, rows, cols)
    assert hi_t.shape == lo_t.shape == (rows, cols)
    assert torch.equal(hi_t[:d, :n] + lo_t[:d, :n], x.T)
    hi, lo = tf32_split(x)
    assert torch.equal(hi_t[:d, :n], hi.T) and torch.equal(lo_t[:d, :n], lo.T)
    for t in (hi_t, lo_t):
        assert not t[d:].any() and not t[:, n:].any()
        assert not torch.signbit(t[d:]).any()


@pytest.mark.parametrize("n,d,want", [
    (16, 128, (1, 1)), (300, 128, (5, 1)), (512, 128, (8, 1)),
    (1000, 128, (8, 1)), (8192, 128, (1, 1)), (16384, 128, (1, 1)),
    (512, 300, (4, 3)), (1000, 1536, (1, 12)), (1000, 2048, (1, 16))])
def test_bwd_grid_table(n, d, want):
    assert bwd_grid(n, d, 132) == want


@pytest.mark.parametrize("sms", [16, 132])
def test_bwd_grid_ranges_fill_without_passing(sms):
    """No range is empty, and row blocks times chunks times ranges stay
    within the SM count unless one range is all there is."""
    for n in range(1, 20000, 97):
        for d in (24, 128, 300, 2048):
            tiles = -(-n // 64)
            ranges, chunks = bwd_grid(n, d, sms)
            per = -(-tiles // ranges)
            assert chunks * 128 >= d > (chunks - 1) * 128
            assert 1 <= ranges <= tiles and (ranges - 1) * per < tiles
            assert -(-tiles // per) == ranges
            assert ranges == 1 or tiles * chunks * ranges <= sms


@pytest.mark.parametrize("ranges", [1, 2, 4])
def test_bwd_split_and_combine(rng, ranges):
    """The f32 K5's ranges and chunks (f32 products, row sums and G per
    range, added in ascending order) equal the plain K5 within 1e-6 of the
    gradient's scale, with a range whose columns are all invalid (64-127,
    the second of 4 ranges) and rows with no valid negative (label 7)."""
    n = 200
    labels = np.full(n, 7)
    labels[64:128] = 9
    labels[150:170] = 7
    valid = np.ones(n, np.float32)
    valid[64:128] = 0.0
    emb = rng.randn(n, 140).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ops = prep_operands(_t(emb), _t(labels), _t(valid), "f32")
    fp, cn, _ = lifted_fwd_plain(ops, MARGIN)
    g_fp = _t(rng.rand(n).astype(np.float32))
    g_cn = _t(rng.rand(n).astype(np.float32))
    want = lifted_bwd_plain(ops, fp, cn, g_fp, g_cn, MARGIN)
    got = _bwd_model(ops, fp, cn, g_fp, g_cn, MARGIN, ranges=ranges,
                     products="f32")
    scale = float(want.abs().max())
    assert scale > 0 and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6 * scale
