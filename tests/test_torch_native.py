"""The port's native host data path against NumPy and the JAX package: the
``g++`` build (concurrent first uses, failures that raise), the CRC32C, the
TSN gather and ``load_data_and_label`` (bit-equal to the per-event Python
loop and to the JAX function, generator state included), the TFRecord
codec (byte-identical records) and the event loader (equal batches on both
parse paths), and corrupt records.  Exact equality throughout."""

import functools
import os
import pickle
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from multimodal_similarity_tpu.data import datasets as jax_datasets
from multimodal_similarity_tpu.data import tfrecord_loader as jax_tfl
from multimodal_similarity_tpu.data import tfrecords as jax_tfr
from multimodal_similarity_tpu.data import tsn as jax_tsn
from multimodal_similarity_tpu_torch.data import datasets, native, tsn
from multimodal_similarity_tpu_torch.data import tfrecord_loader as tfl
from multimodal_similarity_tpu_torch.data import tfrecords as tfr
from multimodal_similarity_tpu_torch.data.synthetic import (
    generate_synthetic_honda)
from multimodal_similarity_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_concurrent_first_builds_share_one_library(tmp_path):
    """Four processes building into an empty directory at once: each
    loads a library at the one hashed path, and no temporary file is
    left."""
    script = textwrap.dedent(f"""
        from pathlib import Path
        from multimodal_similarity_tpu_torch.data import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        lib = native.load_native()
        assert lib.msim_crc32c(b"123456789", 9) == 0xE3069283
        print(native.library_path())
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(outs[0])]


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g[+][+] failed.*broken.cc"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        native.build()


def test_failed_build_raises_in_the_loader(tmp_path, monkeypatch):
    """A TSN-sampled load does not fall back to Python when the library
    cannot be built: it raises, before any draw."""
    feat_path, label_path = _session(tmp_path, np.random.RandomState(0))

    def broken():
        raise RuntimeError("g++ failed (rc 1)")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", broken)
    rng = np.random.RandomState(3)
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        datasets.load_data_and_label(feat_path, label_path, _train_prep(rng))
    assert rng.randint(1 << 30) == np.random.RandomState(3).randint(1 << 30)


# ---------------------------------------------------------------------------
# CRC32C and the gather
# ---------------------------------------------------------------------------

def test_crc32c_matches_the_python_codec(rng, monkeypatch):
    monkeypatch.setattr(jax_tfr, "_NATIVE_CRC", False)  # the table loop
    for blob in (b"", b"123456789", rng.bytes(1000), rng.bytes(4099)):
        assert tfr.crc32c(blob) == jax_tfr.crc32c(blob)
        assert tfr._masked_crc(blob) == jax_tfr._masked_crc(blob)
    assert native.native_crc32c(b"123456789") == 0xE3069283


def test_gather_segments_matches_numpy_indexing(rng):
    feats = rng.randn(100, 12).astype(np.float32)
    starts = np.array([0, 30, 60, 90], np.int64)
    offsets = rng.randint(0, 10, size=(4, 3)).astype(np.int64)
    out = native.native_gather_segments(feats, starts, offsets)
    np.testing.assert_array_equal(out, feats[starts[:, None] + offsets])
    # a strided view is gathered from its contiguous copy
    view = rng.randn(100, 24).astype(np.float32)[:, ::2]
    np.testing.assert_array_equal(
        native.native_gather_segments(view, starts, offsets),
        view[starts[:, None] + offsets])


def test_gather_segments_bounds_and_shape_checks(rng):
    feats = rng.randn(10, 4).astype(np.float32)
    for start, offs in ((8, [0, 1, 5]), (-2, [0, 1, 1])):
        with pytest.raises(IndexError, match="out of range"):
            native.native_gather_segments(
                feats, np.array([start], np.int64),
                np.array([offs], np.int64))
    # one start for two events would let the C side read past it
    with pytest.raises(ValueError, match="starts"):
        native.native_gather_segments(feats, np.array([0], np.int64),
                                      np.zeros((2, 3), np.int64))
    with pytest.raises(ValueError, match="feats"):
        native.native_gather_segments(feats[None], np.array([0], np.int64),
                                      np.zeros((1, 3), np.int64))


def test_counts_lose_no_update_across_threads(monkeypatch):
    """16 threads adding to a counter at once, with the interpreter
    switching threads every microsecond: no update is lost."""
    import threading
    native.reset_counts()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [profiling.count("native.gather") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counters("native.")["gather"] == 16 * 2000


# ---------------------------------------------------------------------------
# load_data_and_label
# ---------------------------------------------------------------------------

def _session(tmp_path, rng, frame_shape=(6,), fortran=False, T=200,
             lengths=(20, 25, 3, 30, 10, 120), raw=(0, 3, 5, 7, 0, 2)):
    """One session on the contract: features npy and a label pkl whose
    segments are background, short and over-long events."""
    feats = rng.randn(T, *frame_shape).astype(np.float32)
    if fortran:
        feats = np.asfortranarray(feats)
    feat_path = str(tmp_path / "sess.npy")
    np.save(feat_path, feats)
    label_path = str(tmp_path / "sess_goal.pkl")
    with open(label_path, "wb") as f:
        pickle.dump({"label": None, "s": np.cumsum((0,) + tuple(lengths)),
                     "G": list(raw)}, f)
    return feat_path, label_path


def _train_prep(rng, module=tsn, n_seg=3):
    # the loader's binding: partial(partial(f, n_seg), rng=...)
    return functools.partial(
        functools.partial(module.tsn_prepare_input, n_seg), rng=rng)


def _python_path(monkeypatch):
    monkeypatch.setattr(datasets, "_load_events_tsn_native",
                        lambda *a: None)


def _assert_same(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [tuple(map(int, b)) for b in got[2]] == \
        [tuple(map(int, b)) for b in want[2]]


@pytest.mark.parametrize("frame_shape", [(6,), (2, 2, 3)])
@pytest.mark.parametrize("sampling", ["train", "test"])
def test_load_matches_python_loop_and_jax(tmp_path, monkeypatch, rng,
                                          frame_shape, sampling):
    """Native gather == patched Python loop == the JAX function, events,
    labels and boundaries bit for bit, and each generator in the same
    state afterwards; the native run counted as a gather."""
    feat_path, label_path = _session(tmp_path, rng, frame_shape)
    gens = [np.random.RandomState(7) for _ in range(3)]
    if sampling == "train":
        preps = [_train_prep(gens[0]), _train_prep(gens[1]),
                 _train_prep(gens[2], jax_tsn)]
    else:
        preps = [functools.partial(tsn.tsn_prepare_input_test, 3)] * 2 + [
            functools.partial(jax_tsn.tsn_prepare_input_test, 3)]
    native.reset_counts()
    got = datasets.load_data_and_label(feat_path, label_path, preps[0])
    assert profiling.counters("native.")["gather"] == 1
    want_jax = jax_datasets.load_data_and_label(feat_path, label_path,
                                                preps[2])
    _python_path(monkeypatch)
    want = datasets.load_data_and_label(feat_path, label_path, preps[1])
    assert profiling.counters("native.")["gather_deferred"] == 1
    assert got[0].shape == (4, 3) + frame_shape
    _assert_same(got, want)
    _assert_same(got, want_jax)
    draws = {g.randint(1 << 30) for g in gens}
    assert len(draws) == 1


def test_loader_batches_take_the_native_gather(tmp_path, monkeypatch):
    """SessionBatchLoader batches with the native gather equal the Python
    loop's and the JAX loader's for the same seed, over two epochs."""
    from multimodal_similarity_tpu.data import SessionBatchLoader as JaxSBL
    from multimodal_similarity_tpu_torch.data import SessionBatchLoader
    root = str(tmp_path / "d")
    generate_synthetic_honda(root, n_sessions=4, frames_per_session=200,
                             modal_dims={"sensors": (8,)}, seed=0)
    rows = datasets.prepare_dataset(os.path.join(root, "features"),
                                    _sessions(root), "sensors",
                                    os.path.join(root, "labels"))

    def epochs(loader):
        return [b for _ in range(2) for b in loader.epoch()]

    kw = dict(sess_per_batch=2, event_budget=24, seed=5)
    native.reset_counts()
    got = epochs(SessionBatchLoader(
        rows, prepare_funcs=[functools.partial(tsn.tsn_prepare_input, 3)],
        **kw))
    assert profiling.counters("native.") == {"gather": 8, "gather_deferred": 0, "parse": 0,
                             "parse_deferred": 0}
    want_jax = epochs(JaxSBL(
        rows, prepare_funcs=[functools.partial(jax_tsn.tsn_prepare_input,
                                               3)], **kw))
    _python_path(monkeypatch)
    want = epochs(SessionBatchLoader(
        rows, prepare_funcs=[functools.partial(tsn.tsn_prepare_input, 3)],
        **kw))
    assert len(got) == len(want) == len(want_jax) == 4
    for g, w, j in zip(got, want, want_jax):
        for key in ("events", "labels", "mask"):
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(g[key], j[key])


def _sessions(root):
    with open(os.path.join(root, "all_session.txt")) as f:
        return f.read().split()


def test_deferrals_and_errors_follow_the_python_loop(tmp_path, rng):
    """Fortran-order features and a prepare function that is not a TSN
    sampler take the Python loop; too few frames for the segments and a
    session where no event survives raise as the loop does."""
    feat_path, label_path = _session(tmp_path, rng, fortran=True)
    native.reset_counts()
    gen_a, gen_b = np.random.RandomState(1), np.random.RandomState(1)
    got = datasets.load_data_and_label(feat_path, label_path,
                                       _train_prep(gen_a))
    want = jax_datasets.load_data_and_label(feat_path, label_path,
                                            _train_prep(gen_b, jax_tsn))
    _assert_same(got, want)
    assert gen_a.randint(1 << 30) == gen_b.randint(1 << 30)
    datasets.load_data_and_label(feat_path, label_path,
                                 functools.partial(tsn.rnn_prepare_input, 9))
    assert profiling.counters("native.")["gather_deferred"] == 2
    assert profiling.counters("native.")["gather"] == 0

    feat_path, label_path = _session(tmp_path, rng)
    with pytest.raises(NotImplementedError, match="too short"):
        datasets.load_data_and_label(
            feat_path, label_path, _train_prep(np.random.RandomState(0),
                                               n_seg=26))
    feat_path, label_path = _session(tmp_path, rng, lengths=(3, 4, 8),
                                     raw=(2, 3, 0), T=30)
    with pytest.raises(ValueError, match="survives"):
        datasets.load_data_and_label(feat_path, label_path,
                                     _train_prep(np.random.RandomState(0)))


def test_test_sampling_of_more_segments_than_frames(tmp_path, rng,
                                                   monkeypatch):
    """Centre-frame sampling of more segments than a window's frames takes
    frame 0 for each, as the Python loop does (the JAX native gather
    raises there)."""
    feat_path, label_path = _session(tmp_path, rng)
    prep = functools.partial(tsn.tsn_prepare_input_test, 30)
    got = datasets.load_data_and_label(feat_path, label_path, prep)
    with pytest.raises(NotImplementedError):
        jax_datasets.load_data_and_label(
            feat_path, label_path,
            functools.partial(jax_tsn.tsn_prepare_input_test, 30))
    _python_path(monkeypatch)
    _assert_same(got, datasets.load_data_and_label(feat_path, label_path,
                                                   prep))


def test_rnn_prepare_and_factory_match_jax(rng):
    for t in (5, 12):
        feat = rng.randn(t, 2, 3).astype(np.float32)
        np.testing.assert_array_equal(tsn.rnn_prepare_input(8, feat),
                                      jax_tsn.rnn_prepare_input(8, feat))
    for network, train in (("convlstm", True), ("rtsn", True),
                           ("rtsn", False)):
        got = tsn.make_prepare_input(network, 3, 8, train)
        want = jax_tsn.make_prepare_input(network, 3, 8, train)
        assert got.func.__name__ == want.func.__name__
        assert got.args == want.args


# ---------------------------------------------------------------------------
# TFRecords
# ---------------------------------------------------------------------------

def _record(rng, label, t, d=8, key="sensors"):
    return {"label": label, "length": t, "session_id": "s", "event_id": 0}, \
        {key: rng.randn(t, d).astype(np.float32)}


def test_records_are_byte_identical_to_jax(tmp_path, rng):
    ctx, fl = _record(rng, 3, 5)
    fl["resnet"] = rng.randn(5, 2, 2, 3).astype(np.float32).reshape(5, -1)
    ctx["score"] = 0.25
    rec = tfr.encode_sequence_example(ctx, fl)
    assert rec == jax_tfr.encode_sequence_example(ctx, fl)
    got_ctx, got_fl = tfr.parse_sequence_example(rec)
    assert got_ctx == jax_tfr.parse_sequence_example(rec)[0]
    for key in fl:
        np.testing.assert_array_equal(got_fl[key], fl[key])
    tfr.write_tfrecord(str(tmp_path / "a"), [rec, rec[:10]])
    jax_tfr.write_tfrecord(str(tmp_path / "b"), [rec, rec[:10]])
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert list(tfr.read_tfrecord(str(tmp_path / "a"))) == [rec, rec[:10]]


def _honda_rows(tmp_path):
    """A 3-session directory with sensors (8,) and resnet (2, 2, 3)
    features: its rows for both modalities."""
    root = str(tmp_path / "honda")
    generate_synthetic_honda(root, n_sessions=3, frames_per_session=120,
                             modal_dims={"sensors": (8,),
                                         "resnet": (2, 2, 3)}, seed=1)
    return datasets.prepare_multimodal_dataset(
        os.path.join(root, "features"), _sessions(root),
        ["sensors", "resnet"], os.path.join(root, "labels"))


@pytest.mark.parametrize("prepared", [False, True])
def test_generate_event_tfrecords_matches_jax(tmp_path, prepared):
    """The files ``generate_event_tfrecords`` writes, raw frames and TSN
    centre frames, byte for byte."""
    rows = _honda_rows(tmp_path)
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    preps = ([functools.partial(tsn.tsn_prepare_input_test, 3)] * 2
             if prepared else None)
    jax_preps = ([functools.partial(jax_tsn.tsn_prepare_input_test, 3)] * 2
                 if prepared else None)
    n = tfr.generate_event_tfrecords(rows, out_p, ["sensors", "resnet"],
                                     preps)
    assert n == jax_tfr.generate_event_tfrecords(
        rows, out_j, ["sensors", "resnet"], jax_preps) > 5
    names = sorted(os.listdir(out_p))
    assert names == sorted(os.listdir(out_j))
    for name in names:
        with open(os.path.join(out_p, name), "rb") as a, \
                open(os.path.join(out_j, name), "rb") as b:
            assert a.read() == b.read(), name


def test_event_loader_matches_jax_on_both_parse_paths(tmp_path,
                                                      monkeypatch):
    """Two shuffled epochs of 5-event batches (the last padded): native
    parse == Python parse == the JAX loader, and the counts say which
    path each batch took."""
    out = str(tmp_path / "recs")
    tfr.generate_event_tfrecords(_honda_rows(tmp_path), out,
                                 ["sensors", "resnet"])
    sessions = _sessions(str(tmp_path / "honda"))[:2]
    paths = tfl.list_event_tfrecords(out, sessions)
    assert paths == jax_tfl.list_event_tfrecords(out, sessions)

    def epochs(cls, feat, dim):
        loader = cls(paths, feat, dim, event_per_batch=5, max_time=16,
                     seed=4)
        return [b for _ in range(2) for b in loader.epoch()]

    for feat, dim in (("sensors", 8), ("resnet", 12)):
        want = epochs(jax_tfl.EventTFRecordLoader, feat, dim)
        native.reset_counts()
        got = epochs(tfl.EventTFRecordLoader, feat, dim)
        assert profiling.counters("native.")["parse"] == len(got) == len(want)
        with monkeypatch.context() as m:
            m.setattr(native, "native_load_event_batch",
                      lambda *a, **k: (None, None, None, 0))
            python = epochs(tfl.EventTFRecordLoader, feat, dim)
        assert profiling.counters("native.")["parse_deferred"] == len(python)
        for g, p, w in zip(got, python, want):
            for key in ("features", "seq_len", "labels", "mask",
                        "num_events"):
                np.testing.assert_array_equal(g[key], w[key])
                np.testing.assert_array_equal(p[key], w[key])


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", tfr._masked_crc(header))
            + payload + struct.pack("<I", tfr._masked_crc(payload)))


def test_corrupt_and_truncated_records(tmp_path, rng):
    """The native parse counts none of the hostile files (rows left zero)
    and one good one; the loader then parses the batch in Python, which
    raises on a bit flip, a truncation, a missing key and a width
    mismatch, as the JAX loader's Python path does."""
    ctx, fl = _record(rng, 1, 4)
    good = tfr.encode_sequence_example(ctx, fl)
    framed = _frame(good)
    flipped = bytearray(framed)
    flipped[20] ^= 0xFF
    cases = {"flip": bytes(flipped), "truncated": framed[:len(framed) // 2],
             "garbage": _frame(bytes(rng.bytes(100))),
             "bad_header_crc": struct.pack("<QI", len(good), 0xDEADBEEF)
             + good + struct.pack("<I", tfr._masked_crc(good))}
    paths = {}
    for name, blob in dict(cases, good=framed).items():
        paths[name] = str(tmp_path / f"{name}.tfrecords")
        with open(paths[name], "wb") as f:
            f.write(blob)
    out, seq_len, labels, ok = native.native_load_event_batch(
        list(paths.values()), "sensors", 8, 8)
    assert ok == 1 and labels[-1] == 1 and seq_len[-1] == 4
    np.testing.assert_array_equal(out[:-1], 0.0)
    np.testing.assert_array_equal(out[-1, :4], fl["sensors"])

    for name, error in (("flip", "bad data crc"),
                        ("truncated", "truncated payload"),
                        ("bad_header_crc", "bad length crc")):
        loader = tfl.EventTFRecordLoader([paths["good"], paths[name]],
                                         "sensors", 8, 2, 8, shuffle=False)
        with pytest.raises(ValueError, match=error):
            next(loader.epoch())
    for feat, dim, error in (("resnet", 8, KeyError),
                             ("sensors", 16, ValueError)):
        loader = tfl.EventTFRecordLoader([paths["good"]], feat, dim, 1, 8)
        jax_loader = jax_tfl.EventTFRecordLoader([paths["good"]], feat,
                                                 dim, 1, 8)
        with pytest.raises(error):
            next(loader.epoch())
        with pytest.raises(error):
            next(jax_loader.epoch())
