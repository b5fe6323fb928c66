"""Dependency-free TFRecord + SequenceExample IO.

The reference stores one tf.train.SequenceExample per event in .tfrecords
files.  TensorFlow is not a dependency, so this module implements the wire
formats directly:

- TFRecord framing: <uint64 length><uint32 masked-crc32c(length)>
  <payload><uint32 masked-crc32c(payload)>; the CRC32C (Castagnoli) is the
  native library's (``data/native.py``).
- A minimal protobuf codec for the SequenceExample subset the contract
  uses: int64/bytes context features and packed-float FeatureLists.

Proto schema (tensorflow/core/example/{example,feature}.proto):
  SequenceExample{1: context Features, 2: feature_lists FeatureLists}
  Features{1: map<string, Feature>}   FeatureLists{1: map<string, FeatureList>}
  FeatureList{1: repeated Feature}
  Feature{1: BytesList, 2: FloatList, 3: Int64List}; each list: field 1.

Records written here are byte-identical to the JAX package's.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, Iterator, Tuple, Union

import numpy as np

from multimodal_similarity_tpu_torch.data.native import native_crc32c


def crc32c(data: bytes) -> int:
    return native_crc32c(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Varint / protobuf primitives
# ---------------------------------------------------------------------------

def _write_varint(out: bytearray, value: int) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("corrupt protobuf: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("corrupt protobuf: varint overflow")


def _tag(field: int, wire: int) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | wire)
    return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    out = bytearray(_tag(field, 2))
    _write_varint(out, len(payload))
    out.extend(payload)
    return bytes(out)


# ---------------------------------------------------------------------------
# Feature encode
# ---------------------------------------------------------------------------

ContextValue = Union[int, float, bytes, str]


def _encode_feature(value) -> bytes:
    """Encode one Feature from an int / float / bytes / 1-D float array."""
    if isinstance(value, (bytes, str)):
        data = value.encode() if isinstance(value, str) else value
        return _len_delim(1, _len_delim(1, data))               # bytes_list
    if isinstance(value, (int, np.integer)):
        out = bytearray(_tag(1, 0))
        _write_varint(out, value & 0xFFFFFFFFFFFFFFFF)
        return _len_delim(3, bytes(out))                        # int64_list
    if isinstance(value, (float, np.floating)):
        value = np.asarray([value], dtype="<f4")
    arr = np.ascontiguousarray(np.asarray(value, dtype="<f4").reshape(-1))
    packed = _len_delim(1, arr.tobytes())                       # packed floats
    return _len_delim(2, packed)                                # float_list


def encode_sequence_example(
    context: Dict[str, ContextValue],
    feature_lists: Dict[str, np.ndarray],
) -> bytes:
    """context: name -> scalar; feature_lists: name -> [T, D] float array."""
    ctx = bytearray()
    for key, value in context.items():
        entry = _len_delim(1, key.encode()) + _len_delim(
            2, _encode_feature(value))
        ctx.extend(_len_delim(1, entry))

    fls = bytearray()
    for key, arr in feature_lists.items():
        arr = np.asarray(arr, dtype="<f4")
        flist = bytearray()
        for t in range(arr.shape[0]):
            flist.extend(_len_delim(1, _encode_feature(arr[t])))
        entry = _len_delim(1, key.encode()) + _len_delim(2, bytes(flist))
        fls.extend(_len_delim(1, entry))

    return _len_delim(1, bytes(ctx)) + _len_delim(2, bytes(fls))


# ---------------------------------------------------------------------------
# Feature decode
# ---------------------------------------------------------------------------

def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            length, pos = _read_varint(buf, pos)
            if pos + length > len(buf):
                raise ValueError(
                    "corrupt protobuf: field length past buffer end")
            yield field, wire, buf[pos:pos + length]
            pos += length
        elif wire == 0:
            value, pos = _read_varint(buf, pos)
            yield field, wire, value
        elif wire == 5:
            if pos + 4 > len(buf):
                raise ValueError("corrupt protobuf: truncated fixed32")
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            if pos + 8 > len(buf):
                raise ValueError("corrupt protobuf: truncated fixed64")
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf: bytes):
    for field, wire, payload in _iter_fields(buf):
        if field == 1:      # bytes_list
            for f2, _, p2 in _iter_fields(payload):
                if f2 == 1:
                    return p2
        elif field == 2:    # float_list (packed or repeated)
            values = []
            for f2, w2, p2 in _iter_fields(payload):
                if f2 == 1 and w2 == 2:
                    values.append(np.frombuffer(p2, dtype="<f4"))
                elif f2 == 1 and w2 == 5:
                    values.append(np.frombuffer(p2, dtype="<f4"))
            return np.concatenate(values) if values else np.zeros(0, "<f4")
        elif field == 3:    # int64_list
            for f2, w2, p2 in _iter_fields(payload):
                if f2 == 1 and w2 == 0:
                    return int(np.int64(np.uint64(p2)))
                if f2 == 1 and w2 == 2:
                    val, _ = _read_varint(p2, 0)
                    return int(np.int64(np.uint64(val)))
    return None


def parse_sequence_example(buf: bytes):
    """-> (context dict, feature_lists dict of [T, D] float32 arrays)."""
    context: Dict[str, ContextValue] = {}
    feature_lists: Dict[str, np.ndarray] = {}
    for field, _, payload in _iter_fields(buf):
        if field == 1:      # context Features
            for f2, _, entry in _iter_fields(payload):
                if f2 != 1:
                    continue
                key, feat = None, None
                for f3, _, p3 in _iter_fields(entry):
                    if f3 == 1:
                        key = p3.decode()
                    elif f3 == 2:
                        feat = _decode_feature(p3)
                context[key] = feat
        elif field == 2:    # feature_lists
            for f2, _, entry in _iter_fields(payload):
                if f2 != 1:
                    continue
                key, rows = None, []
                for f3, _, p3 in _iter_fields(entry):
                    if f3 == 1:
                        key = p3.decode()
                    elif f3 == 2:
                        for f4, _, p4 in _iter_fields(p3):
                            if f4 == 1:
                                rows.append(_decode_feature(p4))
                feature_lists[key] = (np.stack(rows) if rows
                                      else np.zeros((0, 0), "<f4"))
    return context, feature_lists


# ---------------------------------------------------------------------------
# TFRecord file IO
# ---------------------------------------------------------------------------

def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


def read_tfrecord(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) < 4:
                raise ValueError("corrupt tfrecord: truncated header crc")
            (hcrc,) = struct.unpack("<I", hcrc_raw)
            # check the header BEFORE honoring its length claim: a corrupt
            # 8-byte length field must not drive a huge read/allocation
            if verify_crc and _masked_crc(header) != hcrc:
                raise ValueError("corrupt tfrecord: bad length crc")
            data = f.read(length)
            if len(data) < length:
                raise ValueError("corrupt tfrecord: truncated payload")
            dcrc_raw = f.read(4)
            if len(dcrc_raw) < 4:
                raise ValueError("corrupt tfrecord: truncated payload crc")
            (dcrc,) = struct.unpack("<I", dcrc_raw)
            if verify_crc and _masked_crc(data) != dcrc:
                raise ValueError("corrupt tfrecord: bad data crc")
            yield data


def generate_event_tfrecords(dataset, out_dir: str, feat_names,
                             prepare_funcs=None, max_length: int = 90) -> int:
    """One SequenceExample per event per session, as the reference's
    preprocessing writes them: context {label, length, session_id,
    event_id}; one FeatureList per modality with a flattened per-frame
    float vector.  Returns the number of events written."""
    from multimodal_similarity_tpu_torch.data.datasets import (
        load_data_and_label)

    os.makedirs(out_dir, exist_ok=True)
    total = 0
    for row in dataset:
        session_id = os.path.basename(row[-1]).split("_")[0]
        per_modality = []
        labels = None
        for m, name in enumerate(feat_names):
            prep = prepare_funcs[m] if prepare_funcs else None
            eve, lab, bounds = load_data_and_label(row[m], row[-1], prep)
            # with identity prepare (the reference's raw per-frame
            # contract) the events arrive
            # FRAME-concatenated: [total_frames, ...] — split back into
            # per-event windows via the boundary lengths.  A prepared
            # modality ([n_events, ...]) indexes directly.
            lengths = [e - s for s, e in bounds]
            if (eve.shape[0] == int(np.sum(lengths, dtype=np.int64))
                    and eve.shape[0] != lab.shape[0]):
                offs = np.concatenate([[0], np.cumsum(lengths)])
                per_event = [eve[offs[j]: offs[j + 1]]
                             for j in range(lab.shape[0])]
            else:
                per_event = [np.asarray(eve[j]).reshape(1, -1)
                             if eve.ndim == 2 else np.asarray(eve[j])
                             for j in range(lab.shape[0])]
            per_modality.append(per_event)
            labels = lab
        n_events = labels.shape[0]
        for i in range(n_events):
            feature_lists = {}
            for name, per_event in zip(feat_names, per_modality):
                ev = np.asarray(per_event[i])
                frames = ev.reshape(ev.shape[0], -1)
                feature_lists[name] = frames[:max_length]
            length = next(iter(feature_lists.values())).shape[0]
            rec = encode_sequence_example(
                {"label": int(labels[i, 0]), "length": int(length),
                 "session_id": session_id, "event_id": i},
                feature_lists)
            path = os.path.join(out_dir, f"{session_id}_{i:04d}.tfrecords")
            write_tfrecord(path, [rec])
            total += 1
    return total
