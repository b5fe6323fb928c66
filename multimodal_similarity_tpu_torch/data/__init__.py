"""Data layer: on-disk contract readers, the session loader, TSN prep,
the TFRecord codec and event loader, and the native host data path."""

from multimodal_similarity_tpu_torch.data.cub import (
    generate_synthetic_cub,
    load_cub,
    prepare_attribute,
    sample_cub_batch,
)
from multimodal_similarity_tpu_torch.data.datasets import (
    load_data_and_label,
    load_validation_set,
    modality_suffix,
    prepare_dataset,
    prepare_multimodal_dataset,
)
from multimodal_similarity_tpu_torch.data.honda import (
    HONDA_NUM2LABELS,
    LABEL_TRANSFER,
    MAX_LENGTH,
    MIN_LENGTH,
    MIN_LENGTH_BACKGROUND,
    MODALITY_SUFFIX,
    STIMULI_NUM2LABELS,
)
from multimodal_similarity_tpu_torch.data.loader import SessionBatchLoader
from multimodal_similarity_tpu_torch.data.synthetic import (
    generate_synthetic_honda)
from multimodal_similarity_tpu_torch.data.native import (
    native_crc32c,
    native_gather_segments,
    native_load_event_batch,
)
from multimodal_similarity_tpu_torch.data.tfrecord_loader import (
    EventTFRecordLoader,
    list_event_tfrecords,
)
from multimodal_similarity_tpu_torch.data.tfrecords import (
    encode_sequence_example,
    generate_event_tfrecords,
    parse_sequence_example,
    read_tfrecord,
    write_tfrecord,
)
from multimodal_similarity_tpu_torch.data.tsn import (
    make_prepare_input,
    max_pool_input,
    mean_pool_input,
    rnn_prepare_input,
    tsn_prepare_input,
    tsn_prepare_input_test,
)

__all__ = [
    "prepare_dataset", "prepare_multimodal_dataset", "load_data_and_label",
    "load_validation_set", "modality_suffix", "SessionBatchLoader",
    "generate_synthetic_honda",
    "tsn_prepare_input", "tsn_prepare_input_test", "mean_pool_input", "max_pool_input",
    "rnn_prepare_input", "make_prepare_input", "native_crc32c",
    "native_gather_segments", "native_load_event_batch",
    "encode_sequence_example", "parse_sequence_example", "write_tfrecord",
    "read_tfrecord", "generate_event_tfrecords", "EventTFRecordLoader",
    "list_event_tfrecords",
    "LABEL_TRANSFER",
    "MIN_LENGTH", "MAX_LENGTH", "MIN_LENGTH_BACKGROUND", "MODALITY_SUFFIX",
    "HONDA_NUM2LABELS", "STIMULI_NUM2LABELS", "load_cub",
    "generate_synthetic_cub", "sample_cub_batch", "prepare_attribute",
]
