"""Data layer: on-disk contract readers, the session loader, TSN prep."""

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
from multimodal_similarity_tpu_torch.data.tsn import (
    mean_pool_input,
    tsn_prepare_input,
    tsn_prepare_input_test,
)

__all__ = [
    "prepare_dataset", "prepare_multimodal_dataset", "load_data_and_label",
    "load_validation_set", "modality_suffix", "SessionBatchLoader",
    "generate_synthetic_honda",
    "tsn_prepare_input", "tsn_prepare_input_test", "mean_pool_input",
    "LABEL_TRANSFER",
    "MIN_LENGTH", "MAX_LENGTH", "MIN_LENGTH_BACKGROUND", "MODALITY_SUFFIX",
    "HONDA_NUM2LABELS", "STIMULI_NUM2LABELS", "load_cub",
    "generate_synthetic_cub", "sample_cub_batch", "prepare_attribute",
]
