"""Offline preprocessing: frame extraction (``frames``), per-frame feature
extraction on the card (``features``), annotation parsing
(``annotations``), sensor normalisation (``sensors``) and segmentation
features (``segmentation``), each importable and a CLI (``python -m
multimodal_similarity_tpu_torch preprocess.<name>``); TFRecord generation
lives in ``data/tfrecords.py``.  The host modules are the JAX package's
NumPy code, copied."""

from multimodal_similarity_tpu_torch.preprocess.sensors import (
    normalize_sensors)
from multimodal_similarity_tpu_torch.preprocess.segmentation import (
    downsample_seg,
    spatial_pyramid_features,
)

__all__ = [
    "normalize_sensors",
    "spatial_pyramid_features",
    "downsample_seg",
]
