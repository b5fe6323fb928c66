"""Per-frame CNN feature extraction on the card.

Reference: preprocess/feat_extract_ResNetV2.py:10-143 (Inception-ResNet-v2
conv maps, 8x8x1536 a frame) and feat_extract_GoogleNet.py:10-45
(InceptionV1 1024-d pools) through TF-slim checkpoints, plus the
Stanford40 word2vec text features (feat_extract_ResNetV2.py:84-107).

The port of the JAX package's ``preprocess/features.py``.
``slim_backbone`` (JAX: ``flax_backbone``) runs the port's slim-exact
towers (models/inception_resnet_v2.py, models/inception_v1.py) with the
reference's preprocessing (uint8 -> [0, 1] -> bilinear resize -> [-1, 1])
on ``device`` (``cuda`` unless the caller asks for the CPU).
``slim_checkpoint=`` (.npz of slim variable names -> arrays) grafts
pretrained weights; without it the towers run at a random init from seed 0.
The Inception-ResNet-v2 ``embed_fn`` returns NHWC ``[B, 8, 8, 1536]`` f32,
the layout the Honda loader and the device cache read.  ``embed_fn``
stays pluggable for any callable ``(batch_uint8 [B, H, W, 3]) ->
features``; ``torch_backbone`` builds one from a torchvision model and
a local state dict when that optional package is present.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_similarity_tpu_torch.utils.profiling import span


def _load_frames(frame_dir: str):
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ImportError("Pillow required to read frames") from e
    paths = sorted(glob.glob(os.path.join(frame_dir, "frame_*.jpg")))
    for p in paths:
        yield np.asarray(Image.open(p).convert("RGB"))


def make_preprocess(size: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 frames [B, H, W, 3] -> the tower's NCHW f32 input at ``size``
    x ``size``: / 255, a bilinear resize with half-pixel centres, then
    (x - 0.5) * 2, as the JAX ``_pre``.  ``jax.image.resize`` low-passes
    when it shrinks an axis, so the resize antialiases when either side
    shrinks (an upscale is plain bilinear)."""

    def pre(batch: torch.Tensor) -> torch.Tensor:
        x = batch.permute(0, 3, 1, 2).float() / 255.0
        shrinks = x.shape[2] > size or x.shape[3] > size
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=shrinks)
        return (x - 0.5) * 2.0

    return pre


def build_tower(name: str, slim_checkpoint: Optional[str] = None,
                device=None):
    """(tower in eval mode on ``device``, its default input size) for
    ``name``: the slim checkpoint's weights (every parameter and buffer,
    or the graft raises), else random ones from seed 0."""
    from multimodal_similarity_tpu_torch import resolve_device
    from multimodal_similarity_tpu_torch.models.inception_resnet_v2 import (
        InceptionResNetV2)
    from multimodal_similarity_tpu_torch.models.inception_v1 import (
        InceptionV1)
    from multimodal_similarity_tpu_torch.models.slim_graft import (
        graft_slim_npz)
    towers = {"inception_resnet_v2": (InceptionResNetV2, 299,
                                      "InceptionResnetV2"),
              "inception_v1": (InceptionV1, 224, "InceptionV1")}
    if name not in towers:
        raise NotImplementedError(f"unknown slim backbone: {name}")
    cls, size, prefix = towers[name]
    device = resolve_device(device)
    if slim_checkpoint:
        # the graft overwrites every tensor: no random init to draw
        with torch.device("meta"):
            model = cls()
        model = graft_slim_npz(model.to_empty(device=device),
                               slim_checkpoint, prefix)
    else:
        model = cls(generator=torch.Generator().manual_seed(0)).to(device)
    return model.eval(), size


def slim_backbone(name: str = "inception_resnet_v2",
                  slim_checkpoint: Optional[str] = None,
                  image_size: Optional[int] = None,
                  batch_pad: bool = True,
                  pipeline_stages: int = 0,
                  pipeline_microbatch: int = 8,
                  frame_shape: Optional[tuple] = None,
                  device=None) -> Callable:
    """embed_fn running the port's slim-exact towers on ``device``; the
    counterpart of the JAX ``flax_backbone``.

    name: ``inception_resnet_v2`` -> NHWC [B, 8, 8, 1536] conv maps at
    299 input (the Honda ``resnet`` feature contract); ``inception_v1`` ->
    [B, 1024] pools at 224 (the CUB/Stanford40 contract).  ``batch_pad``
    pads a batch to the next power of two and drops the padded rows (eval
    mode: no row depends on another), so the convolutions see few batch
    sizes, as the JAX function buckets its compiles.

    ``pipeline_stages > 1`` stage-splits the Inception-ResNet-v2 trunk
    (parallel/pipeline.py) over that many visible cards (``device="cpu"``:
    that many CPU stages); frames enter at ``frame_shape`` (H, W) and the
    preprocessing runs in stage 0.
    """
    model, size = build_tower(name, slim_checkpoint, device)
    size = image_size or size
    dev = next(model.parameters()).device
    pre = make_preprocess(size)
    nhwc = name == "inception_resnet_v2"

    if pipeline_stages > 1:
        if not nhwc:
            raise NotImplementedError(
                "pipeline_stages requires the unit-segmented "
                "inception_resnet_v2 trunk")
        from multimodal_similarity_tpu_torch.models.inception_resnet_v2 \
            import N_PIPELINE_UNITS
        from multimodal_similarity_tpu_torch.parallel.pipeline import (
            INCEPTION_RESNET_V2_UNIT_COSTS, PipelinedBackbone)
        h, w = frame_shape or (size, size)
        pipe = PipelinedBackbone(
            model, n_units=N_PIPELINE_UNITS, input_shape=(h, w, 3),
            n_stages=pipeline_stages,
            devices=None if dev.type == "cuda" else [dev] * pipeline_stages,
            microbatch=pipeline_microbatch,
            unit_costs=INCEPTION_RESNET_V2_UNIT_COSTS, preprocess=pre,
            input_dtype=torch.uint8)

        def pipelined(batch: np.ndarray) -> np.ndarray:
            return np.ascontiguousarray(pipe(batch).transpose(0, 2, 3, 1))

        return pipelined

    def embed_fn(batch: np.ndarray) -> np.ndarray:
        with span("features.embed", unit=True):
            n = batch.shape[0]
            with span("features.pad"):
                if batch_pad:
                    m = 1
                    while m < n:
                        m *= 2
                    if m != n:
                        batch = np.concatenate(
                            [batch, np.zeros((m - n,) + batch.shape[1:],
                                             batch.dtype)])
                batch = np.ascontiguousarray(batch)
            with torch.inference_mode():
                with span("features.upload"):
                    x = torch.from_numpy(batch).to(dev)
                with span("features.resize"):
                    x = pre(x)
                with span("features.trunk"):
                    out = model(x)
                with span("features.readback"):
                    if nhwc:
                        out = out.permute(0, 2, 3, 1)
                    return out[:n].float().cpu().numpy()

    embed_fn.model = model
    return embed_fn


def text_features(phrases: Sequence[str],
                  word_vectors: Dict[str, np.ndarray],
                  counts: Optional[Sequence[int]] = None,
                  dim: int = 300,
                  noise: float = 0.01,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """word2vec-style text features for underscore-joined label phrases.

    Reference (Stanford40 side-track, feat_extract_ResNetV2.py:98-107):
    mean word vector over the phrase's in-vocabulary words, tiled per
    image with +/- noise/2 uniform jitter.  ``word_vectors`` is any
    word -> vector mapping (e.g. a loaded embedding table); words missing
    from it are skipped, and a phrase with no known words gets zeros.
    """
    rng = rng or np.random.RandomState(0)
    counts = counts if counts is not None else [1] * len(phrases)
    rows = []
    for phrase, count in zip(phrases, counts):
        vecs = [np.asarray(word_vectors[w], np.float32).reshape(-1)
                for w in phrase.split("_") if w in word_vectors]
        mean = (np.mean(vecs, axis=0) if vecs
                else np.zeros(dim, np.float32))
        tiled = np.tile(mean.reshape(1, -1), (count, 1))
        rows.append(tiled + (rng.rand(count, mean.shape[0]) - 0.5) * noise)
    return np.concatenate(rows, axis=0).astype(np.float32)


def torch_backbone(name: str = "inception_v3",
                   weights_path: Optional[str] = None, device=None):
    """embed_fn over the torchvision model ``name`` on ``device`` (``cuda``
    unless the caller asks for the CPU), its weights the ``torch.save``
    state dict at ``weights_path``: frames / 255, NCHW, the model's output
    as f32 numpy.  torchvision, an optional package, is imported here.
    The JAX package's ``torch_backbone`` asks torchvision for its
    ``"DEFAULT"`` weights, a download; the port downloads nothing, so a
    missing ``weights_path`` raises ValueError."""
    from multimodal_similarity_tpu_torch import resolve_device

    if weights_path is None:
        raise ValueError(
            f"--backbone {name}: pass --torch_weights, a local state dict "
            "of the torchvision model (no weights are downloaded)")
    device = resolve_device(device)
    import torchvision

    model = getattr(torchvision.models, name)(weights=None)
    model.load_state_dict(torch.load(weights_path, map_location="cpu"))
    model = model.to(device).eval()

    def embed_fn(batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2)
        with torch.no_grad():
            return model(x.float() / 255.0).float().cpu().numpy()

    return embed_fn


def extract_session_features(
    frame_dir: str,
    out_path: str,
    embed_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
    load_frames: Callable[[str], Iterable[np.ndarray]] = _load_frames,
) -> int:
    """Embed the frames of ``frame_dir`` (``load_frames``: its sorted
    ``frame_*.jpg``) ``batch_size`` at a time into one f32 .npy."""
    feats = []
    batch = []
    for frame in load_frames(frame_dir):
        batch.append(frame)
        if len(batch) == batch_size:
            feats.append(np.asarray(embed_fn(np.stack(batch))))
            batch = []
    if batch:
        feats.append(np.asarray(embed_fn(np.stack(batch))))
    if not feats:
        raise FileNotFoundError(
            f"no frame_*.jpg in {frame_dir!r} — did frame extraction "
            f"(preprocess.frames) run for this session?")
    out = np.concatenate(feats, axis=0).astype(np.float32)
    np.save(out_path, out)
    return out.shape[0]


def extract_sessions(session_ids: Sequence[str], frame_root: str,
                     feature_root: str, embed_fn, suffix: str = ".npy",
                     batch_size: int = 32,
                     load_frames: Callable = _load_frames) -> None:
    os.makedirs(feature_root, exist_ok=True)
    for session_id in session_ids:
        out_path = os.path.join(feature_root, session_id + suffix)
        if os.path.exists(out_path):
            continue
        try:
            n = extract_session_features(
                os.path.join(frame_root, session_id), out_path, embed_fn,
                batch_size, load_frames)
        except FileNotFoundError as e:
            # one frameless session shouldn't abort the batch run —
            # mirror frames.py's "no video for <session>, skipping"
            print(f"{session_id}: {e}; skipping")
            continue
        print(f"{session_id}: {n} frames embedded")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--frame_root", required=True)
    p.add_argument("--feature_root", required=True)
    p.add_argument("--session_file", required=True)
    p.add_argument("--backbone", default="inception_resnet_v2",
                   help="inception_resnet_v2 | inception_v1 | a "
                        "torchvision model name")
    p.add_argument("--slim_checkpoint", default=None,
                   help=".npz of slim variable names -> arrays")
    p.add_argument("--pipeline_stages", type=int, default=0,
                   help="stage-split the inception_resnet_v2 trunk over "
                        "this many cards (pipeline parallelism; 0/1 = "
                        "one device)")

    def _hxw(s):
        parts = s.lower().split("x")
        try:
            h, w = (int(v) for v in parts)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected HxW (e.g. 480x640), got {s!r}")
        return (h, w)

    p.add_argument("--frame_shape", type=_hxw, default=None,
                   help="native HxW of the stored frames, e.g. 480x640 "
                        "(the pipeline sizes its stages for one input "
                        "shape)")
    p.add_argument("--torch_weights", default=None,
                   help="state dict (torch.save) of a torchvision "
                        "--backbone")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    with open(args.session_file) as f:
        sessions = f.read().strip().split("\n")
    if args.backbone in ("inception_resnet_v2", "inception_v1"):
        embed_fn = slim_backbone(args.backbone, args.slim_checkpoint,
                                 pipeline_stages=args.pipeline_stages,
                                 frame_shape=args.frame_shape,
                                 device=args.device)
    else:
        embed_fn = torch_backbone(args.backbone, args.torch_weights,
                                  args.device)
    extract_sessions(sessions, args.frame_root, args.feature_root,
                     embed_fn)


if __name__ == "__main__":
    main(sys.argv[1:])
