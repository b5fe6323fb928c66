"""Serving: embed events and query a retrieval gallery.

``EmbeddingService`` embeds requests with a trained encoder in eval mode,
``batch_size`` events a forward, f32 or (``int8=True``) quantized on the
host before the upload and dequantized on the device.  ``RetrievalIndex``
holds a gallery of embeddings, f32 or int8 rows, uploaded to the device
once per ``add()`` generation, and answers exact top-k queries.  An f32
gallery on a CUDA device at a euclidean metric and k <= 64 takes
``ops/chunked_topk.py``'s one kernel over the whole gallery; otherwise one
distance product and a top-k for a gallery of up to ``gallery_chunk`` rows,
the chunked walk of ``ops/chunked_topk.py`` beyond it, and always that walk
for an int8 gallery.  Indexes persist with ``save`` / ``load`` in the JAX
package's format (the same files, byte for byte), so an index written by
either package serves in the other.

Both classes run on ``cuda`` unless the caller passes ``device="cpu"``.
``RetrievalIndex(mesh=...)`` shards the gallery over a process mesh
(parallel/mesh.py, one process a device): the gallery is padded to a
multiple of the world size, each rank uploads only its own rows, and a
query merges every rank's candidates (parallel/sharded_eval.py), so every
rank returns the same answer.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch import resolve_device
from multimodal_similarity_tpu_torch.data.device_feed import (
    dequant_features, quantize_features)
from multimodal_similarity_tpu_torch.ops.chunked_topk import (
    chunked_topk, chunked_topk_quantized, ieee_f32, smallest_k)
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.kernels.topk import takes_kernel
from multimodal_similarity_tpu_torch.parallel.sharded_eval import (
    sharded_retrieval_topk, sharded_retrieval_topk_quantized)
from multimodal_similarity_tpu_torch.train.steps import (
    embed_in_chunks, make_embed_fn)
from multimodal_similarity_tpu_torch.utils.profiling import count, span


class EmbeddingService:
    """Eval-mode embedding of requests, ``batch_size`` events a forward.

    ``params``, when given, is a state dict loaded strictly into ``model``.
    ``int8=True`` quantizes each request on the host
    (``data/device_feed.quantize_features``) before the upload, a quarter
    of the f32 bytes on the wire, and dequantizes on the device as bf16 q *
    scale; ``embed_quantized`` takes a request quantized by the client.  A
    hot swap is ``svc.model.load_state_dict(new)``: both request paths read
    the module's weights at each call."""

    def __init__(self, model: nn.Module, params=None, batch_size: int = 256,
                 normalized: bool = True, int8: bool = False, device=None):
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.int8 = int8
        self._embed = make_embed_fn(self.model, normalized=normalized)

    def _no_rows(self, shape) -> np.ndarray:
        """(0, emb_dim) for a zero-row request: one probe forward reads the
        width."""
        probe = self._embed(torch.zeros((1,) + tuple(shape[1:]),
                                        device=self.device))
        return np.zeros((0, probe.shape[-1]), np.float32)

    def embed(self, events: np.ndarray) -> np.ndarray:
        if events.shape[0] == 0:
            return self._no_rows(events.shape)
        if self.int8:
            return self.embed_quantized(*quantize_features(events))
        return embed_in_chunks(self._embed, events, self.device,
                               chunk=self.batch_size).cpu().numpy()

    def embed_quantized(self, q, scale) -> np.ndarray:
        """Embed a request quantized by ``quantize_features`` (int8 ``q``
        and its f32 ``scale``, arrays or CPU tensors)."""
        if q.shape[0] == 0:
            return self._no_rows(q.shape)
        q, scale = torch.as_tensor(q), torch.as_tensor(scale)
        out = [self._embed(dequant_features({
            "q": q[i:i + self.batch_size].to(self.device),
            "scale": scale[i:i + self.batch_size].to(self.device)}))
            for i in range(0, q.shape[0], self.batch_size)]
        return torch.cat(out).cpu().numpy()


class RetrievalIndex:
    """Gallery of embeddings with exact top-k search, on one device or
    sharded over a process mesh (``mesh``, a parallel.ProcessMesh: each
    rank holds its contiguous block of the gallery, padded to a multiple
    of the world size, on the rank's device).

    ``int8_gallery=True`` keeps rows as int8 with a per-row max-abs scale
    (g = s * qg) and their exact squared norms: a quarter of the f32
    gallery's device memory and of each query's gallery read, at a
    quantization error of about 0.4% of a row's norm (Euclidean metrics
    only).  Adds accumulate host blocks, joined at the first query after
    them."""

    def __init__(self, emb_dim: int, metric: str = "euclidean",
                 mesh=None, gallery_chunk: int = 65536,
                 int8_gallery: bool = False, device=None):
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        if mesh is not None and self.device.type != mesh.device.type:
            raise ValueError(f"the mesh's collectives run on "
                             f"{mesh.device.type}; the index's device is "
                             f"{self.device}")
        self.emb_dim = emb_dim
        self.metric = metric
        self.int8_gallery = int8_gallery
        if int8_gallery and metric not in ("euclidean",
                                           "squaredeuclidean"):
            raise NotImplementedError(
                "int8_gallery supports euclidean metrics only")
        self.gallery_chunk = gallery_chunk
        self._blocks: List[np.ndarray] = []
        self._n = 0
        self._gallery: Optional[np.ndarray] = None
        # the device copy, uploaded once per add() generation: a query
        # never ships the gallery again
        self._device_gallery = None
        # int8 artifacts restored by load(): uploaded verbatim, the f32
        # gallery never materialized
        self._quant = None
        self._meta: list = []

    @staticmethod
    def _quantize_rows(gallery: np.ndarray):
        """Per-row max-abs int8 quantization and the exact quantized rows'
        squared norms, in NumPy as the JAX package computes them (the saved
        artifacts are the same bytes)."""
        amax = np.maximum(np.max(np.abs(gallery), axis=1, keepdims=True),
                          1e-12)
        scale = (amax / 127.0).astype(np.float32)
        qg = np.clip(np.rint(gallery / scale), -127, 127).astype(np.int8)
        gsq = ((scale.reshape(-1) ** 2) * np.sum(
            qg.astype(np.float32) ** 2, axis=1)).astype(np.float32)
        return qg, scale, gsq

    def add(self, embeddings: np.ndarray, metadata: Optional[Sequence] = None):
        embeddings = np.asarray(embeddings, np.float32)
        if metadata is not None and len(metadata) != embeddings.shape[0]:
            raise ValueError(
                f"metadata length {len(metadata)} != "
                f"{embeddings.shape[0]} embeddings — metadata would "
                f"silently misalign for every later row")
        if self._quant is not None:
            # extending a loaded int8 index: its rows dequantized become the
            # host gallery (re-quantization is per row, so they quantize to
            # the same bytes again)
            qg, scale, _ = self._quant
            self._blocks = [np.asarray(qg, np.float32)
                            * scale.reshape(-1, 1)]
            self._quant = None
        self._blocks.append(embeddings)
        self._n += embeddings.shape[0]
        self._gallery = None
        self._device_gallery = None
        self._meta.extend(metadata if metadata is not None
                          else [None] * embeddings.shape[0])

    def __len__(self) -> int:
        return self._n

    def _gallery_host(self) -> np.ndarray:
        if self._gallery is None:
            if not self._blocks and self._quant is not None:
                qg, scale, _ = self._quant
                self._blocks = [np.asarray(qg, np.float32)
                                * scale.reshape(-1, 1)]
            self._gallery = (self._blocks[0] if len(self._blocks) == 1
                             else np.concatenate(self._blocks))
            self._blocks = [self._gallery]
        return self._gallery

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the index to directory ``path`` (created if needed):
        ``manifest.json``, ``meta.pkl``, and ``gallery.npy`` (f32) or
        ``q.npy`` / ``scale.npy`` / ``gsq.npy`` (int8), the JAX package's
        layout.  Each file goes to a temporary name and is renamed over the
        old one, the manifest last: saving into the directory the index was
        loaded from never truncates a file a live mmap reads, and a crashed
        save leaves no manifest that ``load`` would accept."""
        if not len(self):
            raise ValueError("refusing to save an empty gallery")
        os.makedirs(path, exist_ok=True)
        manifest = {
            "format": "msim-retrieval-index", "version": 1,
            "n": int(len(self)), "emb_dim": int(self.emb_dim),
            "metric": self.metric, "int8_gallery": bool(self.int8_gallery),
            "gallery_chunk": int(self.gallery_chunk),
        }

        def save_npy(name, arr):
            tmp = os.path.join(path, name + ".tmp.npy")
            np.save(tmp, arr)
            os.replace(tmp, os.path.join(path, name + ".npy"))

        if self.int8_gallery:
            qg, scale, gsq = (self._quant if self._quant is not None
                              else self._quantize_rows(self._gallery_host()))
            save_npy("q", qg)
            save_npy("scale", np.asarray(scale).reshape(-1))
            save_npy("gsq", gsq)
        else:
            save_npy("gallery", self._gallery_host())
        tmp = os.path.join(path, "meta.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(self._meta, f)
        os.replace(tmp, os.path.join(path, "meta.pkl"))
        tmp = os.path.join(path, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, "manifest.json"))
        return path

    @classmethod
    def load(cls, path: str, mesh=None, gallery_chunk: Optional[int] = None,
             device=None) -> "RetrievalIndex":
        """An index saved by either package, its arrays opened as mmaps;
        it serves the saved instance's top-k without re-embedding (int8
        artifacts upload verbatim).  ``mesh`` shards it at load time, each
        rank reading only its own rows: an index saved on one device
        serves sharded, and the reverse."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != "msim-retrieval-index":
            raise ValueError(f"{path!r} is not a saved RetrievalIndex")
        self = cls(emb_dim=manifest["emb_dim"], metric=manifest["metric"],
                   mesh=mesh,
                   gallery_chunk=gallery_chunk or manifest["gallery_chunk"],
                   int8_gallery=manifest["int8_gallery"], device=device)
        if manifest["int8_gallery"]:
            self._quant = tuple(
                np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
                for name in ("q", "scale", "gsq"))
            self._n = int(self._quant[0].shape[0])
        else:
            gallery = np.load(os.path.join(path, "gallery.npy"),
                              mmap_mode="r")
            self._blocks = [gallery]
            self._n = int(gallery.shape[0])
        if self._n != manifest["n"]:
            raise ValueError(
                f"manifest n={manifest['n']} != stored rows {self._n}")
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            self._meta = pickle.load(f)
        return self

    def _upload(self, arr) -> torch.Tensor:
        # a writable host copy first: torch.from_numpy refuses load()'s
        # read-only mmaps, and a CPU index must not alias the caller's rows
        return torch.from_numpy(np.array(arr)).to(self.device)

    def _rank_rows(self, arr, fill) -> np.ndarray:
        """This rank's block of ``arr`` padded with rows of ``fill`` to a
        multiple of the world size: only the block's rows are read (a
        loaded mmap stays unread elsewhere)."""
        rows = self.mesh.rows(len(self) + (-len(self)) % self.mesh.size)
        real = np.asarray(arr[rows.start:min(rows.stop, len(self))])
        pad = (rows.stop - rows.start) - real.shape[0]
        if pad:
            real = np.concatenate(
                [real, np.full((pad,) + real.shape[1:], fill, real.dtype)])
        return real

    def _gallery_on_device(self):
        if self._device_gallery is None:
            if self.int8_gallery:
                qg, scale, gsq = (self._quant if self._quant is not None
                                  else self._quantize_rows(
                                      self._gallery_host()))
                scale = np.asarray(scale, np.float32).reshape(-1)
                gsq = np.asarray(gsq, np.float32)
                if self.mesh is not None:
                    # padding rows: zero rows of scale 1 whose squared norm
                    # 1e30 keeps them out of every local top-k
                    qg, scale, gsq = (self._rank_rows(qg, 0),
                                      self._rank_rows(scale, 1.0),
                                      self._rank_rows(gsq, 1e30))
                self._device_gallery = tuple(
                    self._upload(a) for a in (qg, scale, gsq))
            elif self.mesh is not None:
                self._device_gallery = self._upload(
                    self._rank_rows(self._gallery_host(), 1e15))
            else:
                self._device_gallery = self._upload(self._gallery_host())
        return self._device_gallery

    def _topk(self, q: torch.Tensor, k: int):
        """(dists [Q, k], indices [Q, k]) of the queries ``q`` on the
        device, left there."""
        gallery = self._gallery_on_device()
        if self.mesh is not None:
            if self.int8_gallery:
                qg, scale, gsq = gallery
                return sharded_retrieval_topk_quantized(
                    self.mesh, q, qg, scale, gsq, k=k, metric=self.metric,
                    chunk=min(self.gallery_chunk, max(4096, qg.shape[0])))
            return sharded_retrieval_topk(self.mesh, q, gallery, k=k,
                                          metric=self.metric,
                                          chunk=self.gallery_chunk)
        if self.int8_gallery:
            qg, scale, gsq = gallery
            return chunked_topk_quantized(
                q, qg, scale, gsq, k=k,
                chunk=min(self.gallery_chunk, max(4096, len(self))),
                metric=self.metric)
        if len(self) > self.gallery_chunk or takes_kernel(q, self.metric,
                                                          k):
            return chunked_topk(q, gallery, k=k, chunk=self.gallery_chunk,
                                metric=self.metric)
        count("topk.walk")
        with ieee_f32(), span("topk.product"):
            d = pairwise_distance(q, gallery, self.metric)
        with span("topk.select"):
            return smallest_k(d, k)

    def query(self, queries: np.ndarray, k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray, list]:
        """-> (dists [Q, k], indices [Q, k], metadata nested list),
        ascending, the lowest gallery index first among equal distances; k
        is clamped to the gallery's size.  A single 1-D query vector is
        taken as Q=1.  On a mesh every rank must query, with the same
        queries, and every rank gets the same answer; a padding row's
        index (never returned while k is clamped) would map to None."""
        if not len(self):
            raise ValueError("empty gallery")
        with span("serving.query", unit=True):
            queries = np.asarray(queries, np.float32)
            if queries.ndim == 1:
                queries = queries[None, :]
            with span("serving.upload"):
                q = self._upload(queries)
            d, idx = self._topk(q, min(k, len(self)))
            with span("serving.readback"):
                d = d.cpu().numpy()
                idx = idx.cpu().numpy()
            with span("serving.meta"):
                meta = [[self._meta[j] if j < len(self._meta) else None
                         for j in row] for row in idx]
        return d, idx, meta
