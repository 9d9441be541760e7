"""Encoder embedders — port of pathway_tpu/xpacks/llm/embedders.py
``BaseEmbedder``, ``JaxEncoderEmbedder`` and ``ClipEmbedder``.

``EncoderEmbedder`` tokenizes on the host (HashTokenizer by default) and
runs the encoder (models/encoder.py) on the device, either padding each
batch to a width bucket or, with ``ragged``, packing documents back to
back into ``max_len``-wide sequences (``encode_ragged``). It is a batch
device UDF (``batch=True, deterministic=True``, device-bound): called on a
column expression, ``emb(pw.this.text)``, it builds the UDF expression the
engine runs once per tick over the whole column. Direct callers use
``embed_batch``. ``model=`` loads a local HuggingFace checkpoint (a name
in the local HF cache or a directory): weights, config and WordPiece
tokenizer through models/hf_loader.py.

With a profiler installed (engine/profiler.py), each forward records one
dispatch of its cost-model family: ``encoder_forward`` for a padded
forward, ``segment_attention`` for a ragged one, including one a replay
of the int8 index's graphed ingest step (ops/knn.py).

``ClipEmbedder`` embeds texts (the UDF itself) and images (its
``image()`` UDF) into one space with the CLIP dual encoder
(models/clip.py), so one index serves cross-modal retrieval.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device, upload
from pathway_tpu_torch.engine import device_sanitizer
from pathway_tpu_torch.engine.profiler import (current_profiler,
                                               encoder_cost,
                                               segment_attention_cost)
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.config import _env_int
from pathway_tpu_torch.models import clip as _clip
from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig, encode,
                                              encode_ragged,
                                              init_params_host)
from pathway_tpu_torch.models.tokenizer import HashTokenizer


class BaseEmbedder(udfs.UDF):
    """Embedder base: callable on a column; knows its output dimension."""

    def get_embedding_dimension(self, **kwargs) -> int:
        """Probe the dimension with one call."""
        result = self.func(".", **kwargs)
        if asyncio.iscoroutine(result):
            result = asyncio.run(result)
        arr = np.asarray(result)
        if arr.ndim == 2:  # batch embedder probed with a single item
            arr = arr[0]
        return int(arr.shape[0])


class EncoderEmbedder(BaseEmbedder):
    """Embedder over the port's encoder, a batch device UDF.

    ``params`` is a JAX-layout numpy tree (e.g. ``init_params_host``
    output or the JAX package's parameters fetched to the host); without
    it the weights are ``init_params_host(seed, config)``. ``model``, a
    model name or a checkpoint directory, loads params, config and
    tokenizer instead (``hf_loader.load_model``; offline). Runs on
    ``device`` ("cuda" unless the caller passes "cpu"): here ``device`` is
    the torch device, and the UDF is always device-bound
    (``device_bound``). ``ragged=None`` reads ``PATHWAY_RAGGED_ENCODER``
    (off unless 1/true/on/yes), as the JAX embedder does. Other keyword
    arguments go to :class:`udfs.UDF` (``max_batch_size``, ``batch`` and
    ``deterministic``, both True by default)."""

    _BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, *, model: str | None = None,
                 config: EncoderConfig | None = None,
                 params: dict | None = None, tokenizer=None, seed: int = 0,
                 max_len: int = 512, ragged: bool | None = None,
                 device: str | torch.device = "cuda", **kwargs):
        kwargs.setdefault("batch", True)
        kwargs.setdefault("deterministic", True)
        super().__init__(device=True, **kwargs)
        if model is not None:
            # the JAX embedder's name-based convenience: weights, config
            # and WordPiece vocabulary from a local checkpoint
            from pathway_tpu_torch.models.hf_loader import load_model

            params, config, tokenizer = load_model(model)
        if ragged is None:
            ragged = os.environ.get("PATHWAY_RAGGED_ENCODER", "0").lower() \
                in ("1", "true", "on", "yes")
        self.ragged = bool(ragged)
        self.device = resolve_device(device)
        self.config = config or EncoderConfig.bge_small()
        if params is None:
            params = init_params_host(seed, self.config)
        self.model = Encoder.from_params(params, self.config,
                                         device=self.device)
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=self.config.vocab_size, max_len=max_len)
        self.max_len = min(max_len, self.config.max_len)
        # packed ids: int16 when the vocab fits (BGE's 30522 does) — half
        # the host→device bytes of int32; the mask is rebuilt on device
        self._pack_ids = self.config.vocab_size <= 32767
        # ragged packing: sequences per dispatch, and documents per
        # sequence (W // 16: a document is never shorter than CLS + token
        # + SEP), which bounds a chunk's padded document count
        self._ragged_max_seqs = max(1, _env_int("PATHWAY_RAGGED_MAX_SEQS", 8))
        self._ragged_doc_cap = max(1, self.max_len // 16)
        # encoder forwards run (ingest and query), for launch accounting
        self.dispatches = 0
        # sharded workers share the embedder, and under
        # PATHWAY_WORKER_THREADS=1 the replicas of its map call it from
        # the pool's threads at once: one device call at a time
        self._device_lock = threading.RLock()

    def _bucket(self, n: int) -> int:
        """Pad target for a batch whose longest row has ``n`` tokens:
        multiples of 16 up to 64, then multiples of 32."""
        if n <= 64:
            b = max(16, -(-n // 16) * 16)
        else:
            b = -(-n // 32) * 32
        return min(b, self.max_len)

    def bucket_widths(self) -> list[int]:
        """Every padded width ``_bucket`` can produce for this ``max_len``."""
        widths: list[int] = []
        w = 16
        while w <= min(64, self.max_len):
            widths.append(w)
            w += 16
        w = 96
        while w < self.max_len:
            widths.append(w)
            w += 32
        if self.max_len not in widths:
            widths.append(self.max_len)
        return widths

    def pack_tokens(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize + bucket-pad, returning host ``(ids, lens)`` for
        :meth:`device_producer` — int16 ids when the vocab fits."""
        ids, mask = self.tokenizer.batch(
            [t or "." for t in texts], max_len=self.max_len)
        pad_to = self._bucket(ids.shape[1])
        if ids.shape[1] < pad_to:
            ids = np.pad(ids, ((0, 0), (0, pad_to - ids.shape[1])))
        else:
            ids, mask = ids[:, :pad_to], mask[:, :pad_to]
        lens = mask.sum(axis=1).astype(np.int32)
        return ids.astype(np.int16 if self._pack_ids else np.int32), lens

    def device_producer(self, model: Encoder, ids: np.ndarray,
                        lens: np.ndarray) -> torch.Tensor:
        """Forward over packed host tokens -> (B, hidden) f32 embeddings on
        the device. The arrays go up through pinned memory without a host
        wait (``_device.upload``: nothing kept per batch shape) and the
        mask is rebuilt on the device from ``lens``. The index's fused
        ingest (ops/knn.py) writes the result straight into its device
        extent."""
        prof = current_profiler()
        t0 = time.perf_counter() if prof is not None else 0.0
        ids_d = upload(torch.from_numpy(ids), self.device)
        lens_d = upload(torch.from_numpy(lens), self.device)
        mask = torch.arange(ids_d.shape[1], device=self.device)[None, :] \
            < lens_d[:, None]
        self.dispatches += 1
        out = encode(model, ids_d.long(), mask)
        if prof is not None:
            self.record_forward(prof, False, ids.shape,
                                (time.perf_counter() - t0) * 1e3)
        return out

    def record_forward(self, prof, ragged: bool, ids_shape: tuple,
                       wall_ms: float) -> None:
        """One forward over ``ids_shape`` = (sequences, width) token ids
        into ``prof``: ``segment_attention`` if ``ragged``, else
        ``encoder_forward``, costed at this embedder's config."""
        cfg = self.config
        b, s = (int(v) for v in ids_shape)
        cost = segment_attention_cost if ragged else encoder_cost
        flops, nbytes = cost(b, s, hidden=cfg.hidden,
                             intermediate=cfg.intermediate, layers=cfg.layers)
        prof.record_dispatch(
            "segment_attention" if ragged else "encoder_forward", flops,
            nbytes, wall_ms)

    def ragged_device_forward(self, model: Encoder, ids, doc_map, pos_ids,
                              doc_seq, doc_off) -> torch.Tensor:
        """The device half of the ragged producer: forward over one chunk
        already on the device (int32 tensors of :meth:`pack_ragged`'s
        shapes) -> (n_docs_padded, hidden) f32 embeddings. No host sync
        and no host data, so a CUDA graph can capture it (the int8 index's
        fused step, ops/knn.py)."""
        self.dispatches += 1
        return encode_ragged(model, ids.long(), doc_map, pos_ids.long(),
                             doc_seq, doc_off)

    def ragged_device_producer(self, model: Encoder, ids, doc_map, pos_ids,
                               doc_seq, doc_off) -> torch.Tensor:
        """Forward over one ragged-packed chunk (host arrays from
        :meth:`pack_ragged`) -> (n_docs_padded, hidden) f32 embeddings on
        the device: the arrays go up through pinned memory without a host
        wait (``_device.upload``), then :meth:`ragged_device_forward` runs
        eagerly. (The graphed ingest step stages its own fixed tensors,
        and records its forward itself.)"""
        prof = current_profiler()
        t0 = time.perf_counter() if prof is not None else 0.0
        out = self.ragged_device_forward(model, *(
            upload(torch.from_numpy(a), self.device)
            for a in (ids, doc_map, pos_ids, doc_seq, doc_off)))
        if prof is not None:
            self.record_forward(prof, True, ids.shape,
                                (time.perf_counter() - t0) * 1e3)
        return out

    def ragged_buckets(self) -> list[int]:
        """Sequence-count buckets the ragged path dispatches: powers of two
        up to the per-chunk cap (full chunks all share one shape)."""
        out, b = [], 1
        while b < self._ragged_max_seqs:
            out.append(b)
            b *= 2
        out.append(self._ragged_max_seqs)
        return out

    def pack_ragged(self, texts: list[str]) -> list[tuple]:
        """Greedy first-fit packing of tokenized documents into
        ``max_len``-wide sequences, chunked at ``_ragged_max_seqs``
        sequences per dispatch.

        Returns ``[(args, n_docs, n_docs_padded), ...]`` per chunk, docs in
        input order, where ``args = (ids, doc_map, pos_ids, doc_seq,
        doc_off)`` feed :meth:`ragged_device_producer` and
        ``n_docs_padded`` is its output row count (padding rows carry
        doc_map -1 and are dropped by the caller / the fused write).
        Document ids are local to a chunk."""
        ids, mask = self.tokenizer.batch(
            [t or "." for t in texts], max_len=self.max_len)
        lens = mask.sum(axis=1).astype(np.int64)
        W, cap = self.max_len, self._ragged_doc_cap
        # each document's (sequence, offset), first fit in input order
        seq_of = np.empty(len(texts), np.int64)
        off_of = np.empty(len(texts), np.int64)
        seq, fill, docs_in_seq = 0, 0, 0
        for d, n in enumerate(lens):
            n = int(n)
            if fill + n > W or docs_in_seq >= cap:
                seq, fill, docs_in_seq = seq + 1, 0, 0
            seq_of[d], off_of[d] = seq, fill
            fill += n
            docs_in_seq += 1
        n_seqs_total = seq + 1
        chunks: list[tuple] = []
        max_seqs = self._ragged_max_seqs
        buckets = self.ragged_buckets()
        d0 = 0
        for s0 in range(0, n_seqs_total, max_seqs):
            s1 = min(s0 + max_seqs, n_seqs_total)
            n_seqs = next(b for b in buckets if b >= s1 - s0)
            d1 = d0
            while d1 < len(texts) and seq_of[d1] < s1:
                d1 += 1
            n_docs = d1 - d0
            n_pad = n_seqs * cap
            c_ids = np.zeros((n_seqs, W), np.int32)
            c_map = np.full((n_seqs, W), -1, np.int32)
            c_pos = np.zeros((n_seqs, W), np.int32)
            c_dseq = np.zeros((n_pad,), np.int32)
            c_doff = np.zeros((n_pad,), np.int32)
            for j, d in enumerate(range(d0, d1)):
                n = int(lens[d])
                s, o = int(seq_of[d]) - s0, int(off_of[d])
                c_ids[s, o:o + n] = ids[d, :n]
                c_map[s, o:o + n] = j
                c_pos[s, o:o + n] = np.arange(n)
                c_dseq[j], c_doff[j] = s, o
            chunks.append(((c_ids, c_map, c_pos, c_dseq, c_doff),
                           n_docs, n_pad))
            d0 = d1
        return chunks

    def ragged_warmup_operands(self, n_seqs: int) -> tuple[tuple, int]:
        """A synthetic ragged chunk at bucket ``n_seqs`` with every padded
        document slot real (``cap`` documents of ``W // cap`` tokens per
        sequence): the dispatch shape, whatever the content."""
        W, cap = self.max_len, self._ragged_doc_cap
        tok = W // cap
        n_docs = n_seqs * cap
        ids = np.zeros((n_seqs, W), np.int32)
        doc_map = np.repeat(np.arange(n_docs, dtype=np.int32),
                            tok).reshape(n_seqs, cap * tok)
        if cap * tok < W:
            doc_map = np.pad(doc_map, ((0, 0), (0, W - cap * tok)),
                             constant_values=-1)
        pos = np.tile(np.arange(tok, dtype=np.int32), cap)[None, :]
        pos = np.pad(np.repeat(pos, n_seqs, 0),
                     ((0, 0), (0, W - cap * tok)))
        dseq = np.repeat(np.arange(n_seqs, dtype=np.int32), cap)
        doff = np.tile(np.arange(cap, dtype=np.int32) * tok, n_seqs)
        return (ids, doc_map, pos, dseq, doff), n_docs

    def encode_batch_device(self, texts: list[str]) -> torch.Tensor:
        """Tokenize + encoder forward, returning the (B, hidden) embeddings
        still on the device. The ragged path runs one forward per packed
        chunk and keeps each chunk's real documents."""
        with self._device_lock:
            return self._encode_batch_device(texts)

    def _encode_batch_device(self, texts: list[str]) -> torch.Tensor:
        if self.ragged:
            outs = [self.ragged_device_producer(self.model, *args)[:n_docs]
                    for args, n_docs, _n_pad in self.pack_ragged(texts)]
            return outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        ids, lens = self.pack_tokens(texts)
        return self.device_producer(self.model, ids, lens)

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        """(B, hidden) float32 embeddings as one host array (an explicit
        fetch: ``device_sanitizer.explicit_sync``)."""
        with self._device_lock:
            out = self._encode_batch_device(texts)
            with device_sanitizer.explicit_sync("embedder result"):
                return out.cpu().numpy()

    def __wrapped__(self, texts: list[str], **kwargs) -> list[np.ndarray]:
        """The batch UDF body: ONE device-to-host transfer for the whole
        column, then row views into it (ndarray iteration yields views,
        never copies)."""
        return list(self.embed_batch(list(texts)))

    def get_embedding_dimension(self, **kwargs) -> int:
        return int(self.config.hidden)


class ClipEmbedder(BaseEmbedder):
    """Multimodal embedder over the port's CLIP dual encoder, a batch
    device UDF like ``EncoderEmbedder``: called on a column it embeds
    texts; ``image()`` is a UDF embedding images (bytes, decoded by
    ``load_image``, or (H, W, C) float arrays in [0, 1]) into the same
    space. ``params`` is a JAX-layout numpy tree (the JAX package's
    ``init_clip_params`` fetched to the host, say); without it the
    weights are ``init_clip_params(seed, config)``. Runs on ``device``
    ("cuda" unless the caller passes "cpu")."""

    _BUCKETS = EncoderEmbedder._BUCKETS

    def __init__(self, *, config: _clip.ClipConfig | None = None,
                 params: dict | None = None, tokenizer=None, seed: int = 0,
                 device: str | torch.device = "cuda", **kwargs):
        kwargs.setdefault("batch", True)
        kwargs.setdefault("deterministic", True)
        super().__init__(device=True, **kwargs)
        self.device = resolve_device(device)
        self.config = config or _clip.ClipConfig()
        if params is None:
            params = _clip.init_clip_params(seed, self.config)
        self.model = _clip.ClipModel.from_params(params, self.config,
                                                 device=self.device)
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=self.config.text.vocab_size,
            max_len=self.config.text.max_len)
        # one device call at a time (see EncoderEmbedder._device_lock)
        self._device_lock = threading.Lock()

    @torch.no_grad()
    def embed_text_batch(self, texts: list[str]) -> np.ndarray:
        """(B, embed_dim) float32 text embeddings, each batch padded to
        the first of ``_BUCKETS`` that holds its longest row (the JAX
        embedder's widths)."""
        max_len = self.config.text.max_len
        ids, mask = self.tokenizer.batch(
            [t or "." for t in texts], max_len=max_len)
        pad_to = next((min(b, max_len) for b in self._BUCKETS
                       if ids.shape[1] <= b), max_len)
        if ids.shape[1] < pad_to:
            pad = ((0, 0), (0, pad_to - ids.shape[1]))
            ids, mask = np.pad(ids, pad), np.pad(mask, pad)
        else:
            ids, mask = ids[:, :pad_to], mask[:, :pad_to]
        dev = self.device
        with self._device_lock:
            out = _clip.encode_text(self.model,
                                    torch.from_numpy(ids).to(dev).long(),
                                    torch.from_numpy(mask).to(dev).bool())
            return out.cpu().numpy()

    @torch.no_grad()
    def embed_image_batch(self, images: list) -> np.ndarray:
        """(B, embed_dim) float32 image embeddings."""
        px = np.stack([
            _clip.load_image(im, config=self.config)
            if isinstance(im, bytes) else np.asarray(im, np.float32)
            for im in images
        ])
        with self._device_lock:
            out = _clip.encode_image(self.model,
                                     torch.from_numpy(px).to(self.device))
            return out.cpu().numpy()

    def __wrapped__(self, texts: list[str], **kwargs) -> list[np.ndarray]:
        # row views of the one batch transfer
        return list(self.embed_text_batch(list(texts)))

    def image(self) -> BaseEmbedder:
        """A batch device UDF embedding image bytes or arrays into the
        shared space."""
        outer = self

        class _ImageUDF(BaseEmbedder):
            def __init__(self):
                super().__init__(batch=True, deterministic=True,
                                 device=True)

            def __wrapped__(self, images: list, **kwargs):
                # row views of the one batch transfer
                return list(outer.embed_image_batch(list(images)))

            def get_embedding_dimension(self, **kwargs) -> int:
                return int(outer.config.embed_dim)

        return _ImageUDF()

    def get_embedding_dimension(self, **kwargs) -> int:
        return int(self.config.embed_dim)
