#!/usr/bin/env python3
"""Smoke run of pathway_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--docs N] [--seed S]

Drives the port's two live-RAG device paths, the engine's batch path
with the encoder as a batch UDF, the engine's index path (the graph of
bench.py's bench_embed_framework) and the served path (``pw.run``'s
streaming runtime behind HTTP: bench.py's bench_serving graph and a live
RAG server), at BGE-small's full width with random weights from a seed,
and checks every kernel of those paths against its plain PyTorch version
on the card. Phases (each failure exits
non-zero, and no result line is printed):

1. device: CUDA version, card name and capability (9, 0 required), the
   card's name and power limit as nvidia-smi reports them;
2. build: every kernel source compiled from this checkout (one nvcc per
   source, all started together), with the build time, registers and
   spills (ptxas), and a count of tensor-core instructions in the bf16
   kernels (cuobjdump);
3. K1 (the encoder attention kernel) against ``attention_reference`` on
   the card: bf16 at the ingest shape, at S=512 and at the edges of its
   tensor-core tiling (S=16, S=100, S=1000, S=1024, D=40, D=128), f32,
   batch rows with every key masked; times of the kernel, the plain
   version and PyTorch's scaled_dot_product_attention at the main-path
   shape and at B=64 S=512, beside the bound;
4. K1 with segment ids against ``segment_attention_reference``: chunks of
   ``pack_ragged`` at B=8 S=512, ``ragged_warmup_operands(8)``, one
   document per row, padding rows (against mean(V)), S=96 and S=1000, bf16
   and f32; time at B=8 S=512 beside SDPA with the same boolean mask;
5. K4 (quantizing scatter) bit for bit against its plain version, with
   zero rows, exact halves and sentinel slots that must leave the extent
   untouched, on its vector body (D in {64, 100, 384}, row stride D or D +
   4) and its scalar body (row stride D + 1, D = 1041); its time at path
   2's write as a graph of K4 alone, replayed, and launched eagerly; the
   bulk write of 65,536 rows beside its bound and the scalar body; K3's
   score (``score_i8``, on K3 top-k's mainloop with a store epilogue
   writing each score's 64-bit key) against the keys of its plain version's
   scores: random codes within 1e-5 x max|score| and
   exact-arithmetic rows with ties bit for bit (N in {10, 4097, 2^19}, B
   in {1, 7, 33, 64, 65}, D = 384, 200, 1041); the route past K_MAX
   (``search_extent``: ``score_i8`` per chunk + the key selection) on
   exact rows with ties across chunks, k in ROUTE_KS, equal to the plain
   scan + stable sort; times over the 10M indexes' 10,485,760 x 384 int8
   rows beside the bound, torch.matmul of a bf16 copy per chunk, the
   stable sort it replaced and the route now, at k=80;
6. K3 top-k (``topk_i8``, the score fused with the top-k) against
   ``topk_i8_reference``: cos and l2sq, B in {1, 7, 9, 32, 64, 65}, N in
   {10, 4097, 100352, 10M}, k in {1, 10, 64}, random rows with invalid
   rows and an extent with none valid (within 1e-5 x max|score|, -inf
   ranks and their rows exact), and exact-arithmetic rows with ties (l2sq,
   small codes, power-of-two scales, integer queries: scores and rows
   equal); times over 10M x 384 rows at B=1 and B=64, k=10, beside the
   bound, the old route (``score_i8`` + a stable sort per chunk + the
   merge) and torch.matmul + torch.topk per chunk;
7. K2 (``topk_bf16``, the bf16 score fused with the top-k) against
   ``topk_bf16_reference``: cos and l2sq, B in {1, 7, 64, 65}, N in {10,
   4097, 100352, 10,485,760}, k in {1, 10, 64}, random rows with invalid
   rows and an extent with none valid (as K3's), and exact-arithmetic
   rows with ties (+-1 on 4 or 16 columns, integer queries: scores and
   rows equal); times over the 10M index's 10,485,760 x 384 rows at B=1
   and B=64, k=10, beside the bound, the old route (torch.matmul + a
   stable sort per chunk + the merge) and torch.matmul + torch.topk per
   chunk. Then K2's score twin (``score_bf16``) as phase 5 holds K3's
   score (D = 384 and 200, cos and l2sq exact), the route past K_MAX on
   exact rows (cos and l2sq), and its times beside the bound, torch.matmul
   per chunk, the route before it (score_float_reference + a stable sort
   per chunk) and the route now, at k=80;
8. path 1: ``DeviceEmbeddingKnnIndex(EncoderEmbedder(bge_small),
   BruteForceKnnIndex(384, bf16 paged))`` ingests ``--docs`` synthetic
   documents in batches of 512 through the fused path, then answers 64
   single-query text searches (32 copies of ingested documents, 32 fresh
   texts) and one search with limit 20 and a filter (fetch 80: K2's score
   twin). Checks: the launch count of K1 equals 12 x the encoder
   dispatches of that run, K2's equals the searches x extents, K2 score's
   1, every query's top 10 (and the filtered top 20) against a
   brute-force scan of the same rows on the card, every copy finding its
   document, ``search_extent`` at k in ROUTE_KS against the plain scan +
   stable sort, and card-vs-CPU embeddings; times K2 at the index's shape
   at B=1 and B=64 beside the old route;
9. engine (the engine's batch path): the same documents as
   ``table_from_rows(..., is_stream=True)``, one tick per 512 (196
   ticks), through ``select(embedding=emb(pw.this.data))`` under
   ``GraphRunner.run_batch(n_workers=1)`` with the padded embedder as a
   batch device UDF (its map runs on the device bridge at the default
   window, 2), every bucket width warmed first; then the same
   documents through ``embed_batch`` in the same batches; engine, direct,
   direct, engine. Checks: every document once, diff +1, at its tick's
   time, under its ``hash_values_uncached("row", i, doc)`` key, its
   embedding equal to the direct call's bit for bit (both engine runs);
   K1 launches = 12 x encoder dispatches = 12 x 196 in the counted run and
   no other kernel. Then the ragged embedder over the first 10,240
   documents (20 ticks) the same way (its K1 launches are K1 with segment
   ids). Prints engine and direct docs/s, their ratio, the engine's wall
   a tick outside the UDF body, the garbage collector's time, peak device
   memory and the bridge's window and counters;
10. framework (bench.py's ``bench_embed_framework`` graph, as bench.py
   runs it): the same documents as ``table_from_rows(data,
   _metadata=Json({"path": ...}), is_stream=True)``, one tick per 2048
   (bench.py's BATCH), through ``VectorStoreServer(docs, embedder=emb,
   index_builder=... default_brute_force_knn_document_index(chunks.text,
   chunks, ...))`` and ``retrieve_query`` under
   ``GraphRunner.run_batch(n_workers=1)`` (DataIndex.query_as_of_now over
   the external index operator: the index embeds text itself), with
   queries at time 0, at the middle tick (copies of ingested and of later
   documents) and after the last tick (copies, fresh texts and one k =
   80). The embedder is bench's (bench.py:1266-1276): WordPiece over
   ``make_synthetic_vocab`` with the native C++ engine (asserted), BGE-small
   weights from the seed; each run first warms through the built index as
   bench.py:1160-1198 does, then times ``run_batch`` and the index's
   ``drain()`` with the device bridge at its default window (2).
   Configuration A the padded embedder (max_len 128) into a bf16 cos index
   (K1, K2, K2's score twin), B the ragged embedder (sequences of 512)
   into an int8 cos index (K1 with segment ids, K4 in each chunk's graph
   replay, K3 top-k, K3 score); bridged, direct ``add_batch``, direct,
   bridged, then window 1, then the embedder's default HashTokenizer at
   window 1 beside its own direct run. Checks, for every engine run: every reply equal to
   a plain scan on the card of the rows present at its query's time,
   copies find their document first when ingested and never before, texts
   and metadata the documents', the query embeddings the engine passed to
   the index against the plain encoder (``attention_reference``), the
   engine-built index equal bit for bit to the direct one with the same
   tokenizer, the launches inside ``run_batch`` equal to the counts the
   code gives (stated before the runs), no CUDA graph captured inside any
   timed window, and legs on the bridge in the bridged runs. Prints
   bench.py's keys (``framework_docs_per_s``,
   ``framework_device_inflight``, ``framework_bridge_legs``,
   ``framework_bridge_overlap_ratio``, ``framework_bridge_queue_wait_ms``),
   the window-1 and HashTokenizer docs/s, the direct docs/s, host ms a
   tick by leg (calling thread and bridge worker), the host's waits in
   ``submit`` and ``barrier``, host time by operator, the garbage
   collector's time and peak device memory;
11. serving (the served path, ``pw.run``'s streaming runtime, with the
   flight recorder's request tracker on): graph A, bench.py's
   ``bench_serving`` graph as it builds it (bench.py:1280-1453): an
   ``IngestSubject`` pushes 100,000 vectors of 384 f32 and then trickles
   64 every 20 ms into a bf16 cos index (165,536 rows reserved) while 8
   warm-up and 48 timed ``POST /query`` (k=10) go through a
   ``rest_connector`` and ``query_as_of_now`` (K2 every query tick);
   bench.py's keys (``knn_p50_e2e_ms`` and its p95/p99,
   ``serving_client_p50_ms``, ``serving_ingested_rows``, ``serving_slo_*``,
   the six ``serving_stage_*_p50_ms``) under bench.py's names, with every
   reply's 10 matches, every span's stages summing to its e2e, the rows
   ingested, K2's launches and no CUDA graph captured in the timed window
   held. Graph B, a live RAG server: ``VectorStoreServer(...).
   run_server(threaded=True)`` with framework A's embedder and bf16 index
   over 100,000 ``make_docs`` documents from a ``ConnectorSubject`` and a
   trickle of 64 every 20 ms, warmed through the built index; 8 warm-up
   and 48 timed ``/v1/retrieve`` (k=3), then the trickle paused and 8 held
   retrieves and one k=80 held against a plain scan of the index's rows
   with the plain encoder's query embedding, ``/v1/statistics``
   (file_count = documents pushed), ``/v1/inputs`` and
   ``VectorStoreClient`` against the raw POST; retrieve latencies, the
   tracker's stages, ingest docs/s, launches (K1, K2, K2 score) and peak
   memory. Both runs stop through ``stop_all()``, and an error in a run
   fails the phase;
12. array_sum (``GroupByOperator``'s device segment sum, off by default):
   ``device_segsum`` on the card bit for bit against the sequential numpy
   loop; then ``groupby(g).reduce(g, a=npsum(v))`` over two ticks of each
   ARRAY_SUM_CASES shape (D 384 or 64; 512 to 32,768 rows a tick; one
   group to one a row, and a skewed tick) with the route forced on and
   off (device, host, host, device) and under ``_segsum_pays``: events bit
   for bit equal, ``device_segsum`` called as the route says; prints the
   operator's host ms a tick, the route's pre-pass and the per-row adds
   it replaces;
13. path 2: the same 100,000 documents and 64 queries through the ragged
   embedder into ``BruteForceKnnIndex(384, dtype="int8", metric="cos")``
   (each ingest chunk one replay of a CUDA graph of the fused step: K1 with
   segment ids, K4; K3 top-k in the search), and one search with limit 20
   and a filter, whose fetch of 80 rows takes K3's score and the key
   selection. Checks: graph replays = ingest chunks, graphs captured <=
   chunk shapes x extents, K1 launches = 12 x encoder dispatches, K4 =
   ingest chunks, K3 top-k = 65 searches, K3 score = 1, the index equal
   bit for bit to one the step's eager body builds from the same
   documents, every top 10 (and the top 20) against a plain scan of the
   same int8 rows, every copy found, ragged vs padded embeddings,
   ``search_extent`` at k in ROUTE_KS against the plain scan + stable
   sort; then a chunk's replay time beside the eager step's and the
   device's busy share over four ingest batches (torch.profiler);
14. an int8 index of 1,000,000 random rows fed by ``add_batch_device`` (K4
   on the flush path, K3 top-k in the search): query times at B=1 and
   B=64, every top 10 against the plain scan;
15. bench_knn's bf16 deployment (bench.py:3436-3490): 10,000,000 x 384
   uniform bf16 rows, cos, made on the card in 2^19-row seeded chunks and
   fed by ``add_batch_device``, searched with bench_knn's 64 queries at
   B=1 (64 calls) and B=64, k=10, then ``latency_probe`` as bench.py calls
   it (knn_p50_ms, knn_batch64_ms): add time, p50s and probe times, every
   top 10 against the plain scan, B=64 equal to the B=1 searches, K2
   launches = searches x extents, K2 score launches 0. Then the filtered
   search (limit 20, a filter every row passes: fetch 80 through the
   route past K_MAX) at B=1 and B=64 with the same checks on its top 20,
   K2 score launches = searches x 20 chunks and K2 none; the route at k in
   ROUTE_KS against the plain scan + stable sort, and its times beside a
   stable sort per chunk of the same scores at B=1 and 64, k in
   SELECT_KS;
16. bench_knn's int8 deployment (bench.py:2547-2579), after the bf16
   index is freed: the same rows (each chunk made again from its seed)
   into an int8 cos index, searched, probed (knn_int8_p50_ms,
   knn_int8_batch64_ms) and checked as phase 15 with K3 top-k and K3
   score; bench.py's knn_int8_overlap10_vs_bf16, the mean overlap of the
   first 8 queries' top-10 with the bf16 index's;
17. profile: torch.profiler over three encoder forwards of each path's
   dispatch, device time by kernel group (K1, GEMM, other) and the
   device's busy share.

The second-to-last line is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate and HBM
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
INGEST_BATCH = 512
N_LAYERS = 12
RAGGED_DOCS = 100_000  # path 2's documents, never cut
K3_ROWS = 10_000_000   # the README's 10M x 384 deployment
K2_ROWS = 10_485_760   # planned_capacity(10M): the 10M index's one extent
# k of the route past K_MAX that the phases check, and the fetches at which
# they time it (a filtered limit 20, 80 and 320 escalated)
ROUTE_KS = (65, 320, 1280)
SELECT_KS = (80, 320, 1280)
WORDS_PER_DOC = 90  # bench.py make_docs: 90 words + CLS/SEP -> bucket 96


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def make_docs(n: int, seed: int = 0) -> list[str]:
    """bench.py make_docs: n documents of 90 words drawn from a 4096-word
    vocabulary."""
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(4096)]
    idx = rng.integers(0, len(vocab), size=(n, WORDS_PER_DOC))
    return [" ".join(vocab[j] for j in row) for row in idx]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} capability {cap} count "
          f"{torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    if cap != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a (H100)")
    return name, card


# K1's kernels: the bf16 tensor-core kernels (S <= 128 and S > 128) and
# the f32 FMA kernel, by the names nvcc, cuobjdump and the profiler show
K1_BF16 = ("attention_mma_resident", "attention_mma_streamed")
K1_KERNELS = K1_BF16 + ("attention_fma_kernel",)


def ptxas_report(log: str) -> dict:
    """ptxas -v lines -> {mangled function: (registers, spill store bytes)}"""
    out, fn, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], 0
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and fn:
            out[fn] = (int(line.split("Used")[1].split()[0]), spill)
    return out


def sass_mma_counts(lib_path: str) -> dict:
    """cuobjdump -sass of the built library -> {function: number of
    tensor-core (HMMA/HGMMA) instructions}"""
    from pathway_tpu_torch.ops.cuda_build import cuda_tool

    proc = subprocess.run([cuda_tool("cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr.strip()[:500]}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn_kernels import KNN_BF16, KNN_I8

    libs = [ATTENTION, KNN_I8, KNN_BF16]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        list(pool.map(lambda lib: lib.load(), libs))
    print(f"[build] {len(libs)} kernel source(s) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # K3 (score and top-k) and K2 (top-k and score) multiply on the tensor
    # cores too
    for lib, kernels in ((KNN_I8, ("knn_score_i8_kernel",
                                   "knn_topk_i8_kernel")),
                         (KNN_BF16, ("knn_topk_bf16_kernel",
                                     "knn_score_bf16_kernel"))):
        for fn, (regs, spill) in sorted(ptxas_report(lib.build_log).items()):
            print(f"[build] ptxas {fn}: {regs} registers, {spill} bytes "
                  "spill stores", flush=True)
        counts = sass_mma_counts(lib.path())
        for kernel in kernels:
            fns = {f: c for f, c in counts.items() if kernel in f}
            for f, c in sorted(fns.items()):
                print(f"[build] SASS {f}: {c} HMMA/HGMMA instructions",
                      flush=True)
            if not fns or 0 in fns.values():
                fail(f"{kernel} has no tensor-core instruction")
    # ptxas -v: registers and spills per instantiation; D = 64 is the
    # encoder's head dim (mangled template argument Li64E)
    report = ptxas_report(ATTENTION.build_log)
    if not report:
        fail("no ptxas -v report in the build log")
    for fn, (regs, spill) in sorted(report.items()):
        if "Li64E" in fn and any(k in fn for k in K1_KERNELS):
            print(f"[build] ptxas {fn}: {regs} registers, {spill} bytes "
                  "spill stores", flush=True)
    print(f"[build] ptxas over all {len(report)} instantiations: max "
          f"{max(r for r, _ in report.values())} registers, max "
          f"{max(s for _, s in report.values())} bytes spill stores",
          flush=True)
    # the bf16 kernels must multiply on the tensor cores
    counts = sass_mma_counts(ATTENTION.path())
    for name in K1_BF16:
        fns = [f for f in counts if name in f and "Li64E" in f]
        if not fns:
            fail(f"cuobjdump found no {name} instantiation for D=64")
        for f in fns:
            print(f"[build] SASS {f}: {counts[f]} HMMA/HGMMA instructions",
                  flush=True)
            if counts[f] == 0:
                fail(f"{f} has no tensor-core instruction")


def phase_attention(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.engine.profiler import attention_cost
    from pathway_tpu_torch.ops.attention import (ATTENTION,
                                                 attention_reference,
                                                 flash_attention)

    gen = torch.Generator(device="cuda").manual_seed(0)
    H = 6

    def inputs(B, S, D, dtype, mask_kind):
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        if mask_kind == "random":
            mask = torch.rand((B, S), generator=gen, device="cuda") > 0.3
        else:  # prefix masks, as padded token batches have
            lens = torch.randint(1, S + 1, (B,), generator=gen,
                                 device="cuda")
            mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        if mask_kind == "row_fully_masked":
            mask[0] = False
        return q, k, v, mask.contiguous()

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, B, S, D, dtype, mask, tolerance)
        ("bf16 B=64 S=96 random mask", 64, 96, 64, bf16, "random", 2e-2),
        ("bf16 B=512 S=96 prefix masks (ingest shape)", 512, 96, 64, bf16,
         "prefix", 2e-2),
        ("bf16 B=64 S=512 random mask", 64, 512, 64, bf16, "random", 2e-2),
        ("f32 B=64 S=128 random mask", 64, 128, 64, f32, "random", 1e-4),
        ("bf16 B=8 S=96 row 0 fully masked", 8, 96, 64, bf16,
         "row_fully_masked", 2e-2),
        # edges of the tensor-core tiling
        ("bf16 B=1 S=16 (smallest query bucket)", 1, 16, 64, bf16, "prefix",
         2e-2),
        ("bf16 B=1 S=96 (one query)", 1, 96, 64, bf16, "prefix", 2e-2),
        ("bf16 B=8 S=100 row 0 fully masked (partial last key chunk)", 8,
         100, 64, bf16, "row_fully_masked", 2e-2),
        ("bf16 B=8 S=1000 row 0 fully masked (long S, partial tile)", 8,
         1000, 64, bf16, "row_fully_masked", 2e-2),
        ("bf16 B=4 S=1024 random mask (longest S)", 4, 1024, 64, bf16,
         "random", 2e-2),
        ("bf16 B=16 S=96 D=40 random mask (head dim padded to 48)", 16, 96,
         40, bf16, "random", 2e-2),
        ("bf16 B=16 S=96 D=128 random mask (widest head dim)", 16, 96, 128,
         bf16, "random", 2e-2),
        ("f32 B=2 S=1000 row 0 fully masked", 2, 1000, 64, f32,
         "row_fully_masked", 1e-4),
    ]
    main_err = None
    for label, B, S, D, dtype, mk, tol in cases:
        q, k, v, mask = inputs(B, S, D, dtype, mk)
        got = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention_reference(q, k, v, mask)
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        finite = bool(torch.isfinite(got.float()).all())
        print(f"[K1] {label}: max_abs_err {err:.3e} (tolerance {tol:g}), "
              f"mean_abs_err {float(diff.mean()):.3e}, outputs differing "
              f"{float((diff > 0).float().mean()):.2e}", flush=True)
        if not finite or not err <= tol:
            fail(f"K1 {label}: max_abs_err {err} > {tol} or non-finite")
        if mk == "row_fully_masked":
            mean_v = v[0].float().mean(dim=0, keepdim=True)
            merr = float((got[0].float() - mean_v).abs().max())
            print(f"[K1] fully masked row vs mean(V): max_abs_err "
                  f"{merr:.3e} (tolerance {tol:g})", flush=True)
            if not merr <= tol:
                fail(f"K1 fully masked row: {merr} > {tol}")
        if S == 96 and B == INGEST_BATCH:
            main_err = err

    # the FMA design this kernel replaced measured 3.906e-3 (2^-8) at the
    # ingest shape; the tensor-core kernel rounds P where it did, so it
    # stays within 2x (one bf16 step of an output in [1, 2))
    if main_err is None or main_err > 2 * 2**-8:
        fail(f"K1 bf16 error at the ingest shape {main_err} > 2 * 2^-8")

    def timed(B, S, D=64):
        """The kernel, its plain version, and one PyTorch call computing
        the same function (yardstick only) at one bf16 shape, D = 64."""
        q, k, v, mask = inputs(B, S, D, bf16, "prefix")
        launches_before = ATTENTION.launches
        ms = cuda_ms(lambda: flash_attention(q, k, v, mask), 50)
        plain_ms = cuda_ms(lambda: attention_reference(q, k, v, mask), 10)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        amask = mask[:, None, None, :]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask), 50)
        ATTENTION.launches = launches_before  # comparisons don't count
        flops, nbytes = attention_cost(B, S, H, D, itemsize=2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[K1] B={B} S={S} H={H} D={D} bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), share of bound "
              f"{bound_ms / ms:.3f} [{card}]", flush=True)
        return ms, plain_ms, library_ms, bound_ms, bound_by

    # the main-path (ingest) shape, then a long-S shape
    ms, plain_ms, library_ms, bound_ms, bound_by = timed(INGEST_BATCH, 96)
    timed(64, 512)
    return {"name": "attention", "route": "cuda",
            "source": "pathway_tpu_torch/ops/csrc/attention.cu",
            "replaces": "pathway_tpu/ops/attention.py:33",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": library_ms}


def phase_segments(card: str) -> dict:
    """K1 with segment ids (the ragged path's attention) against
    ``segment_attention_reference`` on the card, then its time at the
    ragged dispatch shape B=8 S=512."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.engine.profiler import attention_cost
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.ops.attention import (ATTENTION, flash_attention,
                                                 segment_attention_reference)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    gen = torch.Generator(device="cuda").manual_seed(1)
    H, D = 6, 64
    emb = EncoderEmbedder(config=EncoderConfig.bge_small(), ragged=True,
                          device="cuda")
    chunks = emb.pack_ragged(make_docs(12 * 40 + 12, seed=3))
    full = chunks[0][0][1]                # 8 x 512, ~5 documents a row
    tail = chunks[-1][0][1]               # 12 docs: 3 rows + 1 padding row
    warm = emb.ragged_warmup_operands(8)[0][1]
    single = np.full((4, 512), -1, np.int32)
    single[:, :300] = 0                   # one document, then padding
    s96 = np.full((4, 96), -1, np.int32)
    s96[:, :40], s96[:, 40:90] = 0, 1
    s96[3] = -1
    s1000 = np.repeat(np.arange(10, dtype=np.int32), 95)[None].repeat(2, 0)
    s1000 = np.pad(s1000, ((0, 0), (0, 50)), constant_values=-1)
    docs_a_row = len(np.unique(full[full >= 0])) / full.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    tol16 = 2 * 2**-8  # as the dense checks at the ingest shape
    cases = [  # (label, seg, dtype, tolerance)
        (f"pack_ragged chunk B=8 S=512 ({docs_a_row:.1f} docs a row)", full,
         bf16, tol16),
        ("pack_ragged chunk B=8 S=512", full, f32, 1e-4),
        ("ragged_warmup_operands(8) B=8 S=512", warm, bf16, tol16),
        ("last chunk B=4 S=512 with a padding row", tail, bf16, tol16),
        ("last chunk B=4 S=512 with a padding row", tail, f32, 1e-4),
        ("one document a row B=4 S=512", single, bf16, tol16),
        ("S=96, a padding row", s96, bf16, tol16),
        ("S=1000, 10 documents a row", s1000, bf16, tol16),
        ("S=1000, 10 documents a row", s1000, f32, 1e-4),
    ]
    errs = []
    for label, seg_np, dtype, tol in cases:
        B, S = seg_np.shape
        seg = torch.from_numpy(np.ascontiguousarray(seg_np)).cuda()
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        got = flash_attention(q, k, v, seg >= 0, seg)
        torch.cuda.synchronize()
        ref = segment_attention_reference(q, k, v, seg)
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        pad_err = 0.0
        rows = (seg < 0).nonzero().tolist()
        for b, i in rows:  # padding rows average V over all S rows
            pad_err = max(pad_err, float((got[b, i].float() - v[b].float()
                                          .mean(dim=0)).abs().max()))
        print(f"[K1 seg] {label} {str(dtype)[6:]}: max_abs_err {err:.3e}, "
              f"mean_abs_err {float(diff.mean()):.3e} (tolerance {tol:g}); "
              f"{len(rows)} padding rows vs mean(V): {pad_err:.3e}",
              flush=True)
        if not bool(torch.isfinite(got.float()).all()) or not err <= tol \
                or not pad_err <= tol:
            fail(f"K1 with segments, {label}: {err} / {pad_err} > {tol}")
        errs.append(err)

    # time at the ragged dispatch shape (bf16, the pack_ragged chunk)
    seg = torch.from_numpy(full).cuda()
    B, S = seg.shape
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               .to(bf16) for _ in range(3))
    mask = seg >= 0
    launches_before = ATTENTION.launches
    ms = cuda_ms(lambda: flash_attention(q, k, v, mask, seg), 50)
    plain_ms = cuda_ms(lambda: segment_attention_reference(q, k, v, seg), 10)
    same = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=same[:, None]), 50)
    ATTENTION.launches = launches_before  # comparisons don't count
    flops, nbytes = attention_cost(B, S, H, D, itemsize=2)
    nbytes += 3 * B * S  # int32 segment ids in place of the byte mask
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[K1 seg] B={B} S={S} H={H} D={D} bf16 with segment ids: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (boolean (B, 1, S, S)"
          f" mask) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by};"
          f" {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), share of "
          f"bound {bound_ms / ms:.3f} [{card}]", flush=True)
    return {"name": "attention (segment ids)", "route": "cuda",
            "source": "pathway_tpu_torch/ops/csrc/attention.cu",
            "replaces": "pathway_tpu/ops/attention.py:33",
            "max_abs_err": errs[0], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": library_ms}


def hard_rows(n: int, dim: int, gen) -> "torch.Tensor":
    """Normal f32 rows on the card with the quantizer's edge cases: zero
    rows, rows of exact halves (v / scale = k + 1/2, which must round to
    even), a row whose largest magnitude is negative, tiny rows."""
    import torch

    v = torch.randn((n, dim), generator=gen, device="cuda")
    v[0] = 0.0
    v[n // 2] = 0.0
    s = 2.0**-3
    half = (torch.arange(dim, device="cuda") % 40 + 0.5) * s
    v[1] = torch.where(torch.arange(dim, device="cuda") % 2 == 0, half,
                       -half)
    v[1, 0] = 127 * s
    v[2] *= -1e-3
    v[2, 0] = -5.0
    v[3] *= 1e-30
    return v


def phase_knn_i8(card: str) -> tuple[dict, dict]:
    """K4 bit for bit and K3's score against their plain versions (the
    score's keys against score_keys of the plain scores: within its
    tolerance on random rows, bit for bit on exact rows with ties); their
    times beside their bounds, K3's score over the 10M indexes'
    10,485,760-row extent."""
    import torch

    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS, KnnMetric, search_extent
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   SCORE_I8,
                                                   quantize_scatter,
                                                   quantize_scatter_reference,
                                                   key_scores, score_i8,
                                                   score_i8_reference)

    from pathway_tpu_torch.engine.profiler import ingest_scatter_cost

    gen = torch.Generator(device="cuda").manual_seed(2)
    D = 384
    k4_before, k3_before = QUANTIZE_SCATTER.launches, SCORE_I8.launches

    def extent(R, d=D):
        """An extent's four tensors filled with arbitrary bytes."""
        return (torch.randint(-127, 128, (R, d), generator=gen,
                              device="cuda", dtype=torch.int8),
                torch.rand(R, generator=gen, device="cuda"),
                torch.rand(R, generator=gen, device="cuda"),
                torch.rand(R, generator=gen, device="cuda") > 0.5)

    # K4: bit for bit, sentinels untouched; the vector body (D % 4 == 0,
    # rows 16-byte aligned, row stride D or D + 4) and the scalar body
    # (row stride D + 1, or D = 1041)
    for n, R, d, pad in ((256, 1024, D, 0), (512, 1024, D, 0),
                         (65_536, 100_352, D, 0), (300, 1024, D, 4),
                         (300, 1024, D, 1), (300, 1024, 64, 0),
                         (300, 1024, 100, 0), (300, 1024, 1041, 0)):
        full = torch.zeros((n, d + pad), device="cuda")
        full[:, :d] = hard_rows(n, d, gen)
        rows = full[:, :d]
        slots = torch.randperm(R, generator=gen, device="cuda")[:n]
        slots[n // 4::5] = R + 1  # sentinel slots: dropped
        vv = torch.rand(n, generator=gen, device="cuda") > 0.1
        ext = extent(R, d)
        got, ref = [t.clone() for t in ext], [t.clone() for t in ext]
        quantize_scatter(rows, slots, vv, *got)
        torch.cuda.synchronize()
        quantize_scatter_reference(rows, slots, vv, *ref)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        hit = torch.zeros(R, dtype=torch.bool, device="cuda")
        hit[slots[slots < R]] = True
        kept = all(torch.equal(a[~hit], b[~hit]) for a, b in zip(got, ext))
        print(f"[K4] n={n} rows of D={d} (row stride {d + pad}) into R={R}: "
              f"bit-identical to the plain version {same}; "
              f"{int((slots >= R).sum())} sentinel rows, untouched rows "
              f"unchanged {kept}", flush=True)
        if not (same and kept):
            fail(f"K4 n={n} D={d}: codes/scales/vsq/valid differ from the "
                 "plain version or a row outside the slots changed")

    # K3 score's keys against the plain version's scores: random codes with
    # 10% invalid rows (within 1e-5 x max|score|, -inf rows exact) and
    # exact-arithmetic rows with ties (codes in [-4, 4], power-of-two
    # scales, the first half of the rows repeated, integer queries: l2sq
    # keys equal bit for bit)
    def operands(N, B, exact, D=D):
        """(q, slab, scales, vsq, valid): random codes and unit queries, or
        (exact) codes in [-4, 4], power-of-two scales, the first half of
        the rows repeated, integer queries; 10% of the rows invalid."""
        hi = 4 if exact else 127
        slab = torch.randint(-hi, hi + 1, (N, D), generator=gen,
                             device="cuda", dtype=torch.int8)
        if exact:
            scales = 2.0 ** -torch.randint(0, 4, (N,), generator=gen,
                                           device="cuda").float()
            half = N // 2
            slab[N - half:] = slab[:half].clone()
            scales[N - half:] = scales[:half].clone()
            q = torch.randint(-3, 4, (B, D), generator=gen,
                              device="cuda").to(torch.bfloat16)
        else:
            scales = torch.rand(N, generator=gen, device="cuda") + 0.01
            q = torch.randn((B, D), generator=gen, device="cuda")
            q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        vsq = (slab.int() ** 2).sum(1).float()
        valid = torch.rand(N, generator=gen, device="cuda") > 0.1
        return q, slab, scales, vsq, valid

    def score_case(N, B, metric, exact, D=D):
        ops = (*operands(N, B, exact, D), metric)
        keys = score_i8(*ops)
        torch.cuda.synchronize()
        return hold_keys(keys, score_i8_reference(*ops), exact,
                         f"K3 score N={N} B={B} D={D} {metric}"
                         + (" exact" if exact else ""))

    k3_err, cases = 0.0, 0
    for N in (10, 4097, _CHUNK_ROWS):
        for B in (1, 7, 33, 64, 65):
            for metric in ("cos", "l2sq"):
                err = score_case(N, B, metric, False)
                if N == _CHUNK_ROWS and B == 1 and metric == "cos":
                    k3_err = err
            score_case(N, B, "l2sq", True)
            cases += 3
    for B in (1, 64):  # D not a multiple of 64 (nor of 16: no ring)
        score_case(4097, B, "cos", False, D=200)
        score_case(4097, B, "l2sq", True, D=200)
        score_case(4097, B, "cos", False, D=1041)
        cases += 3
    print(f"[K3 score] {cases} cases against the plain version (N in {{10, "
          f"4097, {_CHUNK_ROWS}}}, B in {{1, 7, 33, 64, 65}}, D = 384, 200, "
          f"1041): random rows within 1e-5 x max|score| (largest error "
          f"{k3_err:.3e} at B=1 N={_CHUNK_ROWS} cos), keys of exact rows "
          "with ties equal bit for bit", flush=True)
    # the route past K_MAX (search_extent: score_i8 per chunk + the key
    # selection) on exact rows with ties across its chunks (l2sq): the same
    # scores and rows as the plain scan + stable sort
    N = 2 * _CHUNK_ROWS + 4097
    for B in (1, 64):
        q, slab, scales, vsq, valid = operands(N, B, True)
        for k in ROUTE_KS:
            got = search_extent(q.float(), slab, valid, k, KnnMetric.L2SQ,
                                (scales, vsq))
            torch.cuda.synchronize()
            hold_route(got, sort_route(lambda c0, c1: score_i8_reference(
                q, slab[c0:c1], scales[c0:c1], vsq[c0:c1], valid[c0:c1],
                "l2sq"), N, k), None, True,
                f"int8 route N={N} B={B} k={k} exact")
    del q, slab, scales, vsq, valid
    print(f"[K3 score] the route past K_MAX on exact rows with ties across "
          f"chunks, N={N:,}, B in {{1, 64}}, k in {ROUTE_KS} (l2sq): scores "
          f"and rows equal to the plain scan + stable sort", flush=True)

    # K4's time at path 2's write (a ragged chunk: 8 x 32 rows, ~40 real):
    # launched eagerly, and as the graph of K4 alone, replayed
    R = 100_352
    ext = extent(R)
    rows = torch.randn((256, D), generator=gen, device="cuda")
    slots = torch.full((256,), R, dtype=torch.int64, device="cuda")
    slots[:40] = torch.randperm(R, generator=gen, device="cuda")[:40]
    k4_eager = cuda_ms(lambda: quantize_scatter(rows, slots, None, *ext),
                       200)
    k4_plain = cuda_ms(lambda: quantize_scatter_reference(
        rows, slots, None, *ext), 20)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        quantize_scatter(rows, slots, None, *ext)
    k4_ms = cuda_ms(graph.replay, 200)
    real = 40
    k4_bytes = 256 * 8 + real * (4 * D + D + 4 + 4 + 1)
    k4_bound, k4_by = bound(2.0 * real * D, k4_bytes)
    print(f"[K4] path 2's write, 256 rows (40 real) of D={D}: a graph of K4 "
          f"alone replayed 200 times {k4_ms:.4f} ms a replay, launched "
          f"eagerly {k4_eager:.4f} ms, plain {k4_plain:.4f} ms, bound "
          f"{k4_bound:.5f} ms ({k4_by}; {k4_bytes / 1e3:.1f} kB) [{card}]",
          flush=True)
    del graph
    # the bulk flush: the vector body, and the scalar body it replaced (a
    # row a warp, two passes of 4-byte loads; a row stride of D + 1 floats
    # selects it) on the same values; each a graph of 20 launches (no host
    # gap between them), timed in turns
    full = torch.randn((65_536, D + 1), generator=gen, device="cuda")
    rows = full[:, :D].contiguous()
    slots = torch.randperm(R, generator=gen, device="cuda")[:65_536]
    eager_bulk = cuda_ms(lambda: quantize_scatter(rows, slots, None, *ext),
                         50)
    times = {}
    for label, r in (("now", rows), ("scalar", full[:, :D])):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                quantize_scatter(r, slots, None, *ext)
        times[label] = (graph, [])
    for label in ("now", "scalar", "scalar", "now", "now", "scalar"):
        graph, runs = times[label]
        runs.append(cuda_ms(graph.replay, 5) / 20)
    bulk_ms = float(np.median(times["now"][1]))
    before_ms = float(np.median(times["scalar"][1]))
    bulk_bytes = 65_536 * (8 + 4 * D + D + 9)
    bulk_bound, _ = bound(2.0 * 65_536 * D, bulk_bytes)
    _, model_bytes = ingest_scatter_cost(65_536, D, itemsize=1)
    print(f"[K4] bulk flush, 65,536 rows, median of 3 graphs of 20 launches "
          f"in turns: kernel {bulk_ms:.4f} ms, bound {bulk_bound:.4f} ms "
          f"({bulk_bytes / 1e6:.1f} MB), share of bound "
          f"{bulk_bound / bulk_ms:.3f}; the scalar body (row stride "
          f"{D + 1}) {before_ms:.4f} ms, share {bulk_bound / before_ms:.3f}"
          f"; runs now {times['now'][1]}, scalar {times['scalar'][1]}; "
          f"launched eagerly {eager_bulk:.4f} ms; the cost model's "
          f"ingest_scatter_cost {model_bytes / 1e6:.1f} MB -> "
          f"{model_bytes / bulk_ms / 1e6:.1f} GB/s [{card}]", flush=True)
    del ext, rows, full, times

    # K3 score over the 10M indexes' extent, 10,485,760 x 384 int8 rows
    # (4.03 GB), chunk by chunk as search_extent scans it
    N = K2_ROWS
    slab = torch.randint(-127, 128, (N, D), generator=gen, device="cuda",
                         dtype=torch.int8)
    scales = torch.rand(N, generator=gen, device="cuda") + 0.01
    vsq = torch.rand(N, generator=gen, device="cuda") * 1e6
    valid = torch.ones(N, dtype=torch.bool, device="cuda")
    chunk_bf16 = slab[:_CHUNK_ROWS].to(torch.bfloat16)
    n_chunks = N // _CHUNK_ROWS
    k3 = {}
    for B in (1, 64):
        qraw = torch.randn((B, D), generator=gen, device="cuda")
        q = (qraw / qraw.norm(dim=1, keepdim=True)).to(torch.bfloat16)

        def scan(fn, *extra):
            for c0 in range(0, N, _CHUNK_ROWS):
                c1 = c0 + _CHUNK_ROWS
                fn(q, slab[c0:c1], scales[c0:c1], vsq[c0:c1], valid[c0:c1],
                   "cos", *extra)

        ms = cuda_ms(lambda: scan(score_i8), 10)
        plain_ms = cuda_ms(lambda: scan(score_i8_reference), 2)
        mm_ms = cuda_ms(lambda: torch.matmul(q, chunk_bf16.T), 20) * n_chunks
        # the route at k = 80 (a filtered limit 20): with the stable sort
        # per chunk it replaced (of the scores, from the kernel's keys), and
        # as search_extent runs it now
        old_ms = cuda_ms(lambda: sort_route(lambda c0, c1: key_scores(
            score_i8(q, slab[c0:c1], scales[c0:c1], vsq[c0:c1],
                     valid[c0:c1], "cos")), N, 80), 2)
        route_ms = cuda_ms(lambda: search_extent(
            qraw, slab, valid, 80, KnnMetric.COS, (scales, vsq)), 5)
        # cos reads codes, vsq and valid; writes the (B, N) int64 keys
        nbytes = N * (D + 4 + 1) + B * D * 2 + B * N * 8
        bound_ms, bound_by = bound(2.0 * B * N * D, nbytes)
        print(f"[K3 score] B={B} over {N:,} x {D} int8 rows in {n_chunks} "
              f"chunks (cos, writing keys): kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e9:.3f} GB, "
              f"{2.0 * B * N * D / 1e9:.1f} GFLOP), share of bound "
              f"{bound_ms / ms:.3f}; torch.matmul of a bf16 copy of one "
              f"chunk x {n_chunks} {mm_ms:.4f} ms; plain {plain_ms:.4f} ms;"
              f" the route at k=80: score_i8 + stable sort per chunk "
              f"{old_ms:.4f} ms, now (search_extent) {route_ms:.4f} ms "
              f"[{card}]", flush=True)
        k3[B] = (ms, plain_ms, mm_ms, bound_ms, bound_by, old_ms, route_ms)
    del slab, scales, vsq, valid, chunk_bf16
    torch.cuda.empty_cache()
    QUANTIZE_SCATTER.launches, SCORE_I8.launches = k4_before, k3_before
    ms, plain_ms, mm_ms, bound_ms, bound_by, old_ms, route_ms = k3[1]
    ms64, plain64, mm64, bound64, by64, old64, route64 = k3[64]
    k3_rec = {"name": "knn_score_i8", "route": "cuda",
              "source": "pathway_tpu_torch/ops/csrc/knn_i8.cu",
              "replaces": "pathway_tpu/ops/knn.py:211",
              "max_abs_err": k3_err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_share": bound_ms / ms, "library_ms": mm_ms,
              "old_route_ms": old_ms, "route_ms": route_ms,
              "b64": {"ms": ms64, "plain_ms": plain64, "bound_ms": bound64,
                      "bound_by": by64, "bound_share": bound64 / ms64,
                      "library_ms": mm64, "old_route_ms": old64,
                      "route_ms": route64}}
    k4_rec = {"name": "knn_quantize_scatter", "route": "cuda",
              "source": "pathway_tpu_torch/ops/csrc/knn_i8.cu",
              "replaces": "pathway_tpu/ops/knn.py:241",
              "max_abs_err": 0.0, "ms": k4_ms, "plain_ms": k4_plain,
              "bound_ms": k4_bound, "bound_by": k4_by,
              "bound_share": k4_bound / k4_ms, "library_ms": None,
              "eager_ms": k4_eager,
              "bulk": {"ms": bulk_ms, "bound_ms": bulk_bound,
                       "bound_share": bulk_bound / bulk_ms,
                       "before_ms": before_ms, "eager_ms": eager_bulk}}
    return k3_rec, k4_rec


def hold_keys(keys, ref, exact: bool, label: str) -> float:
    """A score kernel's (B, N) keys against the plain (B, N) scores ``ref``:
    equal to ``score_keys(ref)`` on exact-arithmetic rows; else each key
    in its column, its score within 1e-5 x max|score| (exact products, f32
    sums in another order) and -inf where ``ref`` is. Returns the largest
    score error."""
    import torch

    from pathway_tpu_torch.ops.knn_kernels import (key_rows, key_scores,
                                                   score_keys)

    if exact:
        if not torch.equal(keys, score_keys(ref)):
            fail(f"{label}: keys differ from the plain version's")
        return 0.0
    cols = torch.arange(ref.shape[1], device=ref.device).expand_as(keys)
    got = key_scores(keys)
    fin = torch.isfinite(ref)
    tol = 1e-5 * max(1.0, float(ref[fin].abs().max()))
    err = float((got[fin] - ref[fin]).abs().max())
    if not (torch.equal(key_rows(keys), cols)
            and torch.equal(fin, torch.isfinite(got)) and err <= tol):
        fail(f"{label}: max_abs_err {err} > {tol}, -inf rows differ or a "
             "key is out of its column")
    return err


def hold_topk(s, i, rs, ri, full, label: str) -> float:
    """A top-k kernel's (scores s, rows i) against its plain version's (rs,
    ri), with ``full`` the plain (B, N) scores: within 1e-5 x max|score|
    rank by rank, -inf ranks and their rows exact, rows distinct, each
    row's plain score its rank's. Returns the largest score error."""
    import torch

    fin_all = torch.isfinite(full)
    tol = 1e-5 * max(1.0, float(full[fin_all].abs().max())
                     if bool(fin_all.any()) else 1.0)
    fin = torch.isfinite(rs)
    plain_of_got = torch.gather(full, 1, i)
    err = float((s[fin] - rs[fin]).abs().max()) if bool(fin.any()) else 0.0
    err_rows = float((plain_of_got[fin] - rs[fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    distinct = bool((torch.sort(i, dim=1).values.diff(dim=1) != 0).all())
    if not (torch.equal(fin, torch.isfinite(s))
            and torch.equal(fin, torch.isfinite(plain_of_got))
            and torch.equal(i[~fin], ri[~fin]) and distinct
            and err <= tol and err_rows <= tol):
        fail(f"{label}: score error {err:.3e}, its rows' plain scores "
             f"{err_rows:.3e} (tolerance {tol:.3e}), -inf ranks or rows "
             f"differ, or rows repeat (distinct {distinct})")
    return err


def sort_route(score, n: int, k: int):
    """The route past K_MAX as it was before the key selection, written
    plainly: each _CHUNK_ROWS chunk's scores ``score(c0, c1)`` in a stable
    descending sort, its first k, then a stable sort of the candidates.
    With the plain version's scores it is the plain scan + stable sort.
    Returns (B, k) scores and rows."""
    import torch

    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS

    cand_s, cand_i = [], []
    for c0 in range(0, n, _CHUNK_ROWS):
        c1 = min(c0 + _CHUNK_ROWS, n)
        s, i = torch.sort(score(c0, c1), dim=1, descending=True, stable=True)
        cand_s.append(s[:, :k])
        cand_i.append(i[:, :k] + c0)
    s, pos = torch.sort(torch.cat(cand_s, dim=1), dim=1, descending=True,
                        stable=True)
    return s[:, :k], torch.gather(torch.cat(cand_i, dim=1), 1, pos[:, :k])


def hold_route(got, ref, full, exact: bool, label: str) -> float:
    """``search_extent``'s (scores, rows) past K_MAX against the plain scan
    + stable sort's: equal on exact-arithmetic inputs, else as
    ``hold_topk`` holds a top-k kernel (``full``: the plain (B, N)
    scores). Returns the largest score error."""
    import torch

    (s, i), (rs, ri) = got, ref
    if exact:
        if not (torch.equal(s, rs) and torch.equal(i, ri)):
            fail(f"{label}: scores or rows differ from the plain scan + "
                 "stable sort")
        return 0.0
    return hold_topk(s, i, rs, ri, full, label)


def time_selection(make_score, n: int, label: str, card: str) -> dict:
    """The route past K_MAX over one extent of ``n`` rows, ``make_score(B)``
    giving (q, ``score(c0, c1, out=None)``), the queries and the score
    kernel's keys on a chunk for them: as ``search_extent`` runs it
    (``search_chunks``: the kernel's keys of up to 64 // B chunks in one
    ``torch.topk``) beside the selection it replaced, a stable sort per
    chunk of the scores and of the candidates (``sort_route``, over the
    scores decoded from the same keys). Each at B=1 and 64 and k in
    SELECT_KS, after checking that both return the same scores and rows.
    Returns {(B, k): (ms sort, ms route)}."""
    from pathway_tpu_torch.ops.knn import search_chunks
    from pathway_tpu_torch.ops.knn_kernels import key_scores

    out = {}
    for B in (1, 64):
        q, score = make_score(B)
        for k in SELECT_KS:
            cands = (
                lambda: sort_route(lambda c0, c1: key_scores(score(c0, c1)),
                                   n, k),
                lambda: search_chunks(score, n, k, q))
            got = [c() for c in cands]
            hold_route(got[1], got[0], None, True,
                       f"{label} B={B} k={k}: the route against the sort")
            iters = 10 if B == 1 else 3
            out[(B, k)] = tuple(cuda_ms(c, iters) for c in cands)
            t1, tr = out[(B, k)]
            print(f"[{label}] route past K_MAX, B={B} k={k} over {n:,} rows "
                  f"(score kernel + selection): stable sort per chunk "
                  f"{t1:.4f} ms; the route as search_extent runs it (kernel "
                  f"keys, chunks grouped, torch.topk) {tr:.4f} ms; both "
                  f"equal [{card}]", flush=True)
    return out


def phase_topk_i8(card: str) -> dict:
    """K3 top-k against its plain version over random and exact-arithmetic
    extents up to 10M rows; its times over 10M x 384 rows at B=1 and B=64
    beside the bound, the old route and torch's matmul + topk."""
    import torch

    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_I8, TOPK_I8,
                                                   key_scores, score_i8,
                                                   score_i8_reference,
                                                   topk_i8,
                                                   topk_i8_reference)

    gen = torch.Generator(device="cuda").manual_seed(4)
    D = 384
    before = TOPK_I8.launches, SCORE_I8.launches

    def extent(N, exact, valid_frac=0.9):
        """Random codes with 10% invalid rows; or (exact) codes in [-4, 4]
        and power-of-two scales with the first half of the rows repeated
        (exact ties), whose l2sq scores are exact in f32."""
        hi = 4 if exact else 127
        slab = torch.randint(-hi, hi + 1, (N, D), generator=gen,
                             device="cuda", dtype=torch.int8)
        if exact:
            scales = 2.0 ** -torch.randint(0, 4, (N,), generator=gen,
                                           device="cuda").float()
            half = N // 2
            slab[N - half:] = slab[:half]
            scales[N - half:] = scales[:half]
        else:
            scales = torch.rand(N, generator=gen, device="cuda") + 0.01
        vsq = torch.cat([(slab[c:c + (1 << 20)].int() ** 2).sum(1).float()
                         for c in range(0, N, 1 << 20)])
        valid = torch.rand(N, generator=gen, device="cuda") < valid_frac
        return slab, scales, vsq, valid

    def queries(B, exact):
        if exact:
            return torch.randint(-3, 4, (B, D), generator=gen,
                                 device="cuda").to(torch.bfloat16)
        q = torch.randn((B, D), generator=gen, device="cuda")
        return (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    def check(ext, B, metric, k, exact) -> float:
        """The kernel against the plain version on one case: exact, or
        within 1e-5 x max|score| rank by rank, -inf ranks and their rows
        exact, rows distinct, each row's plain score its rank's."""
        q = queries(B, exact)
        s, i = topk_i8(q, *ext, metric, k)
        torch.cuda.synchronize()
        rs, ri = topk_i8_reference(q, *ext, metric, k)
        what = f"N={ext[0].shape[0]} B={B} k={k} {metric}"
        if exact:
            if not (torch.equal(s, rs) and torch.equal(i, ri)):
                fail(f"K3 top-k, exact inputs, {what}: scores or rows "
                     "differ from the plain version")
            return 0.0
        return hold_topk(s, i, rs, ri, score_i8_reference(q, *ext, metric),
                         f"K3 top-k {what}")

    # B = 9 and 32 take the n8-tile counts 2 and 4 (the register path)
    Bs, ks = (1, 7, 9, 32, 64, 65), (1, 10, 64)
    for N in (10, 4097, 100_352, K3_ROWS):
        for exact in (True, False):
            ext = extent(N, exact)
            worst, cases = 0.0, 0
            for metric in (("l2sq",) if exact else ("cos", "l2sq")):
                for B in Bs:
                    for k in ks:
                        if k <= N:
                            worst = max(worst, check(ext, B, metric, k,
                                                     exact))
                            cases += 1
            print(f"[K3 top-k] N={N:,} " + (
                "exact inputs with ties (l2sq): scores and rows equal to "
                f"the plain version in all {cases} cases" if exact else
                f"random rows, 10% invalid (cos, l2sq): {cases} cases, "
                f"max_abs_err {worst:.3e} (tolerance 1e-5 x max|score|)"),
                flush=True)
            del ext
    none = extent(4097, False, valid_frac=0.0)
    cases = 0
    for metric in ("cos", "l2sq"):
        for B in (1, 65):
            for k in ks:
                check(none, B, metric, k, False)
                cases += 1
    print(f"[K3 top-k] an extent with no valid row, N=4,097: rows 0..k-1 at "
          f"-inf as the plain version in all {cases} cases", flush=True)
    del none
    torch.cuda.empty_cache()

    # times over 10M x 384 rows (all valid), cos, k = 10
    N, k = K3_ROWS, 10
    slab, scales, vsq, valid = extent(N, False, valid_frac=1.0)
    chunk_bf16 = slab[:_CHUNK_ROWS].to(torch.bfloat16)
    n_chunks = N / _CHUNK_ROWS
    # what a plain streaming read of the codes takes on this card: torch's
    # max over the slab's bytes seen as float32 (context for the bound)
    read_ms = cuda_ms(lambda: slab.view(torch.float32).amax(), 10)
    print(f"[K3 top-k] torch's read of the {N * D / 1e9:.2f} GB of codes "
          f"(amax over them as float32): {read_ms:.4f} ms, "
          f"{N * D / read_ms / 1e9:.3f} TB/s [{card}]", flush=True)
    times, err1 = {}, 0.0
    for B in (1, 64):
        q = queries(B, False)
        if B == 1:
            err1 = check((slab, scales, vsq, valid), 1, "cos", k, False)

        def old_route():
            return sort_route(lambda c0, c1: key_scores(score_i8(
                q, slab[c0:c1], scales[c0:c1], vsq[c0:c1], valid[c0:c1],
                "cos")), N, k)

        ms = cuda_ms(lambda: topk_i8(q, slab, scales, vsq, valid, "cos", k),
                     20)
        old_ms = cuda_ms(old_route, 5)
        plain_ms = cuda_ms(lambda: topk_i8_reference(
            q, slab, scales, vsq, valid, "cos", k), 2)
        lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(q, chunk_bf16.T),
                                            k), 20) * n_chunks
        # reads codes, vsq and valid (cos) and the queries; writes (B, k)
        # scores and rows
        nbytes = N * (D + 4 + 1) + B * D * 2 + B * k * (4 + 8)
        flops = 2.0 * B * N * D
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[K3 top-k] B={B} k={k} over {N:,} x {D} int8 rows (cos): "
              f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP), share of "
              f"bound {bound_ms / ms:.3f}; old route (score_i8 + stable "
              f"sort per chunk + merge) {old_ms:.4f} ms; torch.matmul of a "
              f"bf16 copy + torch.topk per chunk x {n_chunks:.2f} "
              f"{lib_ms:.4f} ms; plain {plain_ms:.4f} ms [{card}]",
              flush=True)
        times[B] = (ms, plain_ms, lib_ms, bound_ms, bound_by, old_ms)
    del slab, scales, vsq, valid, chunk_bf16
    torch.cuda.empty_cache()
    TOPK_I8.launches, SCORE_I8.launches = before
    ms, plain_ms, lib_ms, bound_ms, bound_by, old_ms = times[1]
    ms64, plain64, lib64, bound64, by64, old64 = times[64]
    return {"name": "knn_topk_i8", "route": "cuda",
            "source": "pathway_tpu_torch/ops/csrc/knn_i8.cu",
            "replaces": "pathway_tpu/ops/knn.py:211",
            "max_abs_err": err1, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "old_route_ms": old_ms,
            "b64": {"ms": ms64, "plain_ms": plain64, "bound_ms": bound64,
                    "bound_by": by64, "bound_share": bound64 / ms64,
                    "library_ms": lib64, "old_route_ms": old64}}


def phase_topk_bf16(card: str) -> dict:
    """K2 against its plain version over random and exact-arithmetic bf16
    extents up to 10,485,760 rows (the 10M index's extent); its times over
    that extent at B=1 and B=64 beside the bound, the old route and
    torch's matmul + topk per chunk."""
    import torch

    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS
    from pathway_tpu_torch.ops.knn_kernels import (TOPK_BF16,
                                                   score_float_reference,
                                                   topk_bf16,
                                                   topk_bf16_reference)

    gen = torch.Generator(device="cuda").manual_seed(6)
    D = 384
    before = TOPK_BF16.launches

    def extent(N, exact, valid_frac=0.9):
        """Uniform rows in [-1, 1) with 10% invalid; or (exact) rows of +-1
        on 4 or 16 contiguous columns at a random offset (squared norms 4
        and 16, so rsqrt and both metrics' scores are exact in f32) with
        the first half of the rows repeated (exact ties)."""
        slab = torch.empty((N, D), dtype=torch.bfloat16, device="cuda")
        col = torch.arange(D, device="cuda")
        for c0 in range(0, N, 1 << 20):
            m = min(1 << 20, N - c0)
            if exact:
                nnz = torch.where(torch.rand(m, generator=gen, device="cuda")
                                  < 0.5, 4, 16)
                off = torch.randint(0, D - 15, (m,), generator=gen,
                                    device="cuda")
                sign = torch.randint(0, 2, (m, D), generator=gen,
                                     device="cuda", dtype=torch.int8) * 2 - 1
                on = (col >= off[:, None]) & (col < (off + nnz)[:, None])
                slab[c0:c0 + m] = (on * sign).to(torch.bfloat16)
            else:
                slab[c0:c0 + m] = (torch.rand((m, D), generator=gen,
                                              device="cuda") * 2 - 1).to(
                    torch.bfloat16)
        if exact:
            half = N // 2
            slab[N - half:] = slab[:half].clone()
        valid = torch.rand(N, generator=gen, device="cuda") < valid_frac
        return slab, valid

    def queries(B, exact):
        if exact:
            return torch.randint(-3, 4, (B, D), generator=gen,
                                 device="cuda").to(torch.bfloat16)
        q = torch.randn((B, D), generator=gen, device="cuda")
        return (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    ks = (1, 10, 64)

    def check(ext, B, metric, exact) -> tuple[float, int]:
        """The kernel against the plain version at every k of ``ks`` on one
        query batch: exact, or within 1e-5 x max|score| rank by rank, -inf
        ranks and their rows exact, rows distinct, each row's plain score
        its rank's. Returns the largest error and the cases checked."""
        q = queries(B, exact)
        N = ext[0].shape[0]
        rs_all, ri_all = topk_bf16_reference(q, *ext, metric, min(64, N))
        full = None if exact else score_float_reference(q.float(), *ext,
                                                        metric)
        worst, cases = 0.0, 0
        for k in ks:
            if k > N:
                continue
            s, i = topk_bf16(q, *ext, metric, k)
            torch.cuda.synchronize()
            rs, ri = rs_all[:, :k], ri_all[:, :k]
            what = f"N={N} B={B} k={k} {metric}"
            cases += 1
            if exact:
                if not (torch.equal(s, rs) and torch.equal(i, ri)):
                    fail(f"K2, exact inputs, {what}: scores or rows differ "
                         "from the plain version")
                continue
            err = hold_topk(s, i, rs, ri, full, f"K2 {what}")
            worst = max(worst, err)
        return worst, cases

    Bs = (1, 7, 64, 65)
    err1 = 0.0
    for N in (10, 4097, 100_352, K2_ROWS):
        for exact in (True, False):
            ext = extent(N, exact)
            worst, cases = 0.0, 0
            for metric in ("cos", "l2sq"):
                for B in Bs:
                    err, n_cases = check(ext, B, metric, exact)
                    worst, cases = max(worst, err), cases + n_cases
                    if N == K2_ROWS and B == 1 and metric == "cos" \
                            and not exact:
                        err1 = err
            print(f"[K2 top-k] N={N:,} " + (
                "exact inputs with ties (cos, l2sq): scores and rows equal "
                f"to the plain version in all {cases} cases" if exact else
                f"random rows, 10% invalid (cos, l2sq): {cases} cases, "
                f"max_abs_err {worst:.3e} (tolerance 1e-5 x max|score|)"),
                flush=True)
            del ext
            torch.cuda.empty_cache()
    none = extent(4097, False, valid_frac=0.0)
    cases = 0
    for metric in ("cos", "l2sq"):
        for B in (1, 65):
            cases += check(none, B, metric, False)[1]
    print(f"[K2 top-k] an extent with no valid row, N=4,097: rows 0..k-1 at "
          f"-inf as the plain version in all {cases} cases", flush=True)
    del none

    # times over the 10M index's extent (all valid), cos, k = 10
    N, k = K2_ROWS, 10
    slab, valid = extent(N, False, valid_frac=1.0)
    n_chunks = N // _CHUNK_ROWS
    read_ms = cuda_ms(lambda: slab.view(torch.float32).amax(), 10)
    print(f"[K2 top-k] torch's read of the {N * D * 2 / 1e9:.2f} GB of bf16 "
          f"rows (amax over them as float32): {read_ms:.4f} ms, "
          f"{N * D * 2 / read_ms / 1e9:.3f} TB/s [{card}]", flush=True)
    times = {}
    for B in (1, 64):
        q = queries(B, False)
        qf = q.float()

        def old_route():  # search_extent's bf16 route before K2
            return sort_route(lambda c0, c1: score_float_reference(
                qf, slab[c0:c1], valid[c0:c1], "cos"), N, k)

        ms = cuda_ms(lambda: topk_bf16(q, slab, valid, "cos", k), 20)
        old_ms = cuda_ms(old_route, 3)
        plain_ms = cuda_ms(lambda: topk_bf16_reference(q, slab, valid, "cos",
                                                       k), 2)
        lib_ms = cuda_ms(lambda: [torch.topk(torch.matmul(
            q, slab[c0:c0 + _CHUNK_ROWS].T), k) for c0 in range(
                0, N, _CHUNK_ROWS)], 10)
        # reads the rows, valid and the queries; writes (B, k) scores and
        # rows
        nbytes = N * (2 * D + 1) + B * D * 2 + B * k * (4 + 8)
        flops = 2.0 * B * N * D
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[K2 top-k] B={B} k={k} over {N:,} x {D} bf16 rows (cos): "
              f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP), share of "
              f"bound {bound_ms / ms:.3f}; old route (score_float_reference"
              f" + stable sort per chunk + merge) {old_ms:.4f} ms; "
              f"torch.matmul + torch.topk per chunk x {n_chunks} "
              f"{lib_ms:.4f} ms; plain {plain_ms:.4f} ms [{card}]",
              flush=True)
        times[B] = (ms, plain_ms, lib_ms, bound_ms, bound_by, old_ms)
    del slab, valid
    torch.cuda.empty_cache()
    TOPK_BF16.launches = before
    ms, plain_ms, lib_ms, bound_ms, bound_by, old_ms = times[1]
    ms64, plain64, lib64, bound64, by64, old64 = times[64]
    return {"name": "knn_topk_bf16", "route": "cuda",
            "source": "pathway_tpu_torch/ops/csrc/knn_bf16.cu",
            "replaces": "pathway_tpu/ops/knn.py:172",
            "max_abs_err": err1, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "old_route_ms": old_ms,
            "b64": {"ms": ms64, "plain_ms": plain64, "bound_ms": bound64,
                    "bound_by": by64, "bound_share": bound64 / ms64,
                    "library_ms": lib64, "old_route_ms": old64}}


def phase_score_bf16(card: str) -> dict:
    """K2's score twin (``score_bf16``) against its plain version over
    random and exact-arithmetic bf16 chunks (its keys against score_keys
    of the plain scores); its times over the 10M index's
    10,485,760-row extent at B=1 and B=64 beside the bound, torch.matmul
    per chunk, the route before it (score_float_reference + a stable sort
    per chunk, at a filtered limit-20 fetch of 80) and the route now."""
    import torch

    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS, KnnMetric, search_extent
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, score_bf16,
                                                   score_bf16_reference,
                                                   score_float_reference)

    gen = torch.Generator(device="cuda").manual_seed(7)
    before = SCORE_BF16.launches

    def pm1(N, D, nnz_choices=(4, 16)):
        """N rows of +-1 on 4 or 16 contiguous columns at a random offset
        (squared norms 4 and 16), bf16"""
        col = torch.arange(D, device="cuda")
        nnz = torch.where(torch.rand(N, generator=gen, device="cuda") < 0.5,
                          *nnz_choices)
        off = torch.randint(0, D - 15, (N,), generator=gen, device="cuda")
        sign = torch.randint(0, 2, (N, D), generator=gen, device="cuda",
                             dtype=torch.int8) * 2 - 1
        on = (col >= off[:, None]) & (col < (off + nnz)[:, None])
        return (on * sign).to(torch.bfloat16)

    def operands(N, B, exact, D=384):
        """(q, slab, valid): uniform rows in [-1, 1) and unit queries; or
        (exact) +-1 rows with the first half repeated and integer queries;
        10% of the rows invalid."""
        if exact:
            slab = pm1(N, D)
            half = N // 2
            slab[N - half:] = slab[:half].clone()
            q = torch.randint(-3, 4, (B, D), generator=gen,
                              device="cuda").to(torch.bfloat16)
        else:
            slab = (torch.rand((N, D), generator=gen, device="cuda") * 2
                    - 1).to(torch.bfloat16)
            q = torch.randn((B, D), generator=gen, device="cuda")
            q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        valid = torch.rand(N, generator=gen, device="cuda") > 0.1
        return q, slab, valid

    def case(N, B, metric, exact, D=384):
        """The kernel's keys against the plain version's scores: within
        1e-5 x max|score|, or (exact) bit for bit."""
        q, slab, valid = operands(N, B, exact, D)
        keys = score_bf16(q, slab, valid, metric)
        torch.cuda.synchronize()
        return hold_keys(keys, score_bf16_reference(q, slab, valid, metric),
                         exact, f"K2 score N={N} B={B} D={D} {metric}"
                         + (" exact" if exact else ""))

    err1, cases = 0.0, 0
    for N in (10, 4097, _CHUNK_ROWS):
        for B in (1, 7, 33, 64, 65):
            for metric in ("cos", "l2sq"):
                err = case(N, B, metric, False)
                if N == _CHUNK_ROWS and B == 1 and metric == "cos":
                    err1 = err
                case(N, B, metric, True)
                cases += 2
    for B in (1, 64):  # D = 200: no ring (D % 128), byte-wise loads
        for metric in ("cos", "l2sq"):
            case(4097, B, metric, False, D=200)
            case(4097, B, metric, True, D=200)
            cases += 2
    print(f"[K2 score] {cases} cases against the plain version (N in {{10, "
          f"4097, {_CHUNK_ROWS}}}, B in {{1, 7, 33, 64, 65}}, D = 384 and "
          f"200, cos and l2sq): random rows within 1e-5 x max|score| "
          f"(largest error {err1:.3e} at B=1 N={_CHUNK_ROWS} cos), keys of "
          "exact rows with ties equal bit for bit", flush=True)
    # the route past K_MAX (search_extent: score_bf16 per chunk + the key
    # selection) on exact rows with ties across its chunks: l2sq with
    # integer queries, cos with queries of +-1 on 4 or 16 columns (their
    # normalised bf16 values +-1/2 or +-1/4, so every score is exact)
    N = 2 * _CHUNK_ROWS + 4097
    for B in (1, 64):
        _, slab, valid = operands(N, B, True)
        for metric in ("cos", "l2sq"):
            q = pm1(B, 384) if metric == "cos" else torch.randint(
                -3, 4, (B, 384), generator=gen, device="cuda").to(
                    torch.bfloat16)
            qn = q.float()
            if metric == "cos":
                qn = qn / (torch.linalg.vector_norm(qn, dim=1, keepdim=True)
                           + 1e-12)
            qn = qn.to(torch.bfloat16)
            for k in ROUTE_KS:
                got = search_extent(q.float(), slab, valid, k,
                                    KnnMetric(metric))
                torch.cuda.synchronize()
                hold_route(got, sort_route(
                    lambda c0, c1: score_bf16_reference(
                        qn, slab[c0:c1], valid[c0:c1], metric), N, k),
                    None, True, f"bf16 route N={N} B={B} k={k} {metric} "
                    "exact")
    del slab, valid
    print(f"[K2 score] the route past K_MAX on exact rows with ties across "
          f"chunks, N={N:,}, B in {{1, 64}}, k in {ROUTE_KS}, cos and l2sq: "
          f"scores and rows equal to the plain scan + stable sort",
          flush=True)

    # times over the 10M index's extent (all valid), cos
    N, D = K2_ROWS, 384
    slab = torch.empty((N, D), dtype=torch.bfloat16, device="cuda")
    for c0 in range(0, N, 1 << 20):
        slab[c0:c0 + (1 << 20)] = (torch.rand(
            (min(1 << 20, N - c0), D), generator=gen, device="cuda") * 2
            - 1).to(torch.bfloat16)
    valid = torch.ones(N, dtype=torch.bool, device="cuda")
    n_chunks = N // _CHUNK_ROWS
    times = {}
    for B in (1, 64):
        qraw = torch.randn((B, D), generator=gen, device="cuda")
        q = (qraw / qraw.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        qf = q.float()

        def scan(fn, *extra):
            for c0 in range(0, N, _CHUNK_ROWS):
                c1 = c0 + _CHUNK_ROWS
                fn(q, slab[c0:c1], valid[c0:c1], "cos", *extra)

        ms = cuda_ms(lambda: scan(score_bf16), 10)
        plain_ms = cuda_ms(lambda: scan(score_bf16_reference), 2)
        lib_ms = cuda_ms(lambda: [torch.matmul(q, slab[c0:c0 + _CHUNK_ROWS].T)
                                  for c0 in range(0, N, _CHUNK_ROWS)], 5)
        old_ms = cuda_ms(lambda: sort_route(
            lambda c0, c1: score_float_reference(qf, slab[c0:c1],
                                                 valid[c0:c1], "cos"),
            N, 80), 2)
        route_ms = cuda_ms(lambda: search_extent(qraw, slab, valid, 80,
                                                 KnnMetric.COS), 5)
        # reads the rows, valid and the queries; writes the (B, N) int64
        # keys
        nbytes = N * (2 * D + 1) + B * D * 2 + B * N * 8
        bound_ms, bound_by = bound(2.0 * B * N * D, nbytes)
        print(f"[K2 score] B={B} over {N:,} x {D} bf16 rows in {n_chunks} "
              f"chunks (cos, writing keys): kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e9:.3f} GB), share "
              f"of bound {bound_ms / ms:.3f}; torch.matmul per chunk (bf16 "
              f"out) x {n_chunks} "
              f"{lib_ms:.4f} ms; plain {plain_ms:.4f} ms; the route at k=80:"
              f" before (score_float_reference + stable sort per chunk) "
              f"{old_ms:.4f} ms, now (search_extent) {route_ms:.4f} ms "
              f"[{card}]", flush=True)
        times[B] = (ms, plain_ms, lib_ms, bound_ms, bound_by, old_ms,
                    route_ms)
    del slab, valid
    torch.cuda.empty_cache()
    SCORE_BF16.launches = before
    ms, plain_ms, lib_ms, bound_ms, bound_by, old_ms, route_ms = times[1]
    ms64, plain64, lib64, bound64, by64, old64, route64 = times[64]
    return {"name": "knn_score_bf16", "route": "cuda",
            "source": "pathway_tpu_torch/ops/csrc/knn_bf16.cu",
            "replaces": "pathway_tpu/ops/knn.py:172",
            "max_abs_err": err1, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": lib_ms,
            "old_route_ms": old_ms, "route_ms": route_ms,
            "b64": {"ms": ms64, "plain_ms": plain64, "bound_ms": bound64,
                    "bound_by": by64, "bound_share": bound64 / ms64,
                    "library_ms": lib64, "old_route_ms": old64,
                    "route_ms": route64}}


def phase_slice(n_docs: int, seed: int, card: str) -> tuple[int, int, int]:
    """Path 1. Returns the launches of K1, K2 and K2's score twin in the
    counted run."""
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  encoder_cost,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex,
                                           search_extent)
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, TOPK_BF16,
                                                   score_float_reference)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed, cfg)
    emb = EncoderEmbedder(config=cfg, params=params, device="cuda")
    index = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
        cfg.hidden, reserved_space=100_064, dtype="bfloat16",
        device="cuda"))
    docs = make_docs(n_docs, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dup_ids = sorted(rng.choice(n_docs, size=32, replace=False).tolist())
    queries = [docs[i] for i in dup_ids] + make_docs(32, seed=seed + 1)

    # layer times at the ingest shape (not part of the counted run)
    ids, lens = emb.pack_tokens(docs[:INGEST_BATCH])
    n_tok = max(1, min(8, n_docs // INGEST_BATCH))
    t0 = time.perf_counter()
    for b in range(n_tok):
        emb.pack_tokens(docs[b * INGEST_BATCH:(b + 1) * INGEST_BATCH])
    tok_ms = (time.perf_counter() - t0) / n_tok * 1e3
    fwd_ms = cuda_ms(lambda: emb.device_producer(emb.model, ids, lens), 20)
    flops, _ = encoder_cost(cfg, INGEST_BATCH, ids.shape[1])
    print(f"[slice] per {INGEST_BATCH}-doc batch at width {ids.shape[1]}: "
          f"tokenize {tok_ms:.2f} ms (host), encoder forward {fwd_ms:.2f} "
          f"ms ({flops / fwd_ms / 1e9:.1f} TFLOP/s) [{card}]", flush=True)

    # the counted run: ingest, then single-query searches
    ATTENTION.launches = TOPK_BF16.launches = SCORE_BF16.launches = 0
    emb.dispatches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b0 in range(0, n_docs, INGEST_BATCH):
        sl = range(b0, min(b0 + INGEST_BATCH, n_docs))
        index.add_batch([Pointer(i) for i in sl], [docs[i] for i in sl])
    index.drain()
    ingest_s = time.perf_counter() - t0
    index.search([(Pointer(10**9), queries[0], 10, None)])  # warm-up
    lat_ms, results = [], []
    for qi, text in enumerate(queries):
        t1 = time.perf_counter()
        res = index.search([(Pointer(10**9 + qi), text, 10, None)])
        lat_ms.append((time.perf_counter() - t1) * 1e3)
        results.append(res[0])
    # limit 20 with a filter (one every document passes) fetches 80 rows,
    # past K_MAX: K2's score twin and the key selection
    res20 = index.search([(Pointer(10**9 + 99), queries[40], 20,
                           lambda data: True)])[0]
    launches, dispatches = ATTENTION.launches, emb.dispatches
    k2_launches, score_launches = TOPK_BF16.launches, SCORE_BF16.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    print(f"[slice] ingested {len(index)} docs into "
          f"{index.inner.page_stats()['extents']} extent(s) in "
          f"{ingest_s:.2f} s: {len(index) / ingest_s:.1f} docs/s; query p50 "
          f"{np.percentile(lat_ms, 50):.3f} ms p99 "
          f"{np.percentile(lat_ms, 99):.3f} ms over {len(lat_ms)} "
          f"single-query searches; peak device memory {peak_mb:.1f} MiB "
          f"[{card}]", flush=True)
    n_ext = len([e for e in index.inner._pool.extents if e.established])
    print(f"[slice] K1 launches {launches}, encoder dispatches {dispatches}"
          f" (x{N_LAYERS} = {N_LAYERS * dispatches}); K2 launches "
          f"{k2_launches} ({len(queries) + 1} searches x {n_ext} "
          f"extent(s)); K2 score {score_launches} (the filtered search)",
          flush=True)
    if len(index) != n_docs:
        fail(f"index holds {len(index)} docs, expected {n_docs}")
    if dispatches == 0 or launches != N_LAYERS * dispatches:
        fail("K1 did not run on every encoder layer of the main path")
    if k2_launches != (len(queries) + 1) * n_ext:
        fail(f"K2 ran {k2_launches} times, not once for each of the "
             f"{len(queries) + 1} searches x {n_ext} extent(s)")
    if score_launches != n_ext:
        fail("the filtered search's fetch past K_MAX did not take K2's "
             "score twin once an extent")

    # the index against a brute-force scan of the same rows on the card.
    # The index scores bf16(query) against bf16 rows in f32 (the JAX
    # package's contract); the scan does the same arithmetic written
    # plainly, as a (64, N) distance matrix and a stable sort.
    inner = index.inner
    exts = [e for e in inner._pool.extents if e.established]
    rows = torch.cat([e.vectors for e in exts]).float()
    valid = torch.cat([e.valid for e in exts])
    base = np.concatenate([e.base + np.arange(e.rows) for e in exts])
    qv = torch.from_numpy(np.stack([emb.embed_batch([t])[0]
                                    for t in queries])).cuda()
    qv = qv.to(torch.bfloat16).float()
    # the two halves of a query on the host clock (after the counted run)
    embed_ms, search_ms = [], []
    for qi, text in enumerate(queries):
        t1 = time.perf_counter()
        vec = emb.embed_batch([text])[0]
        t2 = time.perf_counter()
        inner.search([(Pointer(10**9 + qi), vec, 10, None)])
        embed_ms.append((t2 - t1) * 1e3)
        search_ms.append((time.perf_counter() - t2) * 1e3)
    print(f"[slice] query halves, p50: text embed (tokenize + B=1 forward) "
          f"{np.percentile(embed_ms, 50):.3f} ms, index search (K2 + host "
          f"merge over {inner.capacity} rows) "
          f"{np.percentile(search_ms, 50):.3f} ms [{card}]", flush=True)
    # K2 at this index's shape, k = 10: search_extent (the query cast and
    # K2) beside the route it replaced (torch.matmul + a stable sort) and
    # torch's matmul + topk
    ext = exts[0]
    N, D = ext.vectors.shape
    k2_before = TOPK_BF16.launches
    for B in (1, 64):
        qb = torch.randn((B, D), device="cuda")
        qf = qb.to(torch.bfloat16).float()
        k2_ms = cuda_ms(lambda: search_extent(qb, ext.vectors, ext.valid, 10,
                                              inner.metric), 20)
        old_ms = cuda_ms(lambda: sort_route(
            lambda c0, c1: score_float_reference(
                qf, ext.vectors[c0:c1], ext.valid[c0:c1],
                inner.metric.value), N, 10), 20)
        qb16 = qb.to(torch.bfloat16)
        k2_lib = cuda_ms(lambda: torch.topk(torch.matmul(qb16, ext.vectors.T),
                                            10), 20)
        nbytes = N * (2 * D + 1) + B * D * 4 + B * 10 * (4 + 8)
        k2_bound, k2_by = bound(2.0 * B * N * D, nbytes)
        print(f"[K2] B={B} k=10 over {N:,} x {D} bf16 rows ({len(exts)} "
              f"extent, {inner.metric.value}): search_extent (K2) "
              f"{k2_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}; "
              f"{nbytes / 1e6:.1f} MB), share of bound "
              f"{k2_bound / k2_ms:.3f}; the old route (torch.matmul + "
              f"stable sort) {old_ms:.4f} ms; torch.matmul + torch.topk "
              f"{k2_lib:.4f} ms [{card}]", flush=True)
    TOPK_BF16.launches = k2_before  # comparisons don't count
    dist = (qv * qv).sum(1, keepdim=True) - 2.0 * qv @ rows.T \
        + (rows * rows).sum(1)[None, :]
    dist = dist.masked_fill(~valid[None, :], float("inf"))
    sd, order = torch.sort(dist, dim=1, stable=True)
    order, sd = order[:, :10].cpu().numpy(), sd[:, :10].cpu().numpy()
    dist_np = dist.cpu().numpy()
    rank1_exact = 0
    for qi, res in enumerate(results):
        got = [int(k) for k, _ in res]
        ref = [int(inner._slot_to_key[int(base[j])]) for j in order[qi]]
        if len(got) != 10:
            fail(f"query {qi}: {len(got)} results")
        if got[0] == ref[0]:
            rank1_exact += 1
        else:
            # a rounding tie: the index's first key must be as near as the
            # scan's first key within f32 rounding of distances ~1
            j = np.flatnonzero(base == inner._key_to_slot[Pointer(got[0])])
            gap = float(dist_np[qi, j[0]] - sd[qi, 0])
            if gap > 1e-6:
                fail(f"query {qi}: rank 1 {got[0]} != scan's {ref[0]} "
                     f"(distance gap {gap:.3e})")
        overlap = len(set(got) & set(ref))
        if overlap < 9:
            fail(f"query {qi}: only {overlap}/10 keys match the scan")
    print(f"[slice] top-10 vs brute-force scan: all 64 queries pass, rank 1"
          f" identical on {rank1_exact}/64 (the rest within a 1e-6 "
          f"rounding tie)", flush=True)
    own_rank1 = 0
    for qi, doc_id in enumerate(dup_ids):
        got = [int(k) for k, _ in results[qi]]
        if doc_id not in got:
            fail(f"duplicate query of doc {doc_id} missed it in its top 10")
        own_rank1 += got[0] == doc_id
    print(f"[slice] duplicate queries: 32/32 find their document in the top"
          f" 10, {own_rank1}/32 at rank 1", flush=True)
    # the filtered search's top 20 against the plain scan's scores, and
    # the route past K_MAX against the plain scan + stable sort
    keys_of = np.array([int(inner._slot_to_key.get(int(s), -1))
                        for s in base])
    metric = inner.metric.value
    check_top10([res20], score_float_reference(qv[40:41], rows, valid,
                                               metric),
                keys_of, "path 1 filtered", n=20)
    score_before = SCORE_BF16.launches
    q8, N = qv[:8], ext.vectors.shape[0]
    full = score_float_reference(q8, ext.vectors, ext.valid, metric)
    for k in ROUTE_KS:
        got = search_extent(q8, ext.vectors, ext.valid, k, inner.metric)
        torch.cuda.synchronize()
        hold_route(got, sort_route(lambda c0, c1: full[:, c0:c1], N, k),
                   full, False, f"path 1 search_extent k={k}")
    SCORE_BF16.launches = score_before  # comparisons don't count
    print(f"[slice] the filtered limit-20 search's top 20 equal the plain "
          f"scan's; search_extent at k in {ROUTE_KS} (K2's score twin + the"
          f" key selection) against the plain scan + stable sort: within "
          f"1e-5 x max|score|, -inf ranks exact", flush=True)

    # card (kernel) vs CPU (plain attention), same weights and dtype
    cpu_emb = EncoderEmbedder(config=cfg, params=params, device="cpu")
    a = emb.embed_batch(docs[:16]).astype(np.float64)
    b = cpu_emb.embed_batch(docs[:16]).astype(np.float64)
    cos = np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                              * np.linalg.norm(b, axis=1))
    print(f"[slice] card vs CPU embeddings of 16 docs: min row cosine "
          f"{cos.min():.6f} (required >= 0.999)", flush=True)
    if not np.all(np.isfinite(a)) or cos.min() < 0.999:
        fail("card embeddings disagree with the CPU port")
    return launches, k2_launches, score_launches


ENGINE_RAGGED_DOCS = 10_240  # 20 ticks of the ragged embedder


class GcClock:
    """Host time spent in Python's cyclic garbage collector while
    installed (``gc.callbacks``)."""

    def __init__(self):
        self.s, self.n, self._t0 = 0.0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0
            self.n += 1

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def engine_run(emb, docs: list[str], label: str) -> dict:
    """``table_from_rows(docs, one tick per INGEST_BATCH docs at time
    2 * tick).select(embedding=emb(pw.this.data))`` under
    ``GraphRunner.run_batch(n_workers=1)`` (the UDF's map on the device
    bridge at ``PATHWAY_DEVICE_INFLIGHT``'s window, default 2), every
    launch count set to 0 just before the run and read just after. Returns
    the captured events, K1's launches, the encoder dispatches, the run's
    wall, the time spent inside the UDF and in the garbage collector (s),
    the window and the bridge's counters."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    rows = [(doc, 2 * (i // INGEST_BATCH), 1) for i, doc in enumerate(docs)]
    table = table_from_rows(pw.schema_from_types(data=str), rows,
                            is_stream=True)
    runner = GraphRunner()
    cap = runner.capture(table.select(embedding=emb(pw.this.data)))
    emb.udf_s = 0.0
    gc.collect()  # earlier phases' garbage is not this run's
    for count in LAUNCH_COUNTS:
        count.launches = 0
    emb.dispatches = 0
    torch.cuda.synchronize()
    with GcClock() as gc_clock:
        t0 = time.perf_counter()
        runner.run_batch(n_workers=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, dispatches = ATTENTION.launches, emb.dispatches
    others = {c.name: c.launches for c in LAUNCH_COUNTS
              if c is not ATTENTION and c.launches}
    if others:
        fail(f"{label}: kernels other than K1 ran in the engine run: "
             f"{others}")
    return {"events": cap.events, "k1": launches, "dispatches": dispatches,
            "wall": wall, "udf": emb.udf_s, "gc": gc_clock.s,
            "gc_n": gc_clock.n, "window": runner._scheduler.device_inflight,
            "bridge": runner._scheduler.bridge_stats()}


def direct_run(emb, docs: list[str]) -> tuple[np.ndarray, float]:
    """The same documents through ``embed_batch`` in the engine's
    batches; returns the embeddings and the wall (s)."""
    gc.collect()
    t0 = time.perf_counter()
    out = np.concatenate([emb.embed_batch(docs[b:b + INGEST_BATCH])
                          for b in range(0, len(docs), INGEST_BATCH)])
    return out, time.perf_counter() - t0


def hold_engine(events, docs: list[str], direct: np.ndarray, label: str
                ) -> None:
    """Every document once, diff +1, at its tick's time, under the key
    ``table_from_rows`` gives it, with the direct call's embedding bit for
    bit."""
    from pathway_tpu_torch.internals.keys import hash_values_uncached

    if len(events) != len(docs):
        fail(f"{label}: {len(events)} events for {len(docs)} documents")
    index = {int(hash_values_uncached("row", i, doc)): i
             for i, doc in enumerate(docs)}
    seen = np.zeros(len(docs), bool)
    for key, row, t, diff in events:
        i = index.get(int(key))
        if i is None or seen[i]:
            fail(f"{label}: key {key!r} is no document's or repeats")
        seen[i] = True
        if diff != 1 or t != 2 * (i // INGEST_BATCH):
            fail(f"{label}: document {i} at time {t} diff {diff}")
        vec = row[0]
        if vec.dtype != np.float32 or vec.shape != direct[i].shape \
                or not np.array_equal(vec, direct[i]):
            diff_max = float(np.abs(vec.astype(np.float64)
                                    - direct[i]).max())
            fail(f"{label}: document {i}'s embedding differs from the "
                 f"direct embed_batch (max |diff| {diff_max:.3e})")
    if not np.all(np.isfinite(direct)):
        fail(f"{label}: non-finite embeddings")


def phase_engine(n_docs: int, seed: int, card: str) -> tuple[int, int]:
    """The engine's batch path: BGE-small as a batch device UDF,
    ``select(embedding=emb(pw.this.data))`` under
    ``GraphRunner.run_batch``, over path 1's documents (padded, bf16;
    100,000 by default: 196 ticks of 512), then the ragged embedder over
    the first 10,240 of them in 20 ticks; each held bit for bit against its own
    ``embed_batch`` over the same 512-document batches. Returns K1's
    launches in the padded and in the ragged engine run."""
    import torch

    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    class TimedEmbedder(EncoderEmbedder):
        """The UDF body timed on the host clock (it ends with the
        device-to-host copy of the batch, so the device work is inside)."""

        udf_s = 0.0

        def __wrapped__(self, texts, **kwargs):
            t0 = time.perf_counter()
            out = super().__wrapped__(texts, **kwargs)
            self.udf_s += time.perf_counter() - t0
            return out

    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed, cfg)
    docs = make_docs(n_docs, seed=seed)
    launches = []
    for ragged, n in ((False, n_docs),
                      (True, min(n_docs, ENGINE_RAGGED_DOCS))):
        label = "engine ragged" if ragged else "engine"
        emb = TimedEmbedder(config=cfg, params=params, ragged=ragged,
                            device="cuda")
        sub = docs[:n]
        n_ticks = -(-n // INGEST_BATCH)
        # warm every dispatch shape outside the timed window
        if ragged:
            for b in emb.ragged_buckets():
                args, _ = emb.ragged_warmup_operands(b)
                emb.ragged_device_producer(emb.model, *args)
        else:
            for w in emb.bucket_widths():
                emb.device_producer(
                    emb.model, np.zeros((INGEST_BATCH, w), np.int16),
                    np.full(INGEST_BATCH, w, np.int32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # engine, direct, direct, engine: host-clock times drift by 10-30%
        # between consecutive runs on this machine, so each side is timed
        # twice in mirrored order; the first engine run is the counted one
        first = engine_run(emb, sub, label)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        k1, dispatches = first["k1"], first["dispatches"]
        direct, direct_s1 = direct_run(emb, sub)
        hold_engine(first.pop("events"), sub, direct, label)
        direct_s2 = direct_run(emb, sub)[1]
        second = engine_run(emb, sub, label)
        hold_engine(second.pop("events"), sub, direct, label + " (again)")
        if dispatches == 0 or k1 != N_LAYERS * dispatches:
            fail(f"{label}: K1 launched {k1} times for {dispatches} encoder "
                 f"dispatches, not {N_LAYERS} a dispatch")
        if not ragged and dispatches != n_ticks:
            fail(f"{label}: {dispatches} encoder dispatches for {n_ticks} "
                 "ticks")
        runs = (first, second)
        engine_s = sum(r["wall"] for r in runs)
        outside_ms = sum(r["wall"] - r["udf"] for r in runs) / 2 / n_ticks
        print(f"[{label}] {n} docs in {n_ticks} ticks through "
              f"select(embedding=emb(pw.this.data)) under GraphRunner."
              f"run_batch, then direct embed_batch in the same batches, "
              f"twice each in the order engine, direct, direct, engine: "
              f"engine {n / first['wall']:.1f} and {n / second['wall']:.1f}"
              f" docs/s, direct {n / direct_s1:.1f} and {n / direct_s2:.1f}"
              f" docs/s; engine / direct docs/s over both "
              f"{(direct_s1 + direct_s2) / engine_s:.4f}; engine host time "
              f"a tick outside the UDF {outside_ms * 1e3:.3f} ms (inside "
              f"{sum(r['udf'] for r in runs) / 2 / n_ticks * 1e3:.3f} ms); "
              f"garbage collector {first['gc']:.3f} / {second['gc']:.3f} s "
              f"({first['gc_n']} / {second['gc_n']} collections) of the "
              f"engine runs; peak device memory {peak_mb:.1f} MiB; device "
              f"bridge window {first['window']}"
              + (f" (legs {first['bridge']['legs_resolved']}, overlap ratio "
                 f"{first['bridge']['overlap_ratio']:.3f}, host waited "
                 f"{first['bridge']['submit_wait_ms']:.3f} ms in submit and "
                 f"{first['bridge']['barrier_wait_ms']:.3f} ms in barrier)"
                 if first["bridge"] else "") + f" [{card}]",
              flush=True)
        print(f"[{label}] K1 launches {k1} = {N_LAYERS} x {dispatches} "
              f"encoder dispatches in the counted run; every document once "
              f"with diff +1 and its table_from_rows key; embeddings equal "
              f"the direct embed_batch bit for bit (both engine runs)",
              flush=True)
        launches.append(k1)
    return launches[0], launches[1]


FRAMEWORK_BATCH = 2048  # bench.py's BATCH: documents a tick
BENCH_SEQ = 128         # bench.py's SEQ: the framework embedder's max_len
# configuration B's packed sequence width: at bench's 128 a 92-token
# document fills a sequence alone (8 documents a chunk); 512 packs ~5
RAGGED_SEQ = 512
WARM_KEY0 = 1 << 62     # bench.py's throw-away keys of the warm-up


def framework_tokenizer(max_len: int):
    """bench.py's framework tokenizer (``_make_framework_embedder``,
    bench.py:1266-1276): WordPiece over ``make_synthetic_vocab`` of bench's
    4096 words at BGE-small's vocabulary size. Fails unless the native
    engine runs it, so no pure-Python fallback reaches a number."""
    from pathway_tpu_torch.models.tokenizer import (WordPieceTokenizer,
                                                    make_synthetic_vocab)

    tok = WordPieceTokenizer(make_synthetic_vocab(
        [f"word{i}" for i in range(4096)], vocab_size=30522),
        max_len=max_len)
    if not tok.native:
        fail(f"bench's WordPiece tokenizer runs its pure-Python engine: the "
             f"native build failed ({tok.native_error})")
    return tok


def framework_queries(docs: list[str], n_ticks: int, seed: int) -> list:
    """The phase's query stream, ``(time, text, k, doc)`` (``doc`` the
    document a copy repeats, else None): bench.py's own ("word1 word2
    word3", 3) at time 0, over the first tick's rows; at the middle tick's
    time 16 copies of documents of ticks up to it and 16 of later ones;
    after the last tick 32 copies of ingested documents, 32 fresh texts
    (k = 10) and one copy with k = 80, whose fetch goes past K_MAX."""
    n = len(docs)
    t_mid, t_last = 2 * (n_ticks // 2), 2 * n_ticks
    n_early = (n_ticks // 2 + 1) * FRAMEWORK_BATCH
    rng = np.random.default_rng(seed + 2)
    early = rng.choice(n_early, 16, replace=False).tolist()
    late = (n_early + rng.choice(n - n_early, 16, replace=False)).tolist()
    ingested = rng.choice(n, 32, replace=False).tolist()
    spec = [(0, "word1 word2 word3", 3, None)]
    spec += [(t_mid, docs[i], 10, i) for i in early + late]
    spec += [(t_last, docs[i], 10, i) for i in ingested]
    spec += [(t_last, t, 10, None) for t in make_docs(32, seed=seed + 3)]
    spec.append((t_last, docs[ingested[0]], 80, ingested[0]))
    return spec


def framework_warm(index, emb, widths: list[int]) -> None:
    """bench.py's warm-up (bench.py:1160-1198) through a built
    ``DeviceEmbeddingKnnIndex``: the query's dispatch shape, a batch of
    2048 documents under throw-away keys, then the fused step at every
    padded width the run dispatches (A) or at every ragged chunk bucket,
    which captures each bucket's CUDA graph on the index's extent (B), one
    k=3 search, and the warm keys removed with the removal flushed."""
    from pathway_tpu_torch.internals.keys import Pointer

    emb.embed_batch(["word1 word2 word3"])
    wkeys = [Pointer(WARM_KEY0 + i) for i in range(FRAMEWORK_BATCH)]
    index.add_batch(wkeys, make_docs(FRAMEWORK_BATCH, seed=1))
    if emb.ragged:
        for b in emb.ragged_buckets():
            args, n = emb.ragged_warmup_operands(b)
            index._fused(wkeys[:n], emb.model, *args, n_rows=n)
    else:
        for w in widths:
            index._fused(wkeys, emb.model,
                         np.zeros((FRAMEWORK_BATCH, w), np.int16),
                         np.full(FRAMEWORK_BATCH, max(1, w - 2), np.int32))
    index.search([(Pointer(WARM_KEY0 + FRAMEWORK_BATCH), "word1 word2 word3",
                   3, None)])
    for k in wkeys:
        index.remove(k)
    index.flush_device()


def framework_run(emb, dtype: str, rows: list, qspec: list, widths: list,
                  window: int | None) -> dict:
    """bench.py's ``bench_embed_framework`` graph through the port:
    ``VectorStoreServer(docs, embedder=emb, index_builder=...
    default_brute_force_knn_document_index(chunks.text, chunks,
    embedder=emb, dimensions=384, reserved_space=n_docs + 64, dtype))``,
    ``retrieve_query`` captured, warmed through the built index
    (``framework_warm``), then ``GraphRunner.run_batch(n_workers=1)`` and
    the index's ``drain()`` timed as bench.py times them, with
    ``PATHWAY_DEVICE_INFLIGHT`` unset (``window`` None: the device bridge
    at its default window, 2) or set to ``window``; every launch count set
    to 0 just before the run and read just after. Each operator's step is
    timed on the host clock by the thread it ran on (the calling thread's
    host leg, the bridge worker's device leg), the index's ``add_batch``
    and searches too; each search's queries and replies are kept for the
    checks."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.engine.device_bridge import \
        device_inflight_from_env
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.stdlib.indexing import \
        default_brute_force_knn_document_index
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    n_docs = len(rows)
    docs = table_from_rows(pw.schema_from_types(data=str, _metadata=pw.Json),
                           rows, is_stream=True)
    queries = table_from_rows(
        pw.schema_from_types(query=str, k=int, metadata_filter=str | None,
                             filepath_globpattern=str | None),
        [(text, k, None, None, t, 1) for t, text, k, _ in qspec],
        is_stream=True)
    store = VectorStoreServer(
        docs, embedder=emb,
        index_builder=lambda chunks: default_brute_force_knn_document_index(
            chunks.text, chunks, embedder=emb,
            dimensions=emb.get_embedding_dimension(),
            reserved_space=n_docs + 64, dtype=dtype))
    runner = GraphRunner()
    cap = runner.capture(store.retrieve_query(queries))
    index = next(n.op.index for n in runner.graph.nodes
                 if isinstance(n.op, ExternalIndexOperator))
    framework_warm(index, emb, widths)
    op_s: dict[str, float] = {}
    leg_s = {"host": 0.0, "device": 0.0}
    main = threading.main_thread()

    def timed(fn, name, leg=False):
        def step(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            dt = time.perf_counter() - t0
            op_s[name] = op_s.get(name, 0.0) + dt
            if leg:
                leg_s["host" if threading.current_thread() is main
                      else "device"] += dt
            return out
        return step

    for node in runner.graph.nodes:
        node.op.step = timed(node.op.step,
                             f"{node.name.split(':')[0]}/"
                             f"{type(node.op).__name__}", leg=True)
    index.add_batch = timed(index.add_batch, "index add_batch")
    searches = []
    inner_search = index.inner.search

    def search(batch):
        replies = inner_search(batch)
        searches.append((batch, replies))
        return replies

    index.inner.search = timed(search, "index inner search")
    index.search = timed(index.search, "index search")
    step = getattr(index._fused, "step", None)
    # the warm-up's captures and replays are not the window's
    captures0, replays0 = (step.captures, step.replays) if step is not None \
        else (0, 0)
    saved = os.environ.pop("PATHWAY_DEVICE_INFLIGHT", None)
    if window is not None:
        os.environ["PATHWAY_DEVICE_INFLIGHT"] = str(window)
    try:
        inflight = device_inflight_from_env()
        gc.collect()  # earlier runs' garbage is not this run's
        for count in LAUNCH_COUNTS:
            count.launches = 0
        emb.dispatches = 0
        torch.cuda.synchronize()
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            runner.run_batch(n_workers=1)
            index.drain()
            wall = time.perf_counter() - t0
    finally:
        os.environ.pop("PATHWAY_DEVICE_INFLIGHT", None)
        if saved is not None:
            os.environ["PATHWAY_DEVICE_INFLIGHT"] = saved
    return {"events": cap.events, "index": index, "searches": searches,
            "extents": sum(e.established for e in index.inner._pool.extents),
            "wall": wall, "op_s": op_s, "leg_s": leg_s, "gc": gc_clock.s,
            "gc_n": gc_clock.n, "dispatches": emb.dispatches,
            "launches": {c: c.launches for c in LAUNCH_COUNTS},
            "captures": (step.captures if step is not None else 0)
            - captures0,
            "replays": (step.replays if step is not None else 0) - replays0,
            "inflight": inflight,
            "bridge": runner._scheduler.bridge_stats()}


def framework_direct(emb, dtype: str, texts: list[str], keys: list,
                     widths: list) -> dict:
    """The same documents through ``DeviceEmbeddingKnnIndex.add_batch``
    directly, in the engine's batches and with its keys, into a fresh
    index warmed as the engine's is (``framework_warm``, so both hand out
    the same slots); returns the index, the wall (s) and the graphs
    captured inside it."""
    import torch

    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex)

    index = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
        emb.get_embedding_dimension(), reserved_space=len(texts) + 64,
        metric="cos", dtype=dtype, device="cuda"))
    framework_warm(index, emb, widths)
    step = getattr(index._fused, "step", None)
    captures0 = step.captures if step is not None else 0
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b0 in range(0, len(texts), FRAMEWORK_BATCH):
        index.add_batch(keys[b0:b0 + FRAMEWORK_BATCH],
                        texts[b0:b0 + FRAMEWORK_BATCH])
    index.drain()
    wall = time.perf_counter() - t0
    return {"index": index, "wall": wall,
            "captures": (step.captures if step is not None else 0)
            - captures0}


def same_index(a, b) -> bool:
    """Two indexes hold the same keys in the same slots and the same rows,
    bit for bit (int8: codes, scales and vsq)."""
    import torch

    names = ("vectors", "valid") + (("scales", "vsq")
                                    if a.inner.dtype == "int8" else ())
    return a.inner._key_to_slot == b.inner._key_to_slot and len(
        a.inner._pool.extents) == len(b.inner._pool.extents) and all(
        torch.equal(getattr(x, t), getattr(y, t))
        for x, y in zip(a.inner._pool.extents, b.inner._pool.extents)
        for t in names)


def hold_framework(run: dict, emb, docs: list[str], keys: list,
                   qspec: list, label: str) -> None:
    """The query embeddings the engine passed to the index against the
    plain encoder (``attention_reference`` in every layer, padded) on the
    card: row cosine >= 0.999, as the earlier phases hold K1. Each reply
    against a plain scan, on the card, of the index rows present at its
    query's time (bf16: ``score_float_reference`` of the bf16 queries;
    int8: ``score_i8_reference``, as ``plain_scan_i8``), both over the
    engine's query vectors, so that the search is held exactly: the same
    keys in rank order up to 1e-6 score ties, each ``dist`` within 1e-5 of
    1 - the scan's score, texts and ``path`` metadata the documents'; a
    copy finds its document first when it was ingested by then, and never
    when it was not."""
    import torch

    from pathway_tpu_torch.internals.keys import hash_values_uncached
    from pathway_tpu_torch.models.encoder import encode
    from pathway_tpu_torch.ops.attention import attention_reference
    from pathway_tpu_torch.ops.knn_kernels import score_float_reference

    inner = run["index"].inner
    exts = [e for e in inner._pool.extents if e.established]
    base = np.concatenate([e.base + np.arange(e.rows) for e in exts])
    keys_of = np.array([int(inner._slot_to_key.get(int(s), -1))
                        for s in base])
    doc_of = {int(k): i for i, k in enumerate(keys)}
    tick_of_slot = np.array([doc_of[k] // FRAMEWORK_BATCH if k in doc_of
                             else 1 << 30 for k in keys_of.tolist()])
    valid = torch.cat([e.valid for e in exts])
    qkey = {int(hash_values_uncached("row", qi, text, k, None, None)): qi
            for qi, (_, text, k, _) in enumerate(qspec)}
    events = run["events"]
    if len(events) != len(qspec) or any(d != 1 for _, _, _, d in events):
        fail(f"{label}: {len(events)} reply events for {len(qspec)} queries")
    replies = {}
    for key, row, t, _ in events:
        qi = qkey.get(int(key))
        if qi is None or qi in replies or t != qspec[qi][0]:
            fail(f"{label}: reply {key!r} at time {t} is no query's")
        replies[qi] = row[0].value
    by_search = {}
    for batch, _ in run["searches"]:
        for j, (k, vec, _, _) in enumerate(batch):
            by_search[qkey[int(k)]] = (batch, j)
    if len(by_search) != len(qspec):
        fail(f"{label}: {len(by_search)} queries reached the index, not "
             f"{len(qspec)}")
    got_q = np.stack([np.asarray(by_search[qi][0][by_search[qi][1]][1],
                                 np.float64) for qi in range(len(qspec))])
    ids, lens = emb.pack_tokens([text for _, text, _, _ in qspec])
    ids_d = torch.from_numpy(ids).cuda().long()
    lens_d = torch.from_numpy(lens).cuda()
    mask = torch.arange(ids_d.shape[1], device="cuda")[None, :] \
        < lens_d[:, None]
    ref_q = encode(emb.model, ids_d, mask, attn_fn=attention_reference
                   ).cpu().numpy().astype(np.float64)
    q_cos = np.sum(got_q * ref_q, 1) / (np.linalg.norm(got_q, axis=1)
                                        * np.linalg.norm(ref_q, axis=1))
    if not np.all(np.isfinite(got_q)) or q_cos.min() < 0.999:
        fail(f"{label}: a query embedding is off the plain encoder's (min "
             f"row cosine {q_cos.min():.6f})")
    own_first = 0
    for qi, (t, text, k, doc) in enumerate(qspec):
        reply = replies[qi]
        if len(reply) != k:
            fail(f"{label} query {qi}: {len(reply)} matches, not {k}")
        got = []
        for m in reply:
            i = int(m["metadata"]["path"][2:-4])
            if m["text"] != docs[i] or m["metadata"] != {"path": f"/d{i}.txt"}:
                fail(f"{label} query {qi}: a match's text or metadata is not "
                     f"document {i}'s")
            if 2 * (i // FRAMEWORK_BATCH) > t:
                fail(f"{label} query {qi} at time {t}: document {i} of a "
                     "later tick")
            got.append((keys[i], m["dist"]))
        batch, j = by_search[qi]
        q = torch.from_numpy(np.stack(
            [np.asarray(v, np.float32) for _, v, _, _ in batch])).cuda()
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
        q = q[j:j + 1].to(torch.bfloat16)
        present = valid & torch.from_numpy(
            2 * tick_of_slot <= t).to(valid.device)
        if inner.dtype == "int8":
            cat = [torch.cat([getattr(e, a) for e in exts])
                   for a in ("vectors", "scales", "vsq")]
            scan = plain_scan_i8(q, *cat, present)
        else:
            rows = torch.cat([e.vectors for e in exts])
            scan = score_float_reference(q.float(), rows, present, "cos")
        check_top10([got], scan, keys_of, f"{label} query {qi}", n=k)
        cols = [int(np.flatnonzero(keys_of == int(kk))[0]) for kk, _ in got]
        want = 1.0 - scan[0, cols].cpu().numpy()
        err = float(np.abs(np.array([d for _, d in got]) - want).max())
        if not err <= 1e-5:
            fail(f"{label} query {qi}: dist off the scan by {err:.3e}")
        if doc is not None:
            ids = [int(m["metadata"]["path"][2:-4]) for m in reply]
            ingested = 2 * (doc // FRAMEWORK_BATCH) <= t
            if ingested and ids[0] != doc:
                fail(f"{label} query {qi}: the copy of document {doc} "
                     f"finds {ids[0]} first")
            if not ingested and doc in ids:
                fail(f"{label} query {qi}: document {doc} found before it "
                     "was ingested")
            own_first += ingested
    print(f"[{label}] query embeddings against the plain encoder on the "
          f"card: min row cosine {q_cos.min():.6f} (required >= 0.999)",
          flush=True)
    print(f"[{label}] answers: all {len(qspec)} replies equal a plain scan "
          f"of the rows present at their query's time (keys in rank order "
          f"up to 1e-6 score ties, dist within 1e-5); {own_first} copies of "
          f"ingested documents find them first, 16 copies of later "
          f"documents never do", flush=True)


def framework_holds(run: dict, direct, expect: dict, ingest: int,
                    query: int, emb, docs: list[str], keys: list,
                    qspec: list, label: str) -> None:
    """Every check of one engine run: the replies and query embeddings
    (``hold_framework``), one extent, the launches the code states, the
    encoder dispatches (B: one graph replay an ingest chunk), the index bit
    for bit the direct ``add_batch`` one's (same tokenizer), no graph
    captured inside the timed window, and, under the bridge, legs that
    ran on it."""
    hold_framework(run, emb, docs, keys, qspec, label)
    launches = {c: n for c, n in run["launches"].items() if n}
    if run["extents"] != 1:
        fail(f"{label}: {run['extents']} extents, stated 1")
    if launches != expect:
        fail(f"{label}: launches {[(c.name, n) for c, n in launches.items()]}"
             f" differ from the stated "
             f"{[(c.name, n) for c, n in expect.items()]}")
    if run["dispatches"] != ingest + query or (
            emb.ragged and run["replays"] != ingest):
        fail(f"{label}: {run['dispatches']} encoder dispatches "
             f"({run['replays']} replays), stated {ingest} + {query}")
    if not same_index(run["index"], direct):
        fail(f"{label}: the engine-built index differs from the one "
             "add_batch builds directly")
    if run["captures"]:
        fail(f"{label}: {run['captures']} CUDA graphs captured inside the "
             "timed window (the warm-up missed a chunk shape)")
    if run["inflight"] >= 2 and not (run["bridge"] and
                                     run["bridge"]["legs_resolved"] > 0):
        fail(f"{label}: no leg ran on the device bridge at window "
             f"{run['inflight']}")


def framework_line(run: dict, n_docs: int, n_ticks: int) -> str:
    """One engine run's numbers: docs/s, the window and the bridge's
    counters, host ms a tick by leg, the host's waits on the bridge, the
    index's ingest and searches, the collector."""
    br = run["bridge"] or {}
    ops = run["op_s"]
    return (f"{n_docs / run['wall']:.1f} docs/s at window {run['inflight']}"
            + (f" (bridge legs {br['legs_resolved']}, overlap ratio "
               f"{br['overlap_ratio']:.3f}, queue wait "
               f"{br['queue_wait_ms']:.3f} ms, leg execution "
               f"{br['exec_ms']:.3f} ms)" if br else " (no bridge)")
            + f"; host ms a tick: host leg on the calling thread "
            f"{run['leg_s']['host'] / n_ticks * 1e3:.3f}, device leg on the "
            f"bridge worker {run['leg_s']['device'] / n_ticks * 1e3:.3f}; "
            f"the host thread waited {br.get('submit_wait_ms', 0.0):.3f} ms "
            f"in submit and {br.get('barrier_wait_ms', 0.0):.3f} ms in "
            f"barrier; index ingest "
            f"{ops['index add_batch'] / n_ticks * 1e3:.3f} ms a tick, "
            f"searches {ops['index search'] * 1e3:.3f} ms a run; garbage "
            f"collector {run['gc']:.3f} s ({run['gc_n']} collections); "
            f"graphs captured in the window {run['captures']}")


def phase_framework(n_docs: int, seed: int, card: str) -> dict:
    """bench_embed_framework's graph (VectorStoreServer → DataIndex.
    query_as_of_now over the external index operator) at BGE-small's
    width, as bench.py runs it: bench's WordPiece tokenizer (native engine
    asserted), bench's warm-up through the built index, the device bridge
    at its default window. Configuration A, the padded embedder at bench's
    max_len 128 into a bf16 cos index (K1, K2, K2 score); B, the ragged
    embedder (sequences of 512) into an int8 cos index (K1 with segment
    ids, K4 inside each chunk's graph replay, K3 top-k, K3 score). Each
    runs bridged, direct, direct, bridged, then at window 1, then the
    embedder's default HashTokenizer at window 1 beside its own direct
    index. Returns each
    kernel's launches in the counted (first bridged) runs, by
    LaunchCount."""
    import torch

    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.keys import hash_values_uncached
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS, planned_capacity
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   SCORE_BF16, SCORE_I8,
                                                   TOPK_BF16, TOPK_I8)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed, cfg)
    docs = make_docs(n_docs, seed=seed)
    n_ticks = -(-n_docs // FRAMEWORK_BATCH)
    if n_ticks < 3:
        fail(f"the framework phase needs 3 ticks of {FRAMEWORK_BATCH} docs")
    # reserved_space n_docs + 64 plans one extent of <= 2^19 rows: one
    # top-k launch (or one score chunk) a search
    if planned_capacity(n_docs + 64) > _CHUNK_ROWS:
        fail(f"{n_docs} docs need more than one {_CHUNK_ROWS}-row chunk")
    metas = [Json({"path": f"/d{i}.txt"}) for i in range(n_docs)]
    rows = [(doc, metas[i], 2 * (i // FRAMEWORK_BATCH), 1)
            for i, doc in enumerate(docs)]
    keys = [hash_values_uncached("row", i, doc, metas[i])
            for i, doc in enumerate(docs)]
    qspec = framework_queries(docs, n_ticks, seed)
    q_times = sorted({t for t, _, _, _ in qspec})
    ticks = [docs[b:b + FRAMEWORK_BATCH]
             for b in range(0, n_docs, FRAMEWORK_BATCH)]
    counted = {}
    for label, ragged, dtype, max_len, kernels in (
            ("framework A", False, "bfloat16", BENCH_SEQ,
             (ATTENTION, TOPK_BF16, SCORE_BF16)),
            ("framework B", True, "int8", RAGGED_SEQ,
             (ATTENTION, TOPK_I8, SCORE_I8, QUANTIZE_SCATTER))):
        # bench's embedder (bench.py:1266-1276), and the same weights with
        # the embedder's default HashTokenizer
        embs = {"wordpiece": EncoderEmbedder(
                    config=cfg, params=params, ragged=ragged,
                    tokenizer=framework_tokenizer(max_len), max_len=max_len,
                    max_batch_size=FRAMEWORK_BATCH, device="cuda"),
                "hash": EncoderEmbedder(config=cfg, params=params,
                                        ragged=ragged, device="cuda")}
        stated = {}
        for name, emb in embs.items():
            # the counts the code gives, stated before the runs: one forward
            # a tick (padded: the tick's 2048 documents in one fused call;
            # ragged: one graph replay a packed chunk) and one a query batch
            # (ragged: a chunk); each search over one extent of <= 2^19 rows
            # takes the top-k kernel once, except the last tick's batch,
            # whose k = 80 query makes the whole batch fetch 80: the score
            # kernel once, then the key selection
            if ragged:
                widths = []
                ingest = sum(len(emb.pack_ragged(t)) for t in ticks)
                query = sum(len(emb.pack_ragged(
                    [text for t, text, _, _ in qspec if t == qt]))
                    for qt in q_times)
                for b in emb.ragged_buckets():
                    args, _ = emb.ragged_warmup_operands(b)
                    emb.ragged_device_producer(emb.model, *args)
            else:
                widths = sorted({emb.pack_tokens(t)[0].shape[1]
                                 for t in ticks})
                ingest, query = n_ticks, len(q_times)
                for w in emb.bucket_widths():
                    emb.device_producer(
                        emb.model, np.zeros((FRAMEWORK_BATCH, w), np.int16),
                        np.full(FRAMEWORK_BATCH, w, np.int32))
            expect = {ATTENTION: N_LAYERS * (ingest + query),
                      kernels[1]: len(q_times) - 1, kernels[2]: 1}
            if ragged:
                expect[QUANTIZE_SCATTER] = ingest
            stated[name] = (widths, ingest, query, expect)
        emb, hemb = embs["wordpiece"], embs["hash"]
        widths, ingest, query, expect = stated["wordpiece"]
        hwidths, hingest, hquery, hexpect = stated["hash"]

        def run(e, w, window, tag):
            return dict(framework_run(e, dtype, rows, qspec, w, window),
                        tag=tag)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # bridged, direct, direct, bridged (host-clock times drift between
        # consecutive runs, so each side is timed twice in mirrored order),
        # then the same at window 1; the first bridged run is the counted
        # one
        first = run(emb, widths, None, "bridged")
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        direct = framework_direct(emb, dtype, docs, keys, widths)
        direct2 = framework_direct(emb, dtype, docs, keys, widths)
        del direct2["index"]
        second = run(emb, widths, None, "bridged (again)")
        serial = run(emb, widths, 1, "window 1")
        runs = [first, second, serial]
        for r in runs:
            framework_holds(r, direct["index"], expect, ingest, query, emb,
                            docs, keys, qspec, f"{label} {r['tag']}")
            del r["index"]
        del direct["index"]
        hash_run = run(hemb, hwidths, 1, "HashTokenizer, window 1")
        hash_direct = framework_direct(hemb, dtype, docs, keys, hwidths)
        framework_holds(hash_run, hash_direct["index"], hexpect, hingest,
                        hquery, hemb, docs, keys, qspec,
                        f"{label} HashTokenizer")
        del hash_run["index"], hash_direct["index"]
        for r in (direct, direct2, hash_direct):
            if r["captures"]:
                fail(f"{label}: {r['captures']} CUDA graphs captured inside "
                     "a direct run's timed window")
        br = first["bridge"]
        if first["inflight"] != 2:
            fail(f"{label}: the bridged runs ran at window "
                 f"{first['inflight']}, not bench's default 2")
        print(f"[{label}] bench.py's keys ({n_docs} docs in {n_ticks} ticks "
              f"of {FRAMEWORK_BATCH} through VectorStoreServer(...)."
              f"retrieve_query under GraphRunner.run_batch, {dtype} cos index;"
              f" bench's WordPiece tokenizer, native engine; warmed through "
              f"the built index; run_batch + drain() timed): "
              f"framework_docs_per_s {n_docs / first['wall']:.1f}, "
              f"framework_device_inflight {first['inflight']}, "
              f"framework_bridge_legs {br['legs_resolved']}, "
              f"framework_bridge_overlap_ratio {br['overlap_ratio']:.3f}, "
              f"framework_bridge_queue_wait_ms {br['queue_wait_ms']} "
              f"[{card}]", flush=True)
        engine_s = first["wall"] + second["wall"]
        direct_s = direct["wall"] + direct2["wall"]
        print(f"[{label}] in the order bridged, direct, direct, bridged, "
              f"window 1: framework_docs_per_s {n_docs / first['wall']:.1f} "
              f"and {n_docs / second['wall']:.1f}; direct add_batch "
              f"{n_docs / direct['wall']:.1f} and "
              f"{n_docs / direct2['wall']:.1f} docs/s; bridged / direct "
              f"docs/s over both {direct_s / engine_s:.4f}; at window 1 "
              f"{n_docs / serial['wall']:.1f} docs/s (bridged / window 1 "
              f"{serial['wall'] / (engine_s / 2):.4f}); then the default "
              f"HashTokenizer at window 1: framework_hash_serial_docs_per_s "
              f"{n_docs / hash_run['wall']:.1f}, direct "
              f"{n_docs / hash_direct['wall']:.1f} docs/s; peak device "
              f"memory in the counted run {peak_mb:.1f} MiB [{card}]",
              flush=True)
        for r in runs + [hash_run]:
            print(f"[{label}] {r['tag']}: "
                  + framework_line(r, n_docs, n_ticks), flush=True)
        ops = sorted(first["op_s"].items(), key=lambda kv: -kv[1])
        print(f"[{label}] host time by operator step in the counted run (ms"
              f" a tick, {n_ticks} ticks; the index's steps include its "
              f"device waits): " + ", ".join(
                  f"{name} {s / n_ticks * 1e3:.3f}" for name, s in ops),
              flush=True)
        launches = {c: n for c, n in first["launches"].items() if n}
        print(f"[{label}] launches inside the counted run_batch: " + ", ".join(
            f"{c.name} {n}" for c, n in launches.items())
            + "; stated from the code: " + ", ".join(
                f"{c.name} {n}" for c, n in expect.items())
            + f" ({ingest} ingest + {query} query encoder dispatches; "
              f"dispatches counted {first['dispatches']}, graph replays "
              f"{first['replays']}); in every run (bridged twice, window 1, "
              f"HashTokenizer): launches as stated, the engine-built index "
              f"equal bit for bit to the direct add_batch's with the same "
              f"tokenizer, no graph captured in a timed window (direct "
              f"runs: {direct['captures']} / {direct2['captures']} / "
              f"{hash_direct['captures']})", flush=True)
        counted.update({c: launches.get(c, 0) for c in kernels[1:]})
        counted[(ATTENTION, ragged)] = launches.get(ATTENTION, 0)
        del emb, hemb, embs
        gc.collect()
        torch.cuda.empty_cache()
    return counted


SERVING_N = 100_000     # bench.py's SERVING_N: graph A's vectors, B's docs
SERVING_DIM = 384       # bench.py's SERVING_DIM
SERVING_WARMUP, SERVING_QUERIES = 8, 48  # bench.py's defaults
SERVING_TRICKLE = 64    # rows a trickle burst, one burst every 20 ms
HELD_QUERIES = 8


class GraphCaptures:
    """Counts CUDA graph captures (``torch.cuda.CUDAGraph.capture_begin``)
    made in any thread while the ``with`` block runs."""

    def __enter__(self):
        import torch

        self.n = 0
        self._cls = torch.cuda.CUDAGraph
        self._orig = self._cls.capture_begin
        orig = self._orig

        def counted(graph, *args, **kwargs):
            self.n += 1
            return orig(graph, *args, **kwargs)

        self._cls.capture_begin = counted
        return self

    def __exit__(self, *exc):
        self._cls.capture_begin = self._orig


class Served:
    """One served graph: ``start()`` (``pw.run``, or ``run_server(
    threaded=True)`` returning its thread) on a daemon thread, with
    ``PATHWAY_FLIGHT_RECORDER=1`` set for the run, as bench.py's serving
    leg sets it. ``stop()`` stops it through ``stop_all()``, joins for 15
    s as bench.py does, and fails the phase when a thread outlives the
    join or the run raised (its error re-raised)."""

    def __init__(self, label: str, start):
        import threading

        from pathway_tpu_torch.engine.threads import crash_epoch

        self.label = label
        self.errors: list = []
        self._saved = os.environ.get("PATHWAY_FLIGHT_RECORDER")
        os.environ["PATHWAY_FLIGHT_RECORDER"] = "1"
        self._epoch = crash_epoch()
        self._inner = None

        def run():
            try:
                out = start()
                if isinstance(out, threading.Thread):
                    # run_server(threaded=True)'s thread
                    self._inner = out
                    out.join()
            except BaseException as e:  # noqa: BLE001 — re-raised by stop
                self.errors.append(e)

        self.thread = threading.Thread(target=run, daemon=True,
                                       name=f"smoke-{label}")
        self.thread.start()

    def check(self) -> None:
        from pathway_tpu_torch.engine.threads import crashed_threads

        if self.errors:
            raise self.errors[0]
        crashes = crashed_threads(self._epoch)
        if crashes:
            fail(f"{self.label}: an engine thread died: {crashes}")

    def runtime(self, ws, timeout: float = 600.0):
        """The live StreamingRuntime once ``ws`` serves."""
        from pathway_tpu_torch.engine import streaming

        deadline = time.monotonic() + timeout
        while True:
            self.check()
            live = list(streaming._ACTIVE_RUNTIMES)
            if live and ws._started.is_set() and ws.port:
                return live[0]
            if time.monotonic() > deadline:
                fail(f"{self.label}: the served runtime never started")
            time.sleep(0.05)

    def stop(self) -> None:
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G

        try:
            streaming.stop_all()
            self.thread.join(15.0)
        finally:
            G.clear()
            os.environ.pop("PATHWAY_FLIGHT_RECORDER", None)
            if self._saved is not None:
                os.environ["PATHWAY_FLIGHT_RECORDER"] = self._saved
        if self.thread.is_alive() or (self._inner is not None
                                      and self._inner.is_alive()):
            fail(f"{self.label}: the run outlived stop_all() by 15 s")
        self.check()


def wait_for(cond, what: str, served: Served, timeout: float = 600.0):
    deadline = time.monotonic() + timeout
    while not cond():
        served.check()
        if time.monotonic() > deadline:
            fail(f"{served.label}: timed out waiting for {what}")
        time.sleep(0.01)


def post_json(url: str, payload, timeout: float = 120.0):
    """One POST through urllib, as bench.py's client sends it: (reply,
    client ms)."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
    return json.loads(body), (time.perf_counter() - t0) * 1e3


def ingested_rows(rt, name: str) -> int:
    """bench.py's serving_ingested_rows: the insertions the scheduler
    counted on the source node named ``name``."""
    return sum(st.get("insertions", 0) for nid, st in rt.scheduler.stats.items()
               if rt.runner.graph.nodes[nid].name == name)


def span_keys(spans: list, client_ms: list, tracker, prefix: str) -> dict:
    """bench.py's serving keys over the timed window's spans (its names,
    its count-based slicing, its exact percentiles), and every span's
    stages held to sum to its e2e."""
    from pathway_tpu_torch.engine.request_tracker import STAGES

    for r in spans:
        gap = abs(sum(r["stages"].values()) - r["e2e_ms"])
        if gap > 0.01:
            fail(f"{prefix}: span {r['request_id']}'s stages sum "
                 f"{gap:.3f} ms off its e2e")
    e2e = np.array([r["e2e_ms"] for r in spans])
    over_budget = int(np.sum(e2e > tracker.slo_ms))
    out = {
        "knn_p50_e2e_ms": round(float(np.percentile(e2e, 50)), 2),
        "knn_p95_e2e_ms": round(float(np.percentile(e2e, 95)), 2),
        "knn_p99_e2e_ms": round(float(np.percentile(e2e, 99)), 2),
        "serving_client_p50_ms": round(float(np.percentile(client_ms, 50)),
                                       2),
        "serving_client_p99_ms": round(float(np.percentile(client_ms, 99)),
                                       2),
        "serving_n_queries": len(spans),
        "serving_slo_ms": tracker.slo_ms,
        "serving_slo_burn_rate": round(
            (over_budget / len(e2e)) / tracker.error_budget, 3),
        "serving_over_budget": over_budget,
    }
    for stage in STAGES:
        vals = np.array([r["stages"][stage] for r in spans])
        out[f"serving_stage_{stage}_p50_ms"] = round(
            float(np.percentile(vals, 50)), 3)
    return out


def window_attribution(rec, before: dict, tick0: int) -> str:
    """Where a window's engine time went, from the flight recorder: each
    operator's steps since ``before`` (its op_stats then) by total ms,
    and the device legs of ticks after ``tick0`` (p50 execution and queue
    wait on the bridge)."""
    rows = []
    for st in rec.op_stats():
        n0, ms0 = before.get(st["id"], (0, 0.0))
        if st["count"] > n0:
            rows.append((st["sum_ms"] - ms0, st["count"] - n0, st["name"]))
    rows.sort(reverse=True)
    legs = [(q, e) for t, q, e in list(rec._legs) if t > tick0]
    out = "; ".join(f"{name} {n} steps, {ms / n:.3f} ms mean, {ms:.1f} ms"
                    for ms, n, name in rows[:8])
    if legs:
        qs, es = np.array(legs).T
        out += (f"; {len(legs)} device legs: execution p50 "
                f"{np.percentile(es, 50):.3f} ms, p99 "
                f"{np.percentile(es, 99):.3f} ms, queue wait p50 "
                f"{np.percentile(qs, 50):.3f} ms")
    return out


def timed_window(served: Served, rt, ask, inputs: list, prefix: str):
    """bench.py's client loop: SERVING_WARMUP requests, then
    SERVING_QUERIES timed ones; returns (replies, client ms, the timed
    window's spans, graphs captured inside it, the window's attribution
    by operator and device leg)."""
    tracker = rt.recorder.requests
    for x in inputs[:SERVING_WARMUP]:
        ask(x)
    n_warm = tracker.count
    before = {st["id"]: (st["count"], st["sum_ms"])
              for st in rt.recorder.op_stats()}
    tick0 = rt._last_completed_tick
    with GraphCaptures() as captures:
        timed = [ask(x) for x in inputs[SERVING_WARMUP:]]
    served.check()
    where = window_attribution(rt.recorder, before, tick0)
    n_timed = tracker.count - n_warm
    spans = tracker.trace_spans()[-n_timed:] if n_timed else []
    if len(spans) != SERVING_QUERIES:
        fail(f"{prefix}: {len(spans)} timed request spans completed, not "
             f"{SERVING_QUERIES}")
    return ([r for r, _ in timed], [ms for _, ms in timed], spans,
            captures.n, where)


def phase_serving_knn(card: str, n_vecs: int = SERVING_N) -> dict:
    """Graph A, bench.py's ``bench_serving`` (bench.py:1280-1453) as it
    builds it, in the port: an ``IngestSubject`` pushes ``n_vecs``
    vectors of 384 f32 (``rng(1)``, chunks of 4096, 2 ms between chunks)
    and then trickles 64 every 20 ms, through ``pw.io.python.read(...,
    autocommit_duration_ms=10)`` into ``default_brute_force_knn_document_
    index(data.v, data, dimensions=384, reserved_space=n + 65536,
    dtype="bfloat16")`` on the card; ``POST /query`` on a
    ``PathwayWebserver`` (port 0) through ``rest_connector(...,
    delete_completed_queries=True, autocommit_duration_ms=5)`` and
    ``query_as_of_now(qv, number_of_matches=k)`` (K2 on every query tick),
    answered as ``n_matches``; ``pw.run`` on a daemon thread with the
    flight recorder on. 8 warm-up and 48 timed POSTs of ``rng(2)``
    vectors, k=10, through urllib. Prints bench.py's keys; holds every
    reply's n_matches, the spans' stage sums, the ingested rows, K2's
    launches and no graph captured in the timed window. Returns the
    run's launches by LaunchCount."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector
    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn_kernels import TOPK_BF16
    from pathway_tpu_torch.stdlib.indexing import \
        default_brute_force_knn_document_index

    label = "serving A"
    dim = SERVING_DIM
    loaded = threading.Event()

    class IngestSubject(ConnectorSubject):
        """bench.py's: bulk-load the slab, then keep trickling inserts so
        every timed query is answered under live ingest."""

        def run(self):
            rng = np.random.default_rng(1)
            chunk = 4096
            pushed = 0
            while pushed < n_vecs:
                m = min(chunk, n_vecs - pushed)
                for v in rng.random((m, dim), np.float32) * 2.0 - 1.0:
                    self.next(v=v)
                pushed += m
                if not self._session.sleep(0.002):
                    return
            loaded.set()
            while not self._session.stop_requested:
                for v in rng.random((SERVING_TRICKLE, dim),
                                    np.float32) * 2.0 - 1.0:
                    self.next(v=v)
                if not self._session.sleep(0.02):
                    return

    G.clear()
    data = pw.io.python.read(
        IngestSubject(), schema=pw.schema_from_types(v=np.ndarray),
        autocommit_duration_ms=10, name="serving_ingest")
    index = default_brute_force_knn_document_index(
        data.v, data, dimensions=dim, reserved_space=n_vecs + (64 << 10),
        dtype="bfloat16")
    ws = PathwayWebserver(host="127.0.0.1", port=0)
    queries, writer = rest_connector(
        webserver=ws, route="/query",
        schema=pw.schema_from_types(vec=dt.ANY, k=int), methods=("POST",),
        delete_completed_queries=True, autocommit_duration_ms=5)
    qv = queries.select(
        qv=pw.apply(lambda v: np.asarray(v, dtype=np.float32), queries.vec),
        k=queries.k)
    res = index.query_as_of_now(qv.qv, number_of_matches=qv.k)
    writer(res.select(n_matches=pw.apply(len, res._pw_index_reply_id)))

    for count in LAUNCH_COUNTS:
        count.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = Served(label, pw.run)
    try:
        rt = served.runtime(ws)
        wait_for(loaded.is_set, f"the {n_vecs}-vector bulk load", served)
        load_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{ws.port}/query"
        qvecs = np.random.default_rng(2).random(
            (SERVING_WARMUP + SERVING_QUERIES, dim), np.float32) * 2.0 - 1.0
        replies, client_ms, spans, captures, where = timed_window(
            served, rt, lambda v: post_json(url, {
                "vec": [float(x) for x in v], "k": 10}),
            list(qvecs), label)
        tracker = rt.recorder.requests
        ingested = ingested_rows(rt, "serving_ingest")
        bridge = rt.scheduler.bridge_stats()
    finally:
        served.stop()
    launches = {c: c.launches for c in LAUNCH_COUNTS}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # one column written back: each reply is its n_matches value
    bad = [r for r in replies if r != 10]
    if bad:
        fail(f"{label}: {len(bad)} timed replies without 10 matches: "
             f"{bad[:3]}")
    keys = span_keys(spans, client_ms, tracker, label)
    keys.update({"serving_n_vectors": n_vecs,
                 "serving_ingested_rows": int(ingested),
                 "serving_dim": dim})
    if ingested < n_vecs:
        fail(f"{label}: serving_ingested_rows {ingested} < {n_vecs}")
    if launches[TOPK_BF16] < SERVING_QUERIES:
        fail(f"{label}: K2 launched {launches[TOPK_BF16]} times in the run, "
             f"fewer than the {SERVING_QUERIES} timed queries")
    if captures:
        fail(f"{label}: {captures} CUDA graphs captured in the timed window")
    print(f"[{label}] bench.py's keys (bench_serving's graph in the port: "
          f"{n_vecs} x {dim} vectors into a bf16 cos index under live "
          f"ingest, POST /query through rest_connector, {SERVING_WARMUP} "
          f"warm-up + {SERVING_QUERIES} timed queries, k=10): "
          + json.dumps(keys) + f" [{card}]", flush=True)
    print(f"[{label}] holds: every reply n_matches 10, every timed span's "
          f"six stages sum to its e2e within 0.01 ms, serving_ingested_rows "
          f"{ingested} >= {n_vecs}, K2 launched {launches[TOPK_BF16]} times "
          f"in the run (>= {SERVING_QUERIES}), {captures} CUDA graphs "
          f"captured in the timed window; bulk load {load_s:.1f} s "
          f"({n_vecs / load_s:.1f} rows/s to the last chunk pushed); bridge "
          f"legs {bridge['legs_resolved']}, queue wait "
          f"{bridge['queue_wait_ms']:.1f} ms, leg execution "
          f"{bridge['exec_ms']:.1f} ms; launches in the run: "
          + ", ".join(f"{c.name} {n}" for c, n in launches.items() if n)
          + f"; peak device memory {peak_mb:.1f} MiB [{card}]", flush=True)
    print(f"[{label}] the timed window by operator (flight recorder; host "
          f"clock, a device-leg step includes its waits on the card): "
          f"{where} [{card}]", flush=True)
    return launches


def phase_serving_rag(seed: int, card: str, n_docs: int = SERVING_N) -> dict:
    """Graph B, a live RAG server: ``VectorStoreServer(docs, embedder=emb,
    index_builder=... default_brute_force_knn_document_index(chunks.text,
    chunks, embedder=emb, dimensions=384, reserved_space=n + 64,
    dtype="bfloat16")).run_server(threaded=True)`` (configuration A of
    phase_framework: bench's embedder, padded, max_len 128, bench's
    WordPiece with the native engine asserted; a bf16 cos index), its
    documents ``n_docs`` ``make_docs`` texts from a ``ConnectorSubject``
    (schema ``data: str``) in chunks of 2048, then 64 every 20 ms. Every
    ingest shape is warmed through the built index before the documents
    flow (``framework_warm``). 8 warm-up and 48 timed ``POST /v1/retrieve
    {"query": <make_docs text>, "k": 3, "metadata_filter": null,
    "filepath_globpattern": null}`` (the schema has no defaults for the
    two filters: a body without them is a 400 in both packages); then the
    trickle paused and a tick let pass, 8 held retrieves and one k=80
    (K2's score twin past K_MAX), each reply held against a plain scan of
    the index's own rows with the engine's query embedding (and that
    embedding against the plain encoder) as ``hold_framework`` holds
    framework A; ``/v1/statistics``'s file_count against the documents
    pushed, ``/v1/inputs``, and ``VectorStoreClient`` against the raw
    POST. Prints the retrieve latencies, the tracker's e2e and stage
    p50s, ingest docs/s, launches and peak memory. Returns the run's
    launches by LaunchCount."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
    from pathway_tpu_torch.internals import udfs
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.models.encoder import (EncoderConfig, encode,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION, attention_reference
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, TOPK_BF16,
                                                   score_float_reference)
    from pathway_tpu_torch.stdlib.indexing import \
        default_brute_force_knn_document_index
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import (VectorStoreClient,
                                                           VectorStoreServer)

    label = "serving B"
    cfg = EncoderConfig.bge_small()
    emb = EncoderEmbedder(
        config=cfg, params=init_params_host(seed, cfg),
        tokenizer=framework_tokenizer(BENCH_SEQ), max_len=BENCH_SEQ,
        max_batch_size=FRAMEWORK_BATCH, device="cuda")
    docs = make_docs(n_docs, seed=seed)
    go, loaded = threading.Event(), threading.Event()
    pause, paused = threading.Event(), threading.Event()

    class DocSubject(ConnectorSubject):
        """The documents, then the trickle until paused. Keeps the engine
        key of every document it pushes (its ``_emit`` is
        ConnectorSubject's, recording the key), for the holds."""

        def __init__(self):
            self.key_of: dict = {}
            self.pushed: list = []

        def _emit(self, values: dict, diff: int) -> None:
            key, row = self._source.row_to_engine(values,
                                                  self._source.bump_seq())
            self.key_of[values["data"]] = key
            self.pushed.append(values["data"])
            self._session.push(key, row, diff)

        def run(self):
            while not go.wait(0.05):
                if self._session.stop_requested:
                    return
            for b in range(0, n_docs, FRAMEWORK_BATCH):
                for d in docs[b:b + FRAMEWORK_BATCH]:
                    self.next(data=d)
                if not self._session.sleep(0.002):
                    return
            loaded.set()
            burst = 0
            while not pause.is_set():
                for d in make_docs(SERVING_TRICKLE, seed=seed + 1000 + burst):
                    self.next(data=d)
                burst += 1
                if not self._session.sleep(0.02):
                    return
            paused.set()

    G.clear()
    subject = DocSubject()
    source = pw.io.python.read(subject, schema=pw.schema_from_types(data=str),
                               autocommit_duration_ms=10, name="docs")
    store = VectorStoreServer(
        source, embedder=emb,
        index_builder=lambda chunks: default_brute_force_knn_document_index(
            chunks.text, chunks, embedder=emb,
            dimensions=emb.get_embedding_dimension(),
            reserved_space=n_docs + 64, dtype="bfloat16"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = Served(label, lambda: store.run_server(
        host="127.0.0.1", port=0, threaded=True))
    ask_none = {"metadata_filter": None, "filepath_globpattern": None}
    try:
        wait_for(lambda: hasattr(store, "webserver"), "run_server", served)
        rt = served.runtime(store.webserver)
        base = f"http://127.0.0.1:{store.webserver.port}"
        index = next(n.op.index for n in rt.runner.graph.nodes
                     if isinstance(n.op, ExternalIndexOperator))
        inner = index.inner
        # bench's warm-up through the built index, before any document
        framework_warm(index, emb, list(emb.bucket_widths()))
        searches = []
        inner_search = inner.search

        def search(batch):
            replies = inner_search(batch)
            searches.append(batch)
            return replies

        inner.search = search
        for count in LAUNCH_COUNTS:
            count.launches = 0
        t_go = time.perf_counter()
        go.set()
        wait_for(lambda: len(inner._key_to_slot) >= n_docs,
                 f"{n_docs} documents in the index", served)
        ingest_s = time.perf_counter() - t_go
        ingest_rows = len(inner._key_to_slot)
        texts = make_docs(SERVING_WARMUP + SERVING_QUERIES, seed=seed + 7)
        replies, client_ms, spans, captures, where = timed_window(
            served, rt, lambda t: post_json(base + "/v1/retrieve", {
                "query": t, "k": 3, **ask_none}), texts, label)
        tracker = rt.recorder.requests
        # the trickle paused, then a tick let pass: every pushed document
        # is in the index before the held queries' tick
        pause.set()
        wait_for(paused.is_set, "the trickle to pause", served)
        wait_for(lambda: ingested_rows(rt, "docs") >= len(subject.pushed),
                 "the last documents' tick", served)
        tick = rt._last_completed_tick
        wait_for(lambda: rt.scheduler.bridge_stats()["resolved_watermark"]
                 > tick, "a tick after the last documents", served)
        rows = len(inner._key_to_slot)
        if rows != len(subject.pushed):
            fail(f"{label}: the index holds {rows} rows of the "
                 f"{len(subject.pushed)} documents pushed")
        rng = np.random.default_rng(seed + 8)
        held = [(subject.pushed[int(i)], 3) for i in
                rng.choice(len(subject.pushed), HELD_QUERIES // 2, False)]
        held += [(t, 3) for t in make_docs(HELD_QUERIES // 2, seed + 9)]
        held.append((subject.pushed[n_docs // 2], 80))
        s0 = len(searches)
        held_replies = [post_json(base + "/v1/retrieve", {
            "query": t, "k": k, **ask_none})[0] for t, k in held]
        held_searches = searches[s0:]
        raw = post_json(base + "/v1/retrieve",
                        {"query": held[0][0], "k": 3, **ask_none})[0]
        stats = post_json(base + "/v1/statistics", {})[0]
        inputs = post_json(base + "/v1/inputs", ask_none)[0]
        client = VectorStoreClient(url=base, timeout=120)
        via_client = client.query(held[0][0], k=3)
        extents = [e for e in inner._pool.extents if e.established]
        base_slot = np.concatenate([e.base + np.arange(e.rows)
                                    for e in extents])
        keys_of = np.array([int(inner._slot_to_key.get(int(s), -1))
                            for s in base_slot])
        valid = torch.cat([e.valid for e in extents])
        slab = torch.cat([e.vectors for e in extents])
        bridge = rt.scheduler.bridge_stats()
    finally:
        served.stop()
        # run_server(with_cache=True) set the process-wide UDF cache
        udfs.set_default_cache(None)
    launches = {c: c.launches for c in LAUNCH_COUNTS}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    bad = [r for r in replies if len(r) != 3]
    if bad:
        fail(f"{label}: {len(bad)} timed replies without 3 matches")
    keys = span_keys(spans, client_ms, tracker, label)
    if captures:
        fail(f"{label}: {captures} CUDA graphs captured in the timed window")
    # the held replies against a plain scan of the index's own rows
    if len(held_searches) != len(held) or any(len(b) != 1
                                              for b in held_searches):
        fail(f"{label}: the {len(held)} held queries made "
             f"{len(held_searches)} searches, not one each")
    got_q = np.stack([np.asarray(b[0][1], np.float64) for b in held_searches])
    ids, lens = emb.pack_tokens([t for t, _ in held])
    ids_d = torch.from_numpy(ids).to(slab.device).long()
    lens_d = torch.from_numpy(lens).to(slab.device)
    mask = torch.arange(ids_d.shape[1], device=slab.device)[None, :] \
        < lens_d[:, None]
    ref_q = encode(emb.model, ids_d, mask, attn_fn=attention_reference
                   ).cpu().numpy().astype(np.float64)
    q_cos = np.sum(got_q * ref_q, 1) / (np.linalg.norm(got_q, axis=1)
                                        * np.linalg.norm(ref_q, axis=1))
    if not np.all(np.isfinite(got_q)) or q_cos.min() < 0.999:
        fail(f"{label}: a held query's embedding is off the plain encoder's "
             f"(min row cosine {q_cos.min():.6f})")
    own_first = 0
    for qi, ((text, k), reply, batch) in enumerate(
            zip(held, held_replies, held_searches)):
        if len(reply) != k:
            fail(f"{label} held query {qi}: {len(reply)} matches, not {k}")
        if any(m["text"] not in subject.key_of for m in reply):
            fail(f"{label} held query {qi}: a match is no pushed document")
        got = [(subject.key_of[m["text"]], m["dist"]) for m in reply]
        q = torch.from_numpy(np.asarray(batch[0][1], np.float32)).to(
            slab.device)
        q = (q / (torch.linalg.vector_norm(q) + 1e-12))[None, :]
        scan = score_float_reference(q.to(torch.bfloat16).float(), slab,
                                     valid, "cos")
        check_top10([got], scan, keys_of, f"{label} held query {qi}", n=k)
        cols = [int(np.flatnonzero(keys_of == int(kk))[0]) for kk, _ in got]
        want = 1.0 - scan[0, cols].cpu().numpy()
        err = float(np.abs(np.array([d for _, d in got]) - want).max())
        if not err <= 1e-5:
            fail(f"{label} held query {qi}: dist off the scan by {err:.3e}")
        if text in subject.key_of:
            if reply[0]["text"] != text:
                fail(f"{label} held query {qi}: a copy of a pushed document "
                     "does not find it first")
            own_first += 1
    if stats.get("file_count") != len(subject.pushed):
        fail(f"{label}: /v1/statistics file_count {stats.get('file_count')}, "
             f"{len(subject.pushed)} documents pushed")
    if not isinstance(inputs, list) or len(inputs) != len(subject.pushed):
        fail(f"{label}: /v1/inputs lists {len(inputs)} inputs")
    if via_client != raw:
        fail(f"{label}: VectorStoreClient's reply differs from the raw POST's")
    for c in (ATTENTION, TOPK_BF16, SCORE_BF16):
        if not launches[c]:
            fail(f"{label}: {c.name} was not launched in the served run")
    print(f"[{label}] run_server(threaded=True) over {n_docs} make_docs "
          f"documents + the trickle ({len(subject.pushed)} pushed, "
          f"{len(extents)} extents), bench's embedder (WordPiece, native; "
          f"padded, max_len {BENCH_SEQ}) into a bf16 cos index: ingest "
          f"{ingest_rows / ingest_s:.1f} docs/s ({ingest_rows} index rows "
          f"{ingest_s:.2f} s after the first document); /v1/retrieve k=3 "
          f"from the client p50 {keys['serving_client_p50_ms']} ms, p99 "
          f"{keys['serving_client_p99_ms']} ms; the tracker's keys: "
          + json.dumps(keys) + f" [{card}]", flush=True)
    print(f"[{label}] holds: {len(held)} held retrieves (k=3 x "
          f"{HELD_QUERIES}, k=80 x 1) equal a plain scan of the index's own "
          f"rows (score_float_reference, keys in rank order up to 1e-6 score "
          f"ties, dist within 1e-5), their query embeddings the plain "
          f"encoder's (min row cosine {q_cos.min():.6f} >= 0.999), "
          f"{own_first} copies find their document first; /v1/statistics "
          f"file_count {stats['file_count']} = documents pushed; "
          f"/v1/inputs {len(inputs)} inputs; VectorStoreClient's reply = the "
          f"raw POST's; {captures} CUDA graphs captured in the timed window;"
          f" bridge legs {bridge['legs_resolved']}, queue wait "
          f"{bridge['queue_wait_ms']:.1f} ms, leg execution "
          f"{bridge['exec_ms']:.1f} ms; launches in the run: "
          + ", ".join(f"{c.name} {n}" for c, n in launches.items() if n)
          + f"; peak device memory {peak_mb:.1f} MiB [{card}]", flush=True)
    print(f"[{label}] the timed window by operator (flight recorder; host "
          f"clock, a device-leg step includes its waits on the card): "
          f"{where} [{card}]", flush=True)
    return launches


# (D, rows a tick, groups a tick, rows of one large group): each case runs
# two ticks over the same groups; groups 0 means one group of the last
# field's rows beside singletons (a skewed tick)
ARRAY_SUM_CASES = (
    (384, 512, 256, 0), (384, 4096, 4096, 0), (384, 4096, 256, 0),
    (384, 4096, 16, 0), (384, 4096, 1, 0), (384, 4096, 0, 128),
    (384, 32768, 16384, 0), (384, 32768, 1, 0), (64, 16384, 8192, 0),
)


class ArraySumRoute:
    """Sets GroupByOperator's array_sum route while installed: "host" (the
    per-row numpy loop), "device" (``device_segsum`` on the card for every
    tick, whatever its size and shape) or "rule" (``device_segsum`` for
    the ticks ``_segsum_pays`` admits, whatever their size)."""

    def __init__(self, route: str):
        self.route = route

    def __enter__(self):
        from pathway_tpu_torch.engine import operators as ops

        self.saved = (ops._array_sum_device_min, ops._ARRAY_SUM_MAX_POSITIONS,
                      ops._ARRAY_SUM_MAX_PADDING)
        ops._array_sum_device_min = (lambda: 0) if self.route == "host" \
            else (lambda: 1)
        if self.route == "device":
            ops._ARRAY_SUM_MAX_POSITIONS = ops._ARRAY_SUM_MAX_PADDING = 1 << 62
        return self

    def __exit__(self, *exc):
        from pathway_tpu_torch.engine import operators as ops

        (ops._array_sum_device_min, ops._ARRAY_SUM_MAX_POSITIONS,
         ops._ARRAY_SUM_MAX_PADDING) = self.saved


def array_sum_run(gids: np.ndarray, vecs: np.ndarray, route: str) -> dict:
    """``groupby(g).reduce(g, a=npsum(v))`` over two ticks of
    ``len(gids) // 2`` rows under ``GraphRunner.run_batch``; returns the
    events (arrays as bytes), ``device_segsum``'s calls and host ms a
    tick: the GroupByOperator's step, within it the device route's
    pre-pass (``_device_array_sums``: gather, pad, upload, the adds,
    download) and the per-row loop's adds (``_ArraySumState.add``), the
    work the pre-pass replaces."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.engine import reducers
    from pathway_tpu_torch.internals.runner import GraphRunner

    r = len(gids) // 2
    t = table_from_rows(pw.schema_from_types(g=int, v=np.ndarray),
                        [(int(g), v, 2 * (i // r), 1)
                         for i, (g, v) in enumerate(zip(gids, vecs))],
                        is_stream=True)
    runner = GraphRunner()
    cap = runner.capture(t.groupby(t.g).reduce(t.g, a=pw.reducers.npsum(t.v)))
    op = next(n.op for n in runner.graph.nodes
              if isinstance(n.op, ops.GroupByOperator))
    spent = {"step": 0.0, "pre-pass": 0.0, "adds": 0.0, "calls": 0}
    segsum, add = ops.device_segsum, reducers._ArraySumState.add

    def timer(fn, name):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] += time.perf_counter() - t0
            return out
        return call

    def counted(*args):
        spent["calls"] += 1
        return segsum(*args)

    op.step = timer(op.step, "step")
    op._device_array_sums = timer(op._device_array_sums, "pre-pass")
    ops.device_segsum = counted
    reducers._ArraySumState.add = timer(add, "adds")
    gc.collect()
    try:
        with ArraySumRoute(route):
            runner.run_batch(n_workers=1)
    finally:
        ops.device_segsum, reducers._ArraySumState.add = segsum, add
    out = {k: v / 2 * 1e3 for k, v in spent.items() if k != "calls"}
    out["calls"] = spent["calls"]
    out["events"] = sorted(
        (int(k), row[0], row[1].dtype.str, row[1].tobytes(), tt, d)
        for k, row, tt, d in cap.events)
    return out


def phase_array_sum(seed: int, card: str) -> None:
    """GroupByOperator's array_sum route: ``device_segsum`` (the torch
    form of the JAX package's ``_device_segsum_fn``: one in-order f32 add
    launch a row position over the padded (G, M, D) rows) on the card,
    bit for bit against the sequential numpy loop; then, for each case of
    ARRAY_SUM_CASES, the route forced on ("device") and off ("host") in
    the order device, host, host, device, and once under the rule alone
    ("rule"): the operator's host ms a tick, the device route's pre-pass
    and the per-row adds it replaces. Every run's events must be equal bit
    for bit, and each run must call ``device_segsum`` as its route says.
    The route is off by default (``PATHWAY_ARRAY_SUM_DEVICE_MIN`` 0)."""
    import torch

    from pathway_tpu_torch.engine import operators as ops

    rng = np.random.default_rng(seed + 4)
    for g, m, d in ((1, 4096, 384), (2048, 2, 384), (7, 300, 1041)):
        padded = rng.standard_normal((g, m, d)).astype(np.float32)
        padded[:, -1, ::3] = -0.0
        init = rng.standard_normal((g, d)).astype(np.float32)
        init[0, 0] = -0.0
        got = ops.device_segsum(torch.from_numpy(padded).cuda(),
                                torch.from_numpy(init).cuda()).cpu().numpy()
        acc = init.copy()
        for p in range(m):
            acc = acc + padded[:, p]
        if got.tobytes() != acc.tobytes():
            fail(f"array_sum: device_segsum at ({g}, {m}, {d}) differs from "
                 "the sequential host loop")
    print("[array_sum] device_segsum on the card at (G, M, D) in (1, 4096, "
          "384), (2048, 2, 384), (7, 300, 1041): bit for bit the sequential "
          "numpy loop", flush=True)
    for d, r, groups, big in ARRAY_SUM_CASES:
        if groups:
            tick = rng.permutation(np.arange(r) % groups)
        else:
            tick = np.concatenate([np.zeros(big, np.int64),
                                   np.arange(1, r - big + 1)])
            rng.shuffle(tick)
        gids = np.concatenate([tick, rng.permutation(tick)])
        g_n = len(np.unique(tick))
        m = int(np.bincount(tick).max())
        vecs = rng.standard_normal((2 * r, d)).astype(np.float32)
        vecs[::7, 1] = -0.0
        runs = {}
        for route in ("device", "host", "host", "device", "rule"):
            runs.setdefault(route, []).append(array_sum_run(gids, vecs, route))
        want = {"device": 2, "host": 0,
                "rule": 2 * ops._segsum_pays(r, g_n, m)}
        ref = runs["host"][0]["events"]
        if any(x["events"] != ref for rs in runs.values() for x in rs):
            fail(f"array_sum D={d} R={r} G={g_n}: the routes' events differ")
        if any(x["calls"] != want[k] for k, rs in runs.items() for x in rs):
            fail(f"array_sum D={d} R={r} G={g_n}: device_segsum calls "
                 f"{[(k, [x['calls'] for x in v]) for k, v in runs.items()]}"
                 f", the routes name {want}")
        dev, host = runs["device"], runs["host"]
        print(f"[array_sum] D={d} R={r} rows a tick in G={g_n} groups, "
              f"longest M={m} (padded {g_n * m * d * 4 / 2**20:.1f} MiB); "
              f"host ms a tick: GroupByOperator step, device route "
              f"{dev[0]['step']:.3f} / {dev[1]['step']:.3f}, per-row loop "
              f"{host[0]['step']:.3f} / {host[1]['step']:.3f}; the device "
              f"route's pre-pass {dev[0]['pre-pass']:.3f} / "
              f"{dev[1]['pre-pass']:.3f} against the per-row adds it "
              f"replaces {host[0]['adds']:.3f} / {host[1]['adds']:.3f}; the "
              f"rule takes the {'device' if want['rule'] else 'host'} route "
              f"({runs['rule'][0]['step']:.3f}); events bit for bit equal "
              f"[{card}]", flush=True)


def check_top10(results, scan_scores, keys_of, label: str, n: int = 10
                ) -> int:
    """Each query's top ``n`` keys against a plain scan's scores (B, N) on
    the card, whose column j holds key ``keys_of[j]`` (-1: no key): equal,
    except that where they differ the index's key must score within 1e-6
    of the scan's key at that rank (a rounding tie). Returns how many
    rank-1 keys are identical."""
    import torch

    top_s, top_j = torch.sort(scan_scores, dim=1, descending=True,
                              stable=True)
    top_s, top_j = top_s[:, :n].cpu().numpy(), top_j[:, :n].cpu().numpy()
    keys_of = np.asarray(keys_of)
    order = np.argsort(keys_of, kind="stable")
    sorted_keys = keys_of[order]
    rank1 = 0
    for qi, res in enumerate(results):
        got = [int(k) for k, _ in res]
        ref = [int(keys_of[j]) for j in top_j[qi]]
        if len(got) != n:
            fail(f"{label} query {qi}: {len(got)} results")
        pos = np.searchsorted(sorted_keys, got)
        if not np.array_equal(sorted_keys[np.minimum(pos, len(order) - 1)],
                              got):
            fail(f"{label} query {qi}: a key the scan does not hold")
        cols = torch.from_numpy(order[pos]).to(scan_scores.device)
        scores = scan_scores[qi, cols].cpu().numpy()
        rank1 += got[0] == ref[0]
        for r, (g, w) in enumerate(zip(got, ref)):
            gap = float(top_s[qi, r] - scores[r])
            if g != w and abs(gap) > 1e-6:
                fail(f"{label} query {qi} rank {r}: key {g} != scan's {w} "
                     f"(score gap {gap:.3e})")
    return rank1


def plain_scan_i8(q, vectors, scales, vsq, valid, rows: int = 1 << 20):
    """``score_i8_reference`` of every row, (B, N) f32 on the card, taken
    ``rows`` rows at a time so that the f32 copy of the slab stays small."""
    import torch

    from pathway_tpu_torch.ops.knn_kernels import score_i8_reference

    out = torch.empty((q.shape[0], vectors.shape[0]), device=q.device)
    for c0 in range(0, vectors.shape[0], rows):
        c1 = c0 + rows
        out[:, c0:c1] = score_i8_reference(q, vectors[c0:c1], scales[c0:c1],
                                           vsq[c0:c1], valid[c0:c1], "cos")
    return out


def phase_ragged_int8(seed: int, card: str) -> tuple[int, int, int, int]:
    """Path 2: ragged BGE-small (K1 with segment ids) -> fused int8 write
    (K4) -> int8 search (K3 top-k; K3's score for a filtered fetch past
    K_MAX), at path 1's documents and queries. Returns the launches of K1,
    K3 top-k, K3 score and K4 in the counted run."""
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex,
                                           KnnMetric, search_extent)
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   SCORE_I8, TOPK_I8,
                                                   score_i8_reference)
    from pathway_tpu_torch.engine.profiler import segment_attention_cost
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    n_docs = RAGGED_DOCS
    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed, cfg)
    emb = EncoderEmbedder(config=cfg, params=params, ragged=True,
                          device="cuda")
    index = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
        cfg.hidden, reserved_space=100_064, dtype="int8", metric="cos",
        device="cuda"))
    docs = make_docs(n_docs, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dup_ids = sorted(rng.choice(n_docs, size=32, replace=False).tolist())
    queries = [docs[i] for i in dup_ids] + make_docs(32, seed=seed + 1)

    # layer times at the ragged dispatch shape (not part of the counted run)
    chunks = emb.pack_ragged(docs[:INGEST_BATCH])
    args = chunks[0][0]
    t0 = time.perf_counter()
    for b in range(4):
        emb.pack_ragged(docs[b * INGEST_BATCH:(b + 1) * INGEST_BATCH])
    pack_ms = (time.perf_counter() - t0) / 4 * 1e3
    fwd_ms = cuda_ms(lambda: emb.ragged_device_producer(emb.model, *args),
                     20)
    B, W = args[0].shape
    flops, _ = segment_attention_cost(B, W, hidden=cfg.hidden,
                                      intermediate=cfg.intermediate,
                                      layers=cfg.layers)
    print(f"[ragged] per {INGEST_BATCH}-doc batch: tokenize + pack "
          f"{pack_ms:.2f} ms (host) into {len(chunks)} chunks of up to "
          f"{B} x {W} ({chunks[0][1]} docs in the first); encoder forward "
          f"per chunk {fwd_ms:.2f} ms ({flops / fwd_ms / 1e9:.1f} TFLOP/s) "
          f"[{card}]", flush=True)

    # the counted run: ingest, then single-query searches
    ATTENTION.launches = SCORE_I8.launches = QUANTIZE_SCATTER.launches = 0
    TOPK_I8.launches = 0
    emb.dispatches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b0 in range(0, n_docs, INGEST_BATCH):
        sl = range(b0, min(b0 + INGEST_BATCH, n_docs))
        index.add_batch([Pointer(i) for i in sl], [docs[i] for i in sl])
    index.drain()
    ingest_s = time.perf_counter() - t0
    ingest_dispatches = emb.dispatches
    index.search([(Pointer(10**9), queries[0], 10, None)])  # warm-up
    lat_ms, results = [], []
    for qi, text in enumerate(queries):
        t1 = time.perf_counter()
        res = index.search([(Pointer(10**9 + qi), text, 10, None)])
        lat_ms.append((time.perf_counter() - t1) * 1e3)
        results.append(res[0])
    # limit 20 with a filter (one every document passes) fetches 80 rows,
    # past K_MAX: K3's score and the key selection
    res20 = index.search([(Pointer(10**9 + 99), queries[40], 20,
                           lambda data: True)])[0]
    launches = (ATTENTION.launches, TOPK_I8.launches, SCORE_I8.launches,
                QUANTIZE_SCATTER.launches)
    dispatches = emb.dispatches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    step = index._fused.step
    captures, replays = step.captures, step.replays

    batches = -(-n_docs // INGEST_BATCH)
    print(f"[ragged] ingested {len(index)} docs into "
          f"{index.inner.page_stats()['extents']} int8 extent(s) in "
          f"{ingest_s:.2f} s: {len(index) / ingest_s:.1f} docs/s, "
          f"{ingest_dispatches / batches:.2f} chunks per {INGEST_BATCH}-doc "
          f"batch; query p50 {np.percentile(lat_ms, 50):.3f} ms p99 "
          f"{np.percentile(lat_ms, 99):.3f} ms over {len(lat_ms)} "
          f"single-query searches; peak device memory {peak_mb:.1f} MiB "
          f"[{card}]", flush=True)
    n_ext = index.inner.page_stats()["extents"]
    buckets = {k[0] for k in step.graphs}
    print(f"[ragged] launches: K1 {launches[0]}, K3 top-k {launches[1]}, K3 "
          f"score {launches[2]}, K4 {launches[3]}; encoder dispatches "
          f"{dispatches} (x{N_LAYERS} = {N_LAYERS * dispatches}), "
          f"{ingest_dispatches} of them ingest; CUDA graphs: {captures} "
          f"captured ({len(buckets)} chunk shapes x {n_ext} extent(s)), "
          f"{replays} replays", flush=True)
    if len(index) != n_docs:
        fail(f"index holds {len(index)} docs, expected {n_docs}")
    if dispatches == 0 or launches[0] != N_LAYERS * dispatches:
        fail("K1 did not run on every encoder layer of path 2")
    if replays != ingest_dispatches:
        fail(f"{replays} graph replays for {ingest_dispatches} ingest chunks:"
             " a chunk of path 2 did not run as a replay of its graph")
    if launches[3] != ingest_dispatches:
        fail("K4 did not write every ragged chunk of path 2")
    if captures > len(buckets) * n_ext:
        fail(f"{captures} graphs captured for {len(buckets)} chunk shapes x "
             f"{n_ext} extent(s)")

    # the same documents through the eager body of the step (no graph),
    # into an index of its own: equal, bit for bit
    e_inner = BruteForceKnnIndex(cfg.hidden, reserved_space=100_064,
                                 dtype="int8", metric="cos", device="cuda")
    e_index = DeviceEmbeddingKnnIndex(emb, e_inner)
    e_index._fused = e_inner._ingest_fn(step.eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b0 in range(0, n_docs, INGEST_BATCH):
        sl = range(b0, min(b0 + INGEST_BATCH, n_docs))
        e_index.add_batch([Pointer(i) for i in sl], [docs[i] for i in sl])
    e_index.drain()
    eager_s = time.perf_counter() - t0
    same = e_inner._key_to_slot == index.inner._key_to_slot and all(
        torch.equal(getattr(a, t), getattr(b, t))
        for a, b in zip(index.inner._pool.extents, e_inner._pool.extents)
        for t in ("vectors", "scales", "vsq", "valid"))
    print(f"[ragged] the same {n_docs} docs through the step's eager body: "
          f"{eager_s:.2f} s, {n_docs / eager_s:.1f} docs/s (graphs: "
          f"{ingest_s:.2f} s); index bit-identical to the graphs' (slots, "
          f"codes, scales, vsq, valid) {same} [{card}]", flush=True)
    if not same:
        fail("path 2's index through graphs differs from the eager step's")
    del e_index, e_inner
    if launches[1] != (len(queries) + 1) * n_ext:
        fail(f"K3 top-k ran {launches[1]} times, not once for each of the "
             f"{len(queries) + 1} searches x {n_ext} extent(s)")
    if launches[2] != n_ext:
        fail("the filtered search's fetch past K_MAX did not take K3's "
             "score once an extent")

    # the index against a plain scan of the same int8 rows on the card
    inner = index.inner
    exts = [e for e in inner._pool.extents if e.established]
    cat = [torch.cat([getattr(e, a) for e in exts])
           for a in ("vectors", "scales", "vsq", "valid")]
    base = np.concatenate([e.base + np.arange(e.rows) for e in exts])
    keys_of = np.array([int(inner._slot_to_key.get(int(s), -1))
                        for s in base])
    qv = torch.from_numpy(np.stack([emb.embed_batch([t])[0]
                                    for t in queries])).cuda()
    qv = (qv / (qv.norm(dim=1, keepdim=True) + 1e-12)).to(torch.bfloat16)
    scan = score_i8_reference(qv, *cat, "cos")
    rank1 = check_top10(results, scan, keys_of, "path 2")
    check_top10([res20], scan[40:41], keys_of, "path 2 filtered", n=20)
    print(f"[ragged] top-10 vs a plain scan of the int8 rows: all 64 "
          f"queries pass, rank 1 identical on {rank1}/64 (the rest within a"
          f" 1e-6 score tie); the filtered limit-20 search's top 20 too",
          flush=True)
    # the route past K_MAX once more, directly: search_extent at k in
    # ROUTE_KS (score_i8 + the key selection) against the plain scan +
    # stable sort
    ext = exts[0]
    qraw = qv[:8].float()
    qn = (qraw / (torch.linalg.vector_norm(qraw, dim=1, keepdim=True)
                  + 1e-12)).to(torch.bfloat16)
    full = score_i8_reference(qn, ext.vectors, ext.scales, ext.vsq,
                              ext.valid, "cos")
    score_before = SCORE_I8.launches
    for k in ROUTE_KS:
        got = search_extent(qraw, ext.vectors, ext.valid, k, KnnMetric.COS,
                            (ext.scales, ext.vsq))
        torch.cuda.synchronize()
        ref = sort_route(lambda c0, c1: full[:, c0:c1], ext.rows, k)
        err = hold_route(got, ref, full, False,
                         f"path 2 search_extent k={k}")
        same = float((got[1] == ref[1]).float().mean())
        print(f"[ragged] search_extent k={k} (score_i8 + key selection) vs "
              f"the plain scan + stable sort: max_abs_err {err:.3e} "
              f"(tolerance 1e-5), rows equal at {100 * same:.1f}% of ranks",
              flush=True)
        if not err <= 1e-5:
            fail(f"search_extent at k={k}: {err} > 1e-5")
    SCORE_I8.launches = score_before  # comparisons don't count
    # the two halves of a query on the host clock (after the counted run)
    embed_ms, search_ms = [], []
    for qi, text in enumerate(queries):
        t1 = time.perf_counter()
        vec = emb.embed_batch([text])[0]
        t2 = time.perf_counter()
        inner.search([(Pointer(10**9 + qi), vec, 10, None)])
        embed_ms.append((t2 - t1) * 1e3)
        search_ms.append((time.perf_counter() - t2) * 1e3)
    print(f"[ragged] query halves, p50: text embed (tokenize + pack + B=1 "
          f"forward) {np.percentile(embed_ms, 50):.3f} ms, index search (K3 "
          f"top-k + host merge over {inner.capacity} rows) "
          f"{np.percentile(search_ms, 50):.3f} ms [{card}]", flush=True)
    own_rank1 = 0
    for qi, doc_id in enumerate(dup_ids):
        got = [int(k) for k, _ in results[qi]]
        if doc_id not in got:
            fail(f"path 2: the copy of doc {doc_id} missed it in its top 10")
        own_rank1 += got[0] == doc_id
    print(f"[ragged] duplicate queries: 32/32 find their document in the "
          f"top 10, {own_rank1}/32 at rank 1", flush=True)

    # ragged vs padded embeddings on the card, same weights
    padded = EncoderEmbedder(config=cfg, params=params, ragged=False,
                             device="cuda")
    a = emb.embed_batch(docs[:16]).astype(np.float64)
    b = padded.embed_batch(docs[:16]).astype(np.float64)
    cos = np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                              * np.linalg.norm(b, axis=1))
    print(f"[ragged] ragged vs padded embeddings of 16 docs on the card: min"
          f" row cosine {cos.min():.6f} (required >= 0.999)", flush=True)
    if not np.all(np.isfinite(a)) or cos.min() < 0.999:
        fail("ragged embeddings disagree with padded ones")
    time_step(index, emb, chunks, docs, card)
    return launches


def time_step(index, emb, chunks, docs, card: str) -> None:
    """Path 2's step after the counted run: a chunk as one graph replay
    against the eager body, both on CUDA events, writing nothing (sentinel
    slots); then four ingest batches that rewrite documents already held
    (the same rows again) under torch.profiler: the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.internals.keys import Pointer

    step, inner = index._fused.step, index.inner
    ext = inner._pool.extents[0]
    args, _, n_pad = chunks[0]
    none = np.full(n_pad, ext.rows, np.int64)  # every slot a sentinel
    eager_ms = cuda_ms(lambda: step.eager(ext, none, emb.model, *args), 20)
    step.eager(ext, none, emb.model, *args)  # stage the chunk for the replay
    graph = next(g for k, (g, _) in step.graphs.items()
                 if k[0][0] == args[0].shape
                 and k[3] == ext.vectors.data_ptr())
    replay_ms = cuda_ms(graph.replay, 50)
    print(f"[ragged] one chunk ({args[0].shape[0]} x {args[0].shape[1]}): "
          f"graph replay {replay_ms:.3f} ms, eager step {eager_ms:.3f} ms "
          f"CUDA events [{card}]",
          flush=True)
    torch.cuda.synchronize()
    batches = [range(b0, b0 + INGEST_BATCH)
               for b0 in range(0, 4 * INGEST_BATCH, INGEST_BATCH)]
    replays = step.replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sl in batches:
            index.add_batch([Pointer(i) for i in sl], [docs[i] for i in sl])
        index.drain()
        wall_ms = (time.perf_counter() - t0) * 1e3
    replays = step.replays - replays
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    print(f"[ragged] {len(batches)} ingest batches under torch.profiler: "
          f"wall {wall_ms:.2f} ms, {replays} replays, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%); replay time x "
          f"replays {replay_ms * replays:.2f} ms "
          f"({100 * replay_ms * replays / wall_ms:.1f}%) [{card}]",
          flush=True)


def phase_int8_million(seed: int, card: str) -> None:
    """An int8 index of 1,000,000 random rows fed by add_batch_device (K4
    on the flush path) and searched by K3 top-k over its one extent."""
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.knn_kernels import score_i8_reference

    n, D, batch = 1_000_000, 384, 65_536
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    index = BruteForceKnnIndex(D, reserved_space=n, dtype="int8",
                               metric="cos", device="cuda")
    t0 = time.perf_counter()
    for b0 in range(0, n, batch):
        b1 = min(b0 + batch, n)
        index.add_batch_device([Pointer(i) for i in range(b0, b1)],
                               torch.randn((b1 - b0, D), generator=gen,
                                           device="cuda"))
    index.drain()
    add_s = time.perf_counter() - t0
    qs = torch.randn((64, D), generator=gen, device="cuda").cpu().numpy()
    lat1, results = [], []
    index.search([(Pointer(10**9), qs[0], 10, None)])  # warm-up
    for qi in range(64):
        t1 = time.perf_counter()
        results.append(index.search([(Pointer(10**9 + qi), qs[qi], 10,
                                      None)])[0])
        lat1.append((time.perf_counter() - t1) * 1e3)
    lat64 = []
    for _ in range(5):
        t1 = time.perf_counter()
        batch_res = index.search([(Pointer(10**9 + i), qs[i], 10, None)
                                  for i in range(64)])
        lat64.append((time.perf_counter() - t1) * 1e3)
    ext = index._pool.extents[0]
    print(f"[int8 1M] {len(index):,} rows added in {add_s:.2f} s through "
          f"add_batch_device ({index._pool.stats()['extents']} extent of "
          f"{ext.rows:,} rows); query p50 at B=1 "
          f"{np.percentile(lat1, 50):.3f} ms, at B=64 "
          f"{np.percentile(lat64, 50):.3f} ms per call [{card}]", flush=True)
    keys_of = np.array([int(index._slot_to_key.get(s, -1))
                        for s in range(ext.rows)])
    q = torch.from_numpy(qs).cuda()
    q = (q / (q.norm(dim=1, keepdim=True) + 1e-12)).to(torch.bfloat16)
    scan = score_i8_reference(q, ext.vectors, ext.scales, ext.vsq,
                              ext.valid, "cos")
    rank1 = check_top10(results, scan, keys_of, "int8 1M")
    if [[int(k) for k, _ in r] for r in batch_res] != \
            [[int(k) for k, _ in r] for r in results]:
        fail("int8 1M: a B=64 search differs from the 64 B=1 searches")
    print(f"[int8 1M] top-10 vs a plain scan: all 64 queries pass (rank 1 "
          f"identical on {rank1}/64); the B=64 search returns the same "
          "keys", flush=True)


def rows_that_fit(label: str, n: int, row_bytes: int) -> int:
    """Prints ``free -g``; returns ``n``, or, where the machine's memory
    cannot hold ``row_bytes`` of host state per row (the index's host
    mirror and ~300 bytes of key maps and sets), the largest multiple of
    2^19 rows that fits, printing the cut."""
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"[{label}] free -g:\n" + free, flush=True)
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable"))
    fits = int(0.8 * avail) // (row_bytes + 300)
    if fits >= n:
        return n
    cut = max(1 << 19, fits // (1 << 19) * (1 << 19))
    print(f"[{label}] CUT: {avail / 2**30:.1f} GiB available holds "
          f"{fits:,} rows; {cut:,} rows instead of {n:,}", flush=True)
    return cut


# latency_probe as bench_knn calls it (bench.py:3485-3486, 2571-2572):
# (batch_size, reps) of knn_p50_ms and knn_batch64_ms
PROBES = ((1, 64), (64, 16))
# searches of a 10M phase: a warm-up, 64 at B=1, 5 at B=64, then each
# probe's warm pass and timed pass
SEARCHES_10M = 1 + 64 + 5 + sum(2 * reps for _, reps in PROBES)


# searches of a 10M phase's filtered run: a warm-up, 64 at B=1, 5 at B=64
FILTERED_10M = 1 + 64 + 5


def timed_searches(index, qs, key0: int, limit: int, filt):
    """A 10M index's searches with ``limit`` and ``filt``: B=1 (64 calls
    after a warm-up) and B=64 (5 calls), host merge included. Returns (B=1
    results, B=64 results, B=1 times, B=64 times) in ms."""
    from pathway_tpu_torch.internals.keys import Pointer

    index.search([(Pointer(key0), qs[0], limit, filt)])  # warm-up
    lat1, results = [], []
    for qi in range(64):
        t1 = time.perf_counter()
        results.append(index.search([(Pointer(key0 + qi), qs[qi], limit,
                                      filt)])[0])
        lat1.append((time.perf_counter() - t1) * 1e3)
    lat64 = []
    for _ in range(5):
        t1 = time.perf_counter()
        batch_res = index.search([(Pointer(key0 + i), qs[i], limit, filt)
                                  for i in range(64)])
        lat64.append((time.perf_counter() - t1) * 1e3)
    return results, batch_res, lat1, lat64


def search_10m(index, qs, label: str, key0: int, card: str):
    """A 10M index's search: B=1 (64 calls after a warm-up) and B=64 (5
    calls), k=10, host merge included; then ``latency_probe`` as bench_knn
    calls it. Returns (B=1 results, B=64 results, probe times)."""
    results, batch_res, lat1, lat64 = timed_searches(index, qs, key0, 10,
                                                     None)
    probes = [index.latency_probe(batch_size=b, k=10, reps=reps)
              for b, reps in PROBES]
    print(f"[{label}] search p50 (host merge included) at B=1 "
          f"{np.percentile(lat1, 50):.3f} ms (p99 "
          f"{np.percentile(lat1, 99):.3f}), at B=64 "
          f"{np.percentile(lat64, 50):.3f} ms per call; latency_probe "
          f"(device, no host merge): B=1 {probes[0]:.4f} ms (reps "
          f"{PROBES[0][1]}), B=64 {probes[1]:.4f} ms (reps {PROBES[1][1]})"
          f" [{card}]", flush=True)
    return results, batch_res, probes


def filtered_10m(index, qs, label: str, key0: int, card: str):
    """A 10M index's filtered search: limit 20 and a callable filter that
    every row passes, so that each search fetches 80 rows through the route
    past K_MAX (a score kernel per chunk + the key selection), at B=1 and
    B=64 as ``timed_searches``. Returns (B=1 results, B=64 results, B=1
    p50, B=64 p50)."""
    results, batch_res, lat1, lat64 = timed_searches(
        index, qs, key0, 20, lambda data: True)
    p50 = (float(np.percentile(lat1, 50)), float(np.percentile(lat64, 50)))
    print(f"[{label}] filtered search p50 (host merge included), limit 20 "
          f"with a filter every row passes (fetch 80): B=1 {p50[0]:.3f} ms "
          f"(p99 {np.percentile(lat1, 99):.3f}), B=64 {p50[1]:.3f} ms per "
          f"call [{card}]", flush=True)
    return results, batch_res, p50


def check_10m(index, runs, scan_fn, label: str):
    """Each run's B=1 top n (``runs``: (B=1 results, B=64 results, n,
    what)) against a plain scan of the index's extents, and its B=64
    search equal to the 64 B=1 searches. Returns the plain scan (64,
    rows)."""
    import torch

    exts = [e for e in index._pool.extents if e.established]
    keys_of = np.concatenate([
        np.fromiter((int(index._slot_to_key.get(e.base + s, -1))
                     for s in range(e.rows)), np.int64, e.rows)
        for e in exts])
    scan = torch.cat([scan_fn(e) for e in exts], dim=1)
    for results, batch_res, n, what in runs:
        rank1 = check_top10(results, scan, keys_of, f"{label} {what}", n=n)
        if [[int(k) for k, _ in r] for r in batch_res] != \
                [[int(k) for k, _ in r] for r in results]:
            fail(f"{label} {what}: a B=64 search differs from the 64 B=1 "
                 "searches")
        print(f"[{label}] {what} vs a plain scan: all 64 queries pass (rank"
              f" 1 identical on {rank1}/64); the B=64 search returns the "
              "same keys", flush=True)
    return scan


def route_10m(ext, qraw, full, extras: tuple, make_score, label: str,
              card: str) -> dict:
    """The route past K_MAX over a 10M index's extent: ``search_extent`` at
    k in ROUTE_KS for the 8 queries ``qraw`` against the plain scan
    (``full``, their plain scores) + stable sort, then its times beside
    the stable sort's (``time_selection``)."""
    import torch

    from pathway_tpu_torch.ops.knn import KnnMetric, search_extent

    for k in ROUTE_KS:
        got = search_extent(qraw, ext.vectors, ext.valid, k, KnnMetric.COS,
                            extras)
        torch.cuda.synchronize()
        hold_route(got, sort_route(lambda c0, c1: full[:, c0:c1], ext.rows,
                                   k), full, False,
                   f"{label} search_extent k={k}")
    print(f"[{label}] search_extent at k in {ROUTE_KS} for 8 queries against"
          f" the plain scan + stable sort: within 1e-5 x max|score|, -inf "
          f"ranks exact", flush=True)
    return time_selection(make_score, ext.rows, label, card)


def filtered_run(index, qs, label: str, count, other, card: str):
    """``filtered_10m`` with its launches counted: ``count`` (the score
    kernel's LaunchCount) must launch once a chunk of every search and
    ``other`` (the top-k kernel's) not at all. Returns (B=1 results, B=64
    results, p50s, the score kernel's launches)."""
    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS

    count.launches = other.launches = 0
    results, batch_res, p50 = filtered_10m(index, qs, label, 2 * 10**10,
                                           card)
    launches, other_launches = count.launches, other.launches
    chunks = sum(-(-e.rows // _CHUNK_ROWS) for e in index._pool.extents
                 if e.established)
    print(f"[{label}] filtered searches' launches: {count.name} {launches} "
          f"({FILTERED_10M} searches x {chunks} chunks), {other.name} "
          f"{other_launches}", flush=True)
    if launches != FILTERED_10M * chunks or other_launches != 0:
        fail(f"{label}: the filtered searches did not take {count.name} "
             f"once a chunk, or {other.name} ran")
    return results, batch_res, p50, launches


def selection_record(times: dict) -> dict:
    """``time_selection``'s times as JSON: {"B1_k80": [ms sort, ms route],
    ...}"""
    return {f"B{B}_k{k}": list(t) for (B, k), t in times.items()}


def bench_knn_rows(ci: int, m: int, D: int):
    """bench_knn's chunk ``ci`` (bench.py:3455-3464): ``m`` rows uniform in
    [-1, 1), made on the card from ``manual_seed(ci)``, as bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(ci)
    return (torch.rand((m, D), generator=gen, device="cuda") * 2 - 1).to(
        torch.bfloat16)


def phase_int8_10m(qs, bf16_top: list, n_bf16: int, card: str
                   ) -> tuple[tuple, list, dict]:
    """bench_knn's int8 deployment (bench.py:2547-2579; README.md:1655,
    1749): BruteForceKnnIndex(384, reserved_space=10M, int8, cos) fed by
    add_batch_device with the bf16 phase's rows, chunk i made again from
    ``manual_seed(i)`` (``bench_knn_rows``), searched with bench_knn's
    queries by ``search_10m`` (bench.py's knn_int8_p50_ms and
    knn_int8_batch64_ms from latency_probe), then by ``filtered_10m`` (limit
    20 with a filter: K3's score per chunk), the route past K_MAX checked
    and timed (``route_10m``); bench.py's knn_int8_overlap10_vs_bf16, the
    mean overlap of the first 8 queries' top-10 with the bf16 index's over
    the same rows. The host mirror is f32 (15.4 GB at 10M rows);
    ``rows_that_fit`` cuts the rows where the machine cannot hold it.
    Returns the launches of K3 top-k, K3 score and K4 in the unfiltered
    run, the probe times, and the filtered run's numbers."""
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   SCORE_I8, TOPK_I8,
                                                   score_i8)

    D, chunk = 384, 1 << 19
    n = min(n_bf16, rows_that_fit("int8 10M", n_bf16, D * 4))
    QUANTIZE_SCATTER.launches = SCORE_I8.launches = TOPK_I8.launches = 0
    t0 = time.perf_counter()
    index = BruteForceKnnIndex(D, reserved_space=n, dtype="int8",
                               metric="cos", device="cuda")
    for ci, base in enumerate(range(0, n, chunk)):
        m = min(chunk, n - base)
        index.add_batch_device([Pointer(base + i) for i in range(m)],
                               bench_knn_rows(ci, m, D))
    index.drain()
    add_s = time.perf_counter() - t0
    extents = index.page_stats()["extents"]
    print(f"[int8 10M] {len(index):,} rows added in {add_s:.2f} s through "
          f"add_batch_device, the bf16 phase's rows ({extents} extent(s), "
          f"{index.capacity:,} rows) [{card}]", flush=True)
    results, batch_res, probes = search_10m(index, qs, "int8 10M", 10**10,
                                            card)
    print(f"[int8 10M] bench.py's names: knn_int8_p50_ms {probes[0]:.4f}, "
          f"knn_int8_batch64_ms {probes[1]:.4f} [{card}]", flush=True)
    launches = (TOPK_I8.launches, SCORE_I8.launches,
                QUANTIZE_SCATTER.launches)
    n_ext = len([e for e in index._pool.extents if e.established])
    print(f"[int8 10M] launches: K3 top-k {launches[0]} ({SEARCHES_10M} "
          f"searches x {n_ext} extent(s)), K3 score {launches[1]}, K4 "
          f"{launches[2]}", flush=True)
    if len(index) != n:
        fail(f"int8 10M: the index holds {len(index)} rows, not {n}")
    if launches[0] != SEARCHES_10M * n_ext or launches[1] != 0:
        fail("int8 10M: the search did not go through K3 top-k once an "
             "extent, or K3's score ran")
    if launches[2] < -(-n // chunk):
        fail("int8 10M: K4 did not write every chunk")
    # bench.py:2566-2569: the first 8 queries' top-10 against the bf16
    # index's over the same rows
    res = index.search([(Pointer(10**9 + i), qs[i], 10, None)
                        for i in range(8)])
    overlap = float(np.mean([len({k for k, _ in res[i]} & set(bf16_top[i]))
                             / 10.0 for i in range(8)]))
    print(f"[int8 10M] bench.py's name: knn_int8_overlap10_vs_bf16 "
          f"{overlap:.3f} (mean top-10 overlap of 8 queries with the bf16 "
          f"index over the same {n:,} rows"
          + ("" if n == n_bf16 else f"; the bf16 index held {n_bf16:,}")
          + f") [{card}]", flush=True)
    f_res, f_batch, f_p50, f_launches = filtered_run(
        index, qs, "int8 10M", SCORE_I8, TOPK_I8, card)
    qraw = torch.from_numpy(qs).cuda()
    q = (qraw / (qraw.norm(dim=1, keepdim=True) + 1e-12)).to(torch.bfloat16)
    scan = check_10m(index, [(results, batch_res, 10, "top-10"),
                             (f_res, f_batch, 20, "filtered top-20")],
                     lambda e: plain_scan_i8(q, e.vectors, e.scales, e.vsq,
                                             e.valid), "int8 10M")
    ext = index._pool.extents[0]
    before = SCORE_I8.launches

    def make_score(B):
        qb = q[:B].contiguous()
        return qb, lambda c0, c1, out=None: score_i8(
            qb, ext.vectors[c0:c1], ext.scales[c0:c1], ext.vsq[c0:c1],
            ext.valid[c0:c1], "cos", out)

    sel = route_10m(ext, qraw[:8], scan[:8, :ext.rows], (ext.scales, ext.vsq),
                    make_score, "int8 10M", card)
    SCORE_I8.launches = before  # comparisons don't count
    return launches, probes, {"filtered_p50_ms": f_p50,
                              "launches_10m": f_launches,
                              "selection_ms": selection_record(sel),
                              "knn_int8_overlap10_vs_bf16": overlap}


def phase_bf16_10m(card: str) -> tuple[int, list, dict, tuple]:
    """bench_knn's headline deployment (bench.py:3436-3490, KNN_N at
    :27): BruteForceKnnIndex(384, reserved_space=10M, dtype="bfloat16",
    metric="cos"), 10M rows uniform in [-1, 1) made on the card in 2^19-row
    chunks, chunk i from torch.Generator(device="cuda").manual_seed(i),
    added by add_batch_device; bench_knn's 64 queries
    (default_rng(0).random((64, 384)) * 2 - 1) through ``search_10m``
    (bench.py's knn_p50_ms and knn_batch64_ms from latency_probe), then
    ``filtered_10m`` (K2's score twin per chunk) and ``route_10m``, as
    the int8 phase. The host mirror is bf16 (7.7 GB). Returns K2's
    launches in the unfiltered run, the probe times, the filtered run's
    numbers, and (the queries, the first 8 queries' top-10 keys, the
    rows) for the int8 index over the same rows."""
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, TOPK_BF16,
                                                   score_bf16,
                                                   score_float_reference)

    D, chunk = 384, 1 << 19
    n = rows_that_fit("bf16 10M", K3_ROWS, D * 2)
    TOPK_BF16.launches = SCORE_BF16.launches = 0
    t0 = time.perf_counter()
    index = BruteForceKnnIndex(D, reserved_space=n, dtype="bfloat16",
                               metric="cos", device="cuda")
    for ci, base in enumerate(range(0, n, chunk)):
        m = min(chunk, n - base)
        index.add_batch_device([Pointer(base + i) for i in range(m)],
                               bench_knn_rows(ci, m, D))
    index.drain()
    add_s = time.perf_counter() - t0
    print(f"[bf16 10M] {len(index):,} rows added in {add_s:.2f} s through "
          f"add_batch_device ({index.page_stats()['extents']} extent(s), "
          f"{index.capacity:,} rows) [{card}]", flush=True)
    qs = np.random.default_rng(0).random((64, D), dtype=np.float32) * 2 - 1
    results, batch_res, probes = search_10m(index, qs, "bf16 10M", 10**10,
                                            card)
    print(f"[bf16 10M] bench.py's names: knn_p50_ms {probes[0]:.4f}, "
          f"knn_batch64_ms {probes[1]:.4f} [{card}]", flush=True)
    launches, score_launches = TOPK_BF16.launches, SCORE_BF16.launches
    n_ext = len([e for e in index._pool.extents if e.established])
    print(f"[bf16 10M] launches: K2 {launches} ({SEARCHES_10M} searches x "
          f"{n_ext} extent(s)), K2 score {score_launches}", flush=True)
    if len(index) != n:
        fail(f"bf16 10M: the index holds {len(index)} rows, not {n}")
    if launches != SEARCHES_10M * n_ext or score_launches != 0:
        fail("bf16 10M: the search did not go through K2 once an extent, "
             "or K2's score twin ran")
    f_res, f_batch, f_p50, f_launches = filtered_run(
        index, qs, "bf16 10M", SCORE_BF16, TOPK_BF16, card)
    qraw = torch.from_numpy(qs).cuda()
    q = (qraw / (qraw.norm(dim=1, keepdim=True) + 1e-12)).to(torch.bfloat16)
    qf = q.float()

    def scan(e, rows=1 << 20):
        out = torch.empty((64, e.rows), device="cuda")
        for c0 in range(0, e.rows, rows):
            out[:, c0:c0 + rows] = score_float_reference(
                qf, e.vectors[c0:c0 + rows], e.valid[c0:c0 + rows], "cos")
        return out

    full = check_10m(index, [(results, batch_res, 10, "top-10"),
                             (f_res, f_batch, 20, "filtered top-20")],
                     scan, "bf16 10M")
    ext = index._pool.extents[0]
    before = SCORE_BF16.launches

    def make_score(B):
        qb = q[:B].contiguous()
        return qb, lambda c0, c1, out=None: score_bf16(
            qb, ext.vectors[c0:c1], ext.valid[c0:c1], "cos", out)

    sel = route_10m(ext, qraw[:8], full[:8, :ext.rows], (), make_score,
                    "bf16 10M", card)
    SCORE_BF16.launches = before  # comparisons don't count
    # bench.py:3478-3480: the first 8 queries' top-10 keys, for the int8
    # index over the same rows (knn_int8_overlap10_vs_bf16)
    top8 = [tuple(k for k, _ in r) for r in results[:8]]
    return launches, probes, {"filtered_p50_ms": f_p50,
                              "launches_10m": f_launches,
                              "selection_ms": selection_record(sel)}, (
        qs, top8, n)


def phase_profile(card: str) -> None:
    """torch.profiler over three encoder forwards of each path's dispatch
    (path 1: 512 x 96 padded; path 2: one ragged chunk of 8 x 512 with
    segment ids): device time by kernel group and the device's busy
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.bge_small()
    emb = EncoderEmbedder(config=cfg, device="cuda")
    ids, lens = emb.pack_tokens(make_docs(INGEST_BATCH, seed=7))
    remb = EncoderEmbedder(config=cfg, ragged=True, device="cuda")
    args = remb.pack_ragged(make_docs(INGEST_BATCH, seed=7))[0][0]
    runs = [(f"path 1 forward {INGEST_BATCH}x{ids.shape[1]}",
             lambda: emb.device_producer(emb.model, ids, lens)),
            (f"path 2 forward {args[0].shape[0]}x{args[0].shape[1]} "
             "(segment ids)",
             lambda: remb.ragged_device_producer(remb.model, *args))]
    reps = 3
    for label, fwd in runs:
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # device-side kernel records only (the aten ops above them carry
        # the same time again)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if not events:
            print("[profile] torch.profiler recorded no device time",
                  flush=True)
            return
        groups = {"K1 attention": 0.0, "GEMM": 0.0, "other": 0.0}
        launches = 0
        for e in events:
            name = e.key.lower()
            g = ("K1 attention" if any(k in name for k in K1_KERNELS)
                 else "GEMM"
                 if any(t in name for t in ("gemm", "xmma", "cutlass",
                                            "nvjet"))
                 else "other")
            groups[g] += e.self_device_time_total / reps / 1e3
            launches += e.count
        busy = sum(groups.values())
        print(f"[profile] {label} (profiler on): wall {wall_ms:.2f} ms, "
              f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
              f"{launches / reps:.0f} kernels: " + ", ".join(
                  f"{g} {v:.2f} ms" for g, v in groups.items())
              + f" [{card}]", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile]   {e.self_device_time_total / reps / 1e3:8.3f}"
                  f" ms x{e.count // reps:<4d} {e.key[:90]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=100_000,
                    help="documents to ingest (default: bench.py's "
                         "SERVING_N, 100000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    name, card = phase_device()
    import torch

    from pathway_tpu_torch._device import resolve_device
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   SCORE_BF16, SCORE_I8,
                                                   TOPK_BF16, TOPK_I8)

    phase_build()
    resolve_device("cuda")  # f32 products of the plain versions: no TF32
    t0 = time.perf_counter()

    def done(what):
        print(f"[time] {what} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    k1 = phase_attention(card)
    k1_seg = phase_segments(card)
    k3, k4 = phase_knn_i8(card)
    k3_topk = phase_topk_i8(card)
    k2 = phase_topk_bf16(card)
    k2_score = phase_score_bf16(card)
    done("kernel phases")
    k1["launches"], k2["launches"], k2_score["launches"] = phase_slice(
        args.docs, args.seed, card)
    done("path 1")
    k1["launches_engine"], k1_seg["launches_engine"] = phase_engine(
        args.docs, args.seed, card)
    done("engine")
    fw = phase_framework(args.docs, args.seed, card)
    for rec, key in ((k1, (ATTENTION, False)), (k1_seg, (ATTENTION, True)),
                     (k2, TOPK_BF16), (k2_score, SCORE_BF16),
                     (k3_topk, TOPK_I8), (k3, SCORE_I8),
                     (k4, QUANTIZE_SCATTER)):
        rec["launches_framework"] = fw[key]
    done("framework")
    served = [phase_serving_knn(card), phase_serving_rag(args.seed, card)]
    for rec, key in ((k1, ATTENTION), (k2, TOPK_BF16),
                     (k2_score, SCORE_BF16)):
        rec["launches_serving"] = sum(run[key] for run in served)
    gc.collect()  # graph B's index and encoder, and their cached blocks
    torch.cuda.empty_cache()
    done("serving")
    phase_array_sum(args.seed, card)
    done("array_sum")
    (k1_seg["launches"], k3_topk_path2, k3["launches"],
     k4["launches"]) = phase_ragged_int8(args.seed, card)
    done("path 2")
    phase_int8_million(args.seed, card)
    done("int8 1M index")
    k2["launches_10m"], k2["probe_ms"], filt, bf16_rows = phase_bf16_10m(card)
    k2_score.update(filt)
    done("bf16 10M index")
    gc.collect()  # the 10M bf16 index and its host mirror are gone
    torch.cuda.empty_cache()
    (k3_topk["launches"], _, _), k3_topk["probe_ms"], filt = phase_int8_10m(
        *bf16_rows, card)
    k3_topk["launches_path2"] = k3_topk_path2
    k3.update(filt)
    done("int8 10M index")
    phase_profile(card)
    print(json.dumps({"kernels": [k1, k1_seg, k2, k3_topk, k3, k4,
                                  k2_score]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
