#!/usr/bin/env python3
"""Smoke run of pathway_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--docs N] [--seed S]

Drives the port's live-RAG device path at BGE-small's full width with
random weights from a seed, and checks every kernel of that path against
its plain PyTorch version on the card. Phases (each failure exits
non-zero, and no result line is printed):

1. device: CUDA version, card name and capability (9, 0 required), the
   card's name and power limit as nvidia-smi reports them;
2. build: every kernel of the path compiled from the sources in this
   checkout, with the build time, registers and spills (ptxas), and a
   count of tensor-core instructions in the bf16 kernels (cuobjdump);
3. K1 (the encoder attention kernel) against ``attention_reference`` on
   the card: bf16 at the ingest shape, at S=512 and at the edges of its
   tensor-core tiling (S=16, S=100, S=1000, S=1024, D=40, D=128), f32,
   batch rows with every key masked; times of the kernel, the plain
   version and PyTorch's scaled_dot_product_attention at the main-path
   shape and at B=64 S=512, beside the bound;
4. the slice: ``DeviceEmbeddingKnnIndex(EncoderEmbedder(bge_small),
   BruteForceKnnIndex(384, bf16 paged))`` ingests ``--docs`` synthetic
   documents in batches of 512 through the fused path, then answers 64
   single-query text searches (32 copies of ingested documents, 32 fresh
   texts). Checks: the launch count of K1 equals 12 x the encoder
   dispatches of that run, every query's top 10 against a brute-force
   scan of the same rows on the card, every copy finding its document,
   and card-vs-CPU embeddings;
5. profile: torch.profiler over three encoder forwards at the ingest
   shape, device time by kernel group (K1, GEMM, other) and the device's
   busy share.

The second-to-last line is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate and HBM
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
INGEST_BATCH = 512
N_LAYERS = 12
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


def phase_build():
    from pathway_tpu_torch.ops.attention import ATTENTION

    libs = [ATTENTION]
    t0 = time.perf_counter()
    for lib in libs:
        lib.load()
    print(f"[build] {len(libs)} kernel source(s) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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


def phase_slice(n_docs: int, seed: int, card: str) -> int:
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  encoder_cost,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex)
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
    ATTENTION.launches = 0
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
    launches, dispatches = ATTENTION.launches, emb.dispatches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    print(f"[slice] ingested {len(index)} docs into "
          f"{index.inner.page_stats()['extents']} extent(s) in "
          f"{ingest_s:.2f} s: {len(index) / ingest_s:.1f} docs/s; query p50 "
          f"{np.percentile(lat_ms, 50):.3f} ms p99 "
          f"{np.percentile(lat_ms, 99):.3f} ms over {len(lat_ms)} "
          f"single-query searches; peak device memory {peak_mb:.1f} MiB "
          f"[{card}]", flush=True)
    print(f"[slice] K1 launches {launches}, encoder dispatches {dispatches}"
          f" (x{N_LAYERS} = {N_LAYERS * dispatches})", flush=True)
    if len(index) != n_docs:
        fail(f"index holds {len(index)} docs, expected {n_docs}")
    if dispatches == 0 or launches != N_LAYERS * dispatches:
        fail("K1 did not run on every encoder layer of the main path")

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
          f"{np.percentile(embed_ms, 50):.3f} ms, index search (score + "
          f"sort + merge over {inner.capacity} rows) "
          f"{np.percentile(search_ms, 50):.3f} ms [{card}]", flush=True)
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
    return launches


def phase_profile(card: str) -> None:
    """torch.profiler over three encoder forwards at the ingest shape:
    device time by kernel group and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    emb = EncoderEmbedder(config=EncoderConfig.bge_small(), device="cuda")
    ids, lens = emb.pack_tokens(make_docs(INGEST_BATCH, seed=7))
    reps = 3
    emb.device_producer(emb.model, ids, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            emb.device_producer(emb.model, ids, lens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    # device-side kernel records only (the aten ops above them carry the
    # same time again)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        print("[profile] torch.profiler recorded no device time", flush=True)
        return
    groups = {"K1 attention": 0.0, "GEMM": 0.0, "other": 0.0}
    for e in events:
        name = e.key.lower()
        g = ("K1 attention" if any(k in name for k in K1_KERNELS)
             else "GEMM"
             if any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet"))
             else "other")
        groups[g] += e.self_device_time_total / reps / 1e3
    busy = sum(groups.values())
    print(f"[profile] encoder forward {INGEST_BATCH}x{ids.shape[1]} "
          f"(profiler on): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms"
          f" ({100 * busy / wall_ms:.1f}%): " + ", ".join(
              f"{g} {v:.2f} ms" for g, v in groups.items()) + f" [{card}]",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / reps / 1e3:8.3f} ms"
              f" x{e.count // reps:<4d} {e.key[:90]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=100_000,
                    help="documents to ingest (default: bench.py's "
                         "SERVING_N, 100000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    name, card = phase_device()
    import torch

    phase_build()
    kernel = phase_attention(card)
    kernel["launches"] = phase_slice(args.docs, args.seed, card)
    phase_profile(card)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
