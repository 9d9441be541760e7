#!/usr/bin/env python3
"""Smoke run of pathway_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--docs N] [--seed S]

Drives bench.py's headline leg (bench_embed: docs_per_s, tokens_per_s,
both MFU keys), the port's two live-RAG device paths, the engine's batch path
with the encoder as a batch UDF, the engine's index path (the graph of
bench.py's bench_embed_framework), the served path (``pw.run``'s
streaming runtime behind HTTP: bench.py's bench_serving graph and a live
RAG server), BASELINE.md's configs 3, 1 and 5 (the Adaptive-RAG
template served over streamed files with its reranker, the classic
KNNIndex over a CSV, and a Kafka stream into the mesh-sharded index at
four workers), the engine's relational core (bench.py's bench_etl
graph: the columnar groupby and the inner join with their native passes,
host code, at one and at eight sharded workers, and the exchange's wire
codec), graph A of bench_embed_framework at four sharded workers, its temporal layer (bench_etl's windowed leg and every
other temporal entry point, host code) and the model layer's training
paths (contrastive fine-tuning, its sharded form over a device mesh with
ring and Ulysses attention and a GPipe pipeline, a mixture-of-experts
encoder served and trained, the CLIP dual encoder), the continuous
profiler live on the framework graph and ``pw.stdlib.ml`` (k-means on the
card, LSH clustering through the engine, the bucketed classifier), at BGE-small's full width with random weights from a seed,
and checks every kernel of those paths against its plain PyTorch version
on the card. Phases (each failure exits
non-zero, and no result line is printed):

1. device: CUDA version, card name and capability (9, 0 required), the
   card's name and power limit as nvidia-smi reports them;
2. build: every kernel source compiled from this checkout (one nvcc per
   source, all started together), with the build time, registers and
   spills (ptxas), and a count of tensor-core instructions in the bf16
   kernels (cuobjdump);
2b. etl (bench.py's bench_etl one-worker graph, host only): Python.h in
   the interpreter's include directory (else the phase fails naming it),
   the native join and groupby passes built with g++ and loaded, then
   ``events.groupby(word).reduce(word, n=count(), total=sum(qty))``
   joined with the 5,000-row ``lex`` table over bench's 100,000 rows in
   50 ticks (``default_rng(0)``, bench's draw order), under
   ``run_batch(n_workers=1)``: native, both passes off in-process,
   off, native. Checks: the groupby lowered to
   ``ColumnarGroupByOperator``, the join's ``_step_inner_native`` taken
   on every tick with input (never with the passes off), the final table
   equal to a plain numpy count, sum and dict join, the native runs'
   consolidated events (keys included) equal to the Python loops', no
   kernel launched. Prints bench.py's ``etl_rows_per_s_1w`` and
   ``etl_rows_per_s_1w_python_loops``, the host's CPU and cores and the
   garbage collector's collections;
2c. etl windowed (bench.py's ``run_windowed``, host only): bench's
   100,000 rows over 50 ticks with ``at`` drawn next (sorted, below
   10,000), ``windowby(at, tumbling(100), instance=s{word % 200})``
   reduced to sensor, start, sum and count under
   ``run_batch(n_workers=1)``: native, the groupby's loops, loops,
   native. Checks: the operators are the JAX package's (Source, Map,
   ColumnarGroupByOperator, Map, Output), the native groupby pass taken on
   every input tick (never with it off), the final table equal to a plain
   sum and count per window (19,875), the native runs' consolidated
   events (keys included) equal to the loops', no kernel launched. Prints
   bench.py's ``etl_windowed_rows_per_s``;
2d. etl sharded (bench_etl at n workers, bench.py:1900-1990, host only):
   the one-worker graph of 2b at 1 and at 8 in-process workers
   (``run_batch(n_workers=8)``: rows routed by group value and join key
   between the workers' replicas), and the fit run at ``min(8, cores)``.
   Checks: the 8-worker final table equal to the numpy oracle, its
   consolidated events (keys included) equal to the one-worker run's, the
   groupby's and the join's state on at least 2 workers with no key on
   two, no kernel launched. Then bench_exchange (bench.py:1863-1896)
   through the port's ``engine/wire.py`` on bench's 20,000-row payload,
   decoded back to the payload encoded. Prints bench.py's
   ``etl_rows_per_s_8w``, ``etl_8w_oversubscribed``, ``etl_n_cores``,
   ``etl_rows_per_s_per_core``, ``etl_exchange_rounds_per_tick`` and the
   six ``exchange_*`` keys;
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
7b. embed (bench.py's ``bench_embed``, bench.py:926-1057, as bench.py runs
   it, nothing cut): the local BGE-small checkpoint if one is on disk,
   else ``init_params_host(0)`` and bench's synthetic WordPiece vocabulary
   (native engine); ``BruteForceKnnIndex(384, reserved_space=1 << 20,
   metric="cos", dtype="bfloat16")``; ``make_fused_ingest`` over a
   producer of int16 ids and row lengths (the mask rebuilt on the card);
   batches of 2048 ``make_docs`` documents padded to a multiple of 16 up
   to 128; four warm batches, the self-retrieval probe (doc 3 finds
   itself), then at least 15 s and 8 batches with batch i+1 tokenized
   while batch i runs, ``drain()``, the first batch dropped; then 3 x 8
   forwards at 2048 x 128 with no host sync (best of 3). Prints bench.py's
   ``docs_per_s``, ``tokens_per_s``, ``mfu_est``, ``mfu_device_only``,
   ``mfu_peak_tflops`` (engine/profiler.py ``machine_params``) and, as
   bench.py's ``_DeviceEventCounter`` counts them over the leg,
   ``embed_compile_count`` (CUDA graph captures: must be 0) and
   ``embed_transfer_count`` (implicit host syncs, report mode). Checks:
   every ingest fused, K1 = 12 x batches in the timed window and nothing
   else, K1 = 12 x forwards and K2 = 1 over the leg;
7c. warmup: ``pw.warmup`` on BGE-small under PATHWAY_DEVICE_SANITIZER=1
   (raise mode), padded (bench's framework embedder, max_len 128, batches
   of 512) into a bf16 index holding 512 documents with ``ks=(10,)``, and
   ragged (sequences of 512) into an empty int8 index (one CUDA graph a
   chunk bucket, counted as warm-up: captures = ``len(ragged_buckets())``);
   after each, 512 fresh documents and a text search in steady state
   raise nothing, capture nothing and the copy finds its document;
7d. loader: a random BGE-small checkpoint in BertModel's key layout
   (``torch.save`` to ``pytorch_model.bin``, ``config.json``,
   ``vocab.txt``, ``1_Pooling/config.json``; no ``transformers``) loaded
   by ``EncoderEmbedder(model=dir)`` on the card: the tree exact, 64
   documents' bf16 embeddings (K1) against the CPU's float32 plain
   forward at row cosine >= 0.999;
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
9. engine (the engine's batch path): the first 24,576 of those
   documents (cut from 100,000 for the script's clock) as
   ``table_from_rows(..., is_stream=True)``, one tick per 512 (48
   ticks), through ``select(embedding=emb(pw.this.data))`` under
   ``GraphRunner.run_batch(n_workers=1)`` with the padded embedder as a
   batch device UDF (its map runs on the device bridge at the default
   window, 2), every bucket width warmed first; then the same
   documents through ``embed_batch`` in the same batches; engine, direct,
   direct, engine. Checks: every document once, diff +1, at its tick's
   time, under its ``hash_values_uncached("row", i, doc)`` key, its
   embedding equal to the direct call's bit for bit (both engine runs);
   K1 launches = 12 x encoder dispatches in the counted run and
   no other kernel. Then the ragged embedder over the first 10,240
   documents (20 ticks) the same way (its K1 launches are K1 with segment
   ids). Prints engine and direct docs/s, their ratio, the engine's wall
   a tick outside the UDF body, the garbage collector's time, peak device
   memory and the bridge's window and counters;
10. framework (bench.py's ``bench_embed_framework`` graph, as bench.py
   runs it, over 24,576 documents, cut from path 1's 100,000 for the
   script's clock): the documents as ``table_from_rows(data,
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
   timed window (the device sanitizer's capture count), and legs on the
   bridge in the bridged runs. Prints
   bench.py's keys (``framework_docs_per_s``,
   ``framework_device_inflight``, ``framework_bridge_legs``,
   ``framework_bridge_overlap_ratio``, ``framework_bridge_queue_wait_ms``,
   ``framework_autojit_enabled``, ``_programs``, ``_compiles``,
   ``_demotions``, ``_bucket_count``),
   the window-1 and HashTokenizer docs/s, the direct docs/s, host ms a
   tick by leg (calling thread and bridge worker), the host's waits in
   ``submit`` and ``barrier``, host time by operator, the garbage
   collector's time and peak device memory;
10d. profiler live (the continuous profiler, engine/profiler.py):
   phase 10's graph with ``PATHWAY_PROFILER=1`` (``Profiler.from_env()``
   installed and sampling just before ``run_batch``): configuration A with
   the profiler off, then on; B on. Checks: A's outputs and index equal
   on and off; each kernel family's dispatches against the run's launches
   (K1 = 12 x ``encoder_forward`` / ``segment_attention``, K2 or K3 top-k
   + score = ``knn_search``, B's K4 = ``ingest_scatter`` = graph
   replays); every record re-timed inside a leg timed by CUDA events, the
   families' ms summing to the legs' within 1%; the sampler's overhead
   ratio < 0.02; 0 implicit host syncs on and off; a
   ``start_device_capture`` / ``stop_device_capture`` over two ingest
   ticks and a search writes a Chrome trace holding K1. Prints each
   family's dispatches, device ms, MFU, HBM use and roofline class, the
   rolling MFU and HBM use, the sampler's numbers and docs/s on and off;
10b. framework sharded: graph A of phase 10 (padded embedder, bf16 cos
   index; K1, K2, K2 score) over 8 ticks of 2048 documents at
   ``run_batch(n_workers=1)`` and at 4 workers (the index operator's
   replicas share one index: data broadcast, queries answered on their
   worker). Checks: the replicas share the index and the embedder, only
   replica 0 adds rows, at least 2 replicas answer, the index's live keys
   equal, every reply's scores within 2^-7 of the one-worker run's rank
   by rank, the launches as the code gives them, and the 4-worker peak
   device memory within the one-worker run's plus half the model's
   bytes. Prints docs/s at 1 and 4 workers, launches and peak memory;
10a. autojit (bench.py's ``bench_autojit``, bench.py:2053-2302, at its
   size): 16 ticks of 2048 rows ``(x, y)`` from ``default_rng(3)``
   through bench's seven UDFs in one select (six fuse into one auto-jit
   program: ``boost`` and ``gate`` on the card as one CUDA graph replay a
   tick, ``mix``, ``norm``, ``damp`` and ``step`` on numpy; ``tag`` is
   host-only, split onto the host thread) and the batch device ``embed``
   UDF (bench's payload in torch on the card: ``tanh(emb[ids] @ w1) @ w2``
   and the row norm over f32 parameters from ``default_rng(12)``), raw /
   tier on / tier off interleaved, best of 3, each framework run after
   ``pw.warmup``. Checks: the three outputs byte-identical; one program on
   the ``torch`` backend on the card, 0 demotions, one device and one
   vector dispatch a tick, no fallback; warm-up walked and captured the 9
   buckets 8 .. 2048; 0 captures and 0 implicit host syncs in the timed
   runs; no hand-written kernel. Prints bench.py's keys
   (``framework_vs_raw_ratio``, ``framework_vs_raw_ratio_nojit``, the
   ``autojit_*`` keys, the bridge overlap), the device partition's
   CUDA-event ms a tick beside the numpy partition's host ms, the stage
   breakdown and the phase's seconds. Every phase that builds Table
   graphs prints the tier's counters after it (``[<phase>] auto-jit``);
10c. config 5 (BASELINE.md:30, multi-worker KNN over a Kafka stream):
   50,000 ``make_docs`` documents produced as JSON to a 4-partition topic
   of ``LogBroker`` (a one-node broker on 127.0.0.1 on the port's wire
   codecs) and read by ``pw.io.kafka.read`` under ``pw.run`` at
   PATHWAY_THREADS=4; phase 10's padded embedder as the DataIndex's UDF
   (K1) into ``default_brute_force_knn_document_index(..., mesh="auto",
   dtype="bfloat16")`` under ``use_mesh`` of 4 shards on cuda:0 (the
   port's sharded index, K2 on each shard); once it holds every document,
   256 queries (half copies) produced one at a time to a second topic and
   answered ``query_as_of_now`` (k=10). Checks: one sharded index of 4
   shards holding each document once, every answer its search's reply,
   each top-1 against an exact f32 search of the query's embedding over
   the index's host mirror (near-ties within 2^-6 counted), K1 = 12 x
   encoder dispatches and K2 = searches x 4 shards x extents. Prints
   docs/s from the first produce to the last document indexed, answer p50
   / p99, peak memory and seconds;
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
   over 25,000 ``make_docs`` documents (``SERVING_B_DOCS``, cut from
   100,000 for the script's clock) from a ``ConnectorSubject`` and a
   trickle of 64 every 20 ms, warmed through the built index; 8 warm-up
   and 48 timed ``/v1/retrieve`` (k=3), then the trickle paused and 8 held
   retrieves and one k=80 held against a plain scan of the index's rows
   with the plain encoder's query embedding, ``/v1/statistics``
   (file_count = documents pushed), ``/v1/inputs`` (both answered through
   ``join_left(stats, id=queries.id)`` as in the JAX package: the graph's
   joins are retrieve's ``ix`` and two left joins, and before the first
   document both answer the left join's empty row) and
   ``VectorStoreClient`` against the raw POST; retrieve latencies, the
   tracker's stages, ingest docs/s, launches (K1, K2, K2 score) and peak
   memory. Graph A runs with its index's semantic result cache on (the
   default), whose counters print beside ``knn_p50_e2e_ms``. Both runs
   stop through ``stop_all()``, and an error in a run fails the phase;
11b. adaptive rag (BASELINE.md config 3, the Adaptive-RAG template):
   5,000 text files of 6 ``make_docs`` texts each, written in batches of
   1,000 while ``pw.io.fs.read(plaintext_by_file, streaming,
   with_metadata)`` reads them, through ``TokenCountSplitter(max_tokens=
   120)`` (25,000 chunks) and framework A's embedder into bf16 cos
   indexes (one a query route, as in the JAX package), answered by
   ``AdaptiveRAGQuestionAnswerer(n_starting_documents=2, factor=2,
   max_iterations=3)`` behind ``run_server(threaded=True)`` with an
   offline chat that answers when a document of its prompt holds the
   question's marker. 64 ``POST /v1/pw_ai_answer`` aimed at 2, 4, 8
   documents and never, then 500 new files written while it serves and
   16 questions on them; every answer and its chat calls against the
   plain path (the plain encoder's query embedding, a plain scan of the
   index's rows, the geometric strategy on the host); ``/v1/retrieve``,
   ``/v1/statistics`` (file_count = files written) and ``RAGClient``
   against the raw POSTs; ``EncoderReranker`` and ``rerank_topk_filter``
   under ``run_batch`` against the plain encoder's cosines; a
   ``/v1/retrieve`` with ``filepath_globpattern`` and one with a
   ``metadata_filter`` (string filters, evaluated by jmespath-lite), each
   equal to the same filter over a plain scan of the index's rows. Prints
   answer latency, chunks indexed a second, chat calls a question, K1 and
   K2 launches (``launches_adaptive_rag``), peak memory and seconds;
11c. knn index (BASELINE.md config 1, the classic ``stdlib.ml``
   KNNIndex, batch mode): a 10,000-row CSV of an id and 384 floats read
   with ``pw.io.csv.read(static)``; ``KNNIndex`` cosine and euclidean
   (float32 slabs: ``torch.matmul`` and the key selection), 256 queries
   through ``get_nearest_items(k=3, with_distances=True)``,
   ``get_nearest_items_asof_now``, a ``metadata_filter`` and
   ``collapse_rows=False``, each against an exact float64 scan with ties
   held as tests/test_torch_knn_bf16.py holds them. Prints rows ingested
   a second, the search's p50 for one query and seconds;
11d. result cache (the semantic result cache, on by default): a paged
   cos index a dtype (bf16, int8, float32) of 100,000 x 384 seeded rows
   driven through the as-of-now operator under ``run_batch`` by a
   deterministic replay: 4,096 queries drawn by Zipf(1.1) from a
   96-vector pool (bench.py's SEM_POOL, SEM_ZIPF_S), k=3, 8 a tick, 64
   inserted rows every 16th tick (the store grows mid-replay) and 8
   deletions of served rows every 64th tick, with the cache off, then
   on. Holds: replies byte-identical on and off, hits and invalidations
   > 0, covered float32 inserts surviving the beat test, each tick's
   search launches (K2 / K3 top-k) equal on and off unless its queries
   all hit, 0 implicit host syncs. Prints the cache's counters, hit
   ratio, invalidations a tick, launches and seconds
   (``launches_result_cache``);
11e. paging (the contiguous slab beside the paged store): bench.py's
   ``bench_paging`` leg in the port (65,536 x 256 float32 rows in chunks
   of 4,096, both layouts; identical top-k, both grow, the canary's
   amplification gates, <= 6 ragged warm-up shapes), then 1,048,576 x
   384 bf16 and int8 rows from a reservation of 131,072 in chunks of
   65,536 on both layouts (the stall at each growth, B=1 / B=64 search
   p50, the top 10 equal), then two tenants' paged int8 indexes past
   their page quotas: ``PageQuotaExceeded`` from ``add_batch`` and from
   the graphed ingest (``launches_paging``);
12. array_sum (``GroupByOperator``'s device segment sum, off by default):
   ``device_segsum`` on the card bit for bit against the sequential numpy
   loop; then ``groupby(g).reduce(g, a=npsum(v))`` over two ticks of each
   ARRAY_SUM_CASES shape (D 384 or 64; 512 to 32,768 rows a tick; one
   group to one a row, and a skewed tick) with the route forced on and
   off (device, host) and under ``_segsum_pays``: events bit
   for bit equal, ``device_segsum`` called as the route says; prints the
   operator's host ms a tick, the route's pre-pass and the per-row adds
   it replaces. Then a 4-worker leg with the row gate off: every worker's
   replica takes ``device_segsum`` on both ticks, its events bit for bit
   the one-worker per-row loop's (-0.0 sign bits included);
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
15b. sharded knn (config 5's index at bench_knn's size), after the bf16
   index is freed: ``ShardedKnnIndex(384, mesh=<4 shards on cuda:0>,
   bf16, cos)`` fed the same rows through ``add_batch`` from host f32
   (``rows_that_fit`` cuts them where the host cannot hold the f32
   mirror), searched with bench_knn's 64 queries at B=1 and B=64 (k=10)
   and filtered (limit 20: fetch 80, K2's score twin). Checks: the first
   8 queries' top-10 equal the bf16 index's outside tie groups, every
   top-10 / top-20 against a plain scan of the shards, B=64 equal to B=1,
   K2 = searches x 4 shards x extents, K2 score = filtered searches x 4 x
   chunks a shard; then an int8 sharded index over the first 1,048,576
   rows: codes, scales and vsq bit for bit the host divide quantizer's,
   top-10 against ``score_i8_reference`` over the same shard tensors, K3
   top-k = 4. Prints rows/s added, p50 / p99, filtered p50s, peak memory,
   launches and seconds;
16. bench_knn's int8 deployment (bench.py:2547-2579), after the bf16
   index is freed: the same rows (each chunk made again from its seed)
   into an int8 cos index, searched, probed (knn_int8_p50_ms,
   knn_int8_batch64_ms) and checked as phase 15 with K3 top-k and K3
   score; bench.py's knn_int8_overlap10_vs_bf16, the mean overlap of the
   first 8 queries' top-10 with the bf16 index's;
17. profile: torch.profiler over three encoder forwards of each path's
   dispatch, device time by kernel group (K1, GEMM, other) and the
   device's busy share;
17b. train (``models/train.py``, after the card is freed): BGE-small's
   contrastive step (InfoNCE, AdamW at the JAX package's defaults, float32
   master weights, ``dense_attention``). One f32 step at B=8 S=64 on the
   card and on the port's CPU path, same weights and batch: the loss
   (rel 1e-4) and every gradient tensor (max error within 1e-3 of the
   tensor's largest entry + 1e-5 of the model's). Then bf16 on one fixed batch of 128 pairs x
   128 tokens a side (valid lengths drawn from [16, 128]): 3 warm-up and
   20 timed steps, every loss finite and the last below the first. Prints
   step ms p50/p90 (CUDA events), pairs/s, tokens/s, TFLOP/s (3 x
   ``encoder_cost(256, 128)`` a step) and peak memory;
17c. parallel (the training half of ``parallel/``, every mesh shards of
   cuda:0, BGE-small's width): ring attention over a data axis of 4 and
   Ulysses over 2 at B=8, S=512, 6 heads of 64, f32 and bf16, causal and
   not, against ``reference_attention`` (f32 1e-4, bf16 2^-5; ms beside
   it); the GPipe pipeline, 12 layers over 4 stages, 8 micro-batches of
   8 x 128 tokens, bf16, bit for bit against the sequential blocks (ms of
   each, in turns; the bubble 3/11); the sharded train step on a (data
   2, model 2) mesh, dense and 4 experts: one f32 step at B=8 S=64
   against the single-device step on the card from the same weights
   (loss rel 1e-4, gradients as in 17b), then 5 timed bf16 steps at 128
   pairs x 128 tokens (p50 beside 17b's, peak memory). No kernel
   launched (K1 0: the path is dense attention); the phase's seconds;
17d. moe (``EncoderConfig.bge_small(num_experts=4)``): the padded
   embedder into a bf16 index over 10,240 ``make_docs`` documents, then
   64 text queries (K1 = 12 x encoder dispatches, every top 10 against a
   plain scan, each copy's B=1 embedding within cosine 0.99 of its
   document's row); 512 documents' embeddings through K1 against
   ``attention_reference``, bf16 (min row cosine >= 0.99: top-1 routing
   turns rounding into a change of expert for near-tied tokens, counted)
   and f32 (>= 0.9999); the ragged embedder into an int8 index, one
   chunk through path 2's graphed step after a warm-up (one replay, 0
   graphs captured, K1 with segment ids 12, K4 1; ragged vs padded cosine
   >= 0.99, bf16); then phase 17b's f32 hold and 10 bf16 steps on this
   config;
17e. clip (``ClipConfig()``: 224-pixel images, 16-pixel patches, a ViT
   of 6 x 192, a BGE-small-wide text tower, embed_dim 128):
   ``ClipEmbedder`` over 512 seeded images (ndarrays) and 512 texts
   (finite unit rows; images/s, texts/s); both towers, ``clip_loss`` and
   every gradient in f32 at B=4 on the card against the CPU; 10
   ``clip_train_step``s (Adam 3e-5: at the default 1e-3 the towers
   collapse to chance from random init) at B=64 in bf16 on one batch of
   pairs (image i lights cell i of an 8 x 8 grid over noise, text i an
   8-word caption), finite and falling (step ms, peak memory);
17f. ml (``pw.stdlib.ml``): ``kmeans_labels`` at 262,144 x 384 float32
   points from 1,024 seeded blobs, k = 1024, 25 steps, weights 1-4, on the
   card (0 implicit syncs, no kernel launched), its labels against a
   float64 Lloyd run on the card from the same initial centres (>= 99.9%
   equal) and a second run, the partition against the blobs (NMI >= 0.9);
   the loop's CUDA-event ms beside the wall; ``clustering_via_lsh``
   through the engine over 20,000 x 384 vectors from 64 blobs (L = 8, M
   = 3, k = 64: every vector labelled once, one k-means on the card, NMI
   >= 0.8); the bucketed LSH classifier (M = 4) over the same vectors,
   128 fresh queries, every label equal to a direct computation of the
   vote, accuracy against the blob labels >= 0.9;
18. temporal (host only, on a machine without pandas; last, since its
   graphs leave memoized keys and objects behind): sliding(50, 100)
   over bench's rows; tumbling(100) under ``common_behavior(delay=50,
   cutoff=200)`` and ``exactly_once_behavior()`` (against a tick-by-tick
   simulation of the thresholds); ``session(max_gap=3)`` over the first
   10,000 rows (cut from 100,000: sessions re-sort each instance's times
   every tick); over two 5,000-row tables drawn next ``asof_now_join``
   (inner, left), ``asof_join`` (backward, forward, nearest; inner,
   outer), ``interval_join`` (four ``how``), ``window_join`` (tumbling,
   session), ``sort``, ``diff``, ``interpolate``: every final table
   against a plain Python computation, no kernel launched, pandas never
   imported.

The second-to-last line is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import struct
import subprocess
import sys
import time
import typing

import numpy as np

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
    peak_flops, peak_bytes = peaks()
    print(f"[device] bounds and MFU read {peak_flops / 1e12} TFLOP/s dense "
          f"bf16, {peak_bytes / 1e9} GB/s (engine/profiler.py "
          f"machine_params)", flush=True)
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


def peaks() -> tuple[float, float]:
    """The card's dense bf16 rate (FLOP/s) and memory rate (bytes/s):
    engine/profiler.py's ``machine_params``, the port's one table. The
    bounds and MFU keys here are the H100's own, so a BENCH_PEAK_TFLOPS or
    BENCH_HBM_GBPS override that moves them away from the H100 SXM's
    data-sheet rates fails the run instead of rescaling every bound."""
    from pathway_tpu_torch.engine.profiler import (H100_HBM_GBPS,
                                                   H100_PEAK_TFLOPS,
                                                   machine_params)

    mp = machine_params()
    if (mp["peak_tflops"], mp["hbm_gbps"]) != (H100_PEAK_TFLOPS,
                                               H100_HBM_GBPS):
        fail(f"BENCH_PEAK_TFLOPS / BENCH_HBM_GBPS set machine_params to "
             f"{mp['peak_tflops']} TFLOP/s, {mp['hbm_gbps']} GB/s; the "
             f"smoke's bounds use the H100 SXM's {H100_PEAK_TFLOPS} "
             f"TFLOP/s, {H100_HBM_GBPS} GB/s: unset them")
    return mp["peak_tflops"] * 1e12, mp["hbm_gbps"] * 1e9


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    peak_flops, peak_bytes = peaks()
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
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


# bench.py's bench_etl (bench.py:1832-1946): rows, ticks and vocabulary of
# its run_once graph, never cut
ETL_ROWS, ETL_TICKS, ETL_VOCAB = 100_000, 50, 5000


def cpu_model() -> str:
    """The host CPU's model (/proc/cpuinfo's "model name", else lscpu's
    "Model name") and architecture, for the host-only rates."""
    import platform

    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "model name" and value.strip():
                    model = value.strip()
                    break
    except OSError:
        pass
    if model is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        for line in out.splitlines():
            key, _, value = line.partition(":")
            if key.strip() == "Model name" and value.strip():
                model = value.strip()
                break
    return f"{model or 'model not reported'} ({platform.machine()})"


def graph_run(build, n_workers: int = 1) -> dict:
    """Build a graph with ``build(pw)`` (a table, or a tuple of tables
    whose first is the result), capture each table and time
    ``run_batch(n_workers)`` on the host clock."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner

    G.clear()
    try:
        out = build(pw)
        tables = out if isinstance(out, tuple) else (out,)
        runner = GraphRunner()
        caps = [runner.capture(t) for t in tables]
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            runner.run_batch(n_workers=n_workers)
            dt = time.perf_counter() - t0
    finally:
        G.clear()
    return {"s": dt, "cap": caps[0], "caps": caps, "gc_n": gc_clock.n,
            "gc_s": gc_clock.s,
            "ops": [node.op for node in runner.graph.nodes],
            "op_ms": op_ms_by_class(runner), "runner": runner}


def op_ms_by_class(runner) -> dict:
    """Host ms a run by operator class (summed over its nodes)."""
    out: dict = {}
    for node in runner.graph.nodes:
        name = type(node.op).__name__
        out[name] = out.get(name, 0.0) + \
            runner._scheduler.stats[node.id]["total_ms"]
    return out


def etl_run(words, qtys, ticks, n_workers: int = 1) -> dict:
    """bench_etl's ``run_once(n_workers)`` graph through the port
    (bench.py:1898-1934): the events table, the ``lex`` dimension table,
    ``events.groupby(events.word).reduce(word, n=count(), total=sum(qty))``
    joined with ``lex`` on the word; ``run_batch(n_workers)`` timed on
    the host clock as bench.py times it (``graph_run``), with the rate
    (rows/s)."""
    def build(pw):
        class S(pw.Schema):
            word: str
            qty: int

        class L(pw.Schema):
            word: str
            cat: str

        events = pw.debug.table_from_rows(
            S, [(f"w{words[i]}", int(qtys[i]), int(ticks[i]) * 2, 1)
                for i in range(len(words))], is_stream=True)
        lex = pw.debug.table_from_rows(
            L, [(f"w{i}", f"cat{i % 7}") for i in range(ETL_VOCAB)])
        counts = events.groupby(events.word).reduce(
            events.word, n=pw.reducers.count(),
            total=pw.reducers.sum(events.qty))
        return counts.join(lex, counts.word == lex.word).select(
            counts.word, counts.n, counts.total, lex.cat)

    run = graph_run(build, n_workers)
    run["rate"] = len(words) / run["s"]
    return run


def phase_etl(card: str) -> None:
    """bench.py's bench_etl one-worker graph (WordCount + a dimension join)
    through the port at bench's sizes: 100,000 rows over 50 ticks, a
    vocabulary of 5,000 words, ``default_rng(0)`` drawing words,
    quantities and ticks in bench's order. Host code only: the groupby
    lowers to ``ColumnarGroupByOperator`` (native gather/emit passes,
    native/fastgroup.cpp) and the join is an inner bilinear
    ``JoinOperator`` (native pass, native/fastjoin.cpp), both built with
    g++ against the interpreter's Python.h. Runs native, Python loops
    (both passes off in-process), Python loops, native. Holds: Python.h
    present, both passes loaded, the columnar operator built, the join's
    native pass taken on every tick with input (and not with the passes
    off), the final table equal to a plain numpy count, sum and dict join
    over the same draws, the native runs' consolidated events (keys
    included) equal to the Python loops', and no kernel launched. Prints
    ``etl_rows_per_s_1w`` (bench.py's key) and
    ``etl_rows_per_s_1w_python_loops``, the host's CPU and cores, and the
    garbage collector's collections in each timed run."""
    import sysconfig

    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    label = "etl"
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        fail(f"{label}: no Python.h in {include}: the native join and "
             "groupby passes cannot be built")
    t0 = time.perf_counter()
    fastjoin, fastgroup = ops._get_fastjoin(), ops._get_fastgroup()
    if fastjoin is None or fastgroup is None:
        fail(f"{label}: a native pass did not load: {ops.NATIVE_ERRORS}")
    print(f"[{label}] native passes {fastjoin.__name__}, "
          f"{fastgroup.__name__} built (g++, {include}/Python.h) and loaded "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)  # bench.py's draws, in its order
    words = rng.integers(0, ETL_VOCAB, size=ETL_ROWS)
    qtys = rng.integers(1, 10, size=ETL_ROWS)
    ticks = np.sort(rng.integers(0, ETL_TICKS, size=ETL_ROWS))
    input_ticks = len(np.unique(ticks))
    # the plain result: a count and a sum per word, the category by dict
    n_of = np.bincount(words, minlength=ETL_VOCAB)
    total_of = np.zeros(ETL_VOCAB, np.int64)
    np.add.at(total_of, words, qtys)
    cat_of = {f"w{i}": f"cat{i % 7}" for i in range(ETL_VOCAB)}
    want = sorted((f"w{i}", int(n_of[i]), int(total_of[i]), cat_of[f"w{i}"])
                  for i in np.flatnonzero(n_of))
    for count in LAUNCH_COUNTS:
        count.launches = 0
    runs = []
    for native in (True, False, False, True):
        ops._FASTJOIN, ops._FASTGROUP = (fastjoin, fastgroup) if native \
            else (None, None)
        try:
            run = etl_run(words, qtys, ticks)
        finally:
            ops._FASTJOIN, ops._FASTGROUP = fastjoin, fastgroup
        run["native"] = native
        runs.append(run)
    launched = {c.name: c.launches for c in LAUNCH_COUNTS if c.launches}
    if launched:
        fail(f"{label}: kernels launched in a host-only phase: {launched}")
    events = []
    for i, run in enumerate(runs):
        kinds = [type(op).__name__ for op in run["ops"]]
        groups = [op for op in run["ops"]
                  if isinstance(op, ops.ColumnarGroupByOperator)]
        joins = [op for op in run["ops"] if isinstance(op, ops.JoinOperator)]
        if len(groups) != 1 or "GroupByOperator" in kinds:
            fail(f"{label} run {i}: the groupby did not lower to "
                 f"ColumnarGroupByOperator: {kinds}")
        if len(joins) != 1 or joins[0].mode != "inner" \
                or not joins[0]._bilinear:
            fail(f"{label} run {i}: no inner bilinear JoinOperator: {kinds}")
        want_steps = input_ticks if run["native"] else 0
        if groups[0].native_steps != want_steps:
            fail(f"{label} run {i}: the groupby's native pass ran "
                 f"{groups[0].native_steps} steps, not {want_steps}")
        run["join_steps"] = joins[0].native_steps
        if run["native"] and not 0 < run["join_steps"] <= input_ticks + 1:
            fail(f"{label} run {i}: _step_inner_native ran "
                 f"{run['join_steps']} times over {input_ticks} input ticks")
        if not run["native"] and run["join_steps"]:
            fail(f"{label} run {i}: _step_inner_native ran with the passes "
                 "off")
        got = sorted(run["cap"].snapshot().values())
        if got != want:
            fail(f"{label} run {i}: the final table differs from the plain "
                 f"numpy count, sum and dict join ({len(got)} rows, "
                 f"{len(want)} wanted)")
        events.append(sorted(
            (time_, int(key), diff, row)
            for key, row, time_, diff in run["cap"].consolidated_events()))
    if not (events[0] == events[1] == events[2] == events[3]):
        fail(f"{label}: the native runs' consolidated events differ from "
             "the Python loops'")
    native_rates = [r["rate"] for r in runs if r["native"]]
    python_rates = [r["rate"] for r in runs if not r["native"]]
    print(f"[{label}] bench.py's keys: etl_rows_per_s_1w "
          f"{native_rates[0]:.1f} (then {native_rates[1]:.1f}), "
          f"etl_rows_per_s_1w_python_loops {python_rates[0]:.1f} (then "
          f"{python_rates[1]:.1f}); etl_n_rows {ETL_ROWS}, etl_ticks "
          f"{ETL_TICKS}, vocabulary {ETL_VOCAB}; host CPU {cpu_model()}, "
          f"{os.cpu_count()} cores [{card}]", flush=True)
    print(f"[{label}] by run (native, loops, loops, native): "
          + "; ".join(f"{r['rate']:.1f} rows/s, {r['gc_n']} collections "
                      f"{r['gc_s'] * 1e3:.1f} ms, join native steps "
                      f"{r['join_steps']}, groupby "
                      f"{r['op_ms']['ColumnarGroupByOperator']:.1f} ms, join "
                      f"{r['op_ms']['JoinOperator']:.1f} ms, capture "
                      f"{r['op_ms']['OutputOperator']:.1f} ms"
                      for r in runs) + f" [{card}]",
          flush=True)
    print(f"[{label}] holds: Python.h present, both passes loaded, "
          f"ColumnarGroupByOperator built (native steps = {input_ticks} "
          f"input ticks), _step_inner_native taken "
          f"{runs[0]['join_steps']} times (0 with the passes off), final "
          f"table = plain numpy count/sum/dict join ({len(want)} words), "
          f"native consolidated events = Python loops' "
          f"({len(events[0])} events, keys included), 0 kernel launches",
          flush=True)


ETL_WORKERS = 8  # bench.py's run_once(8)
EXCHANGE_ROWS = 20_000  # bench_exchange's payload: min(20,000, n_rows)


def etl_worker_state(run: dict) -> tuple[list, list]:
    """Per worker of a sharded etl run: the groupby's live group keys and
    the join's left row keys."""
    from pathway_tpu_torch.engine import operators as ops

    runner = run["runner"]
    sched = runner._scheduler
    by_cls = {type(n.op): sched._replicas[n.id] for n in runner.graph.nodes}
    groups = [sorted(int(gk) for gk, code in rep._by_gkey.items()
                     if rep._cnt[code] > 0)
              for rep in by_cls[ops.ColumnarGroupByOperator]]
    lefts = [sorted(int(k) for g in rep.left.values() for k in g)
             for rep in by_cls[ops.JoinOperator]]
    return groups, lefts


def bench_exchange(words, qtys) -> tuple[dict, int]:
    """bench.py's ``bench_exchange`` (bench.py:1863-1896) through the
    port's codec (engine/wire.py): 20,000 ``(hash_values("row", i),
    (word, qty), 1)`` entries, encoded and decoded five times, best of 5;
    returns bench's six keys and the frame's kind. Fails unless every
    decode returns the payload encoded."""
    from pathway_tpu_torch.engine import wire
    from pathway_tpu_torch.internals.keys import hash_values

    n = min(EXCHANGE_ROWS, len(words))
    ents = [(hash_values("row", i), (f"w{words[i]}", int(qtys[i])), 1)
            for i in range(n)]
    payload = {"rows": {0: {0: ents}}, "wm": None, "bcast": None}
    trials = []
    blob = b""
    for _ in range(5):
        t0 = time.perf_counter()
        chunks, _total, _rows = wire.encode_frame(("x", 1, 0), payload)
        blob = b"".join(chunks)
        mid = time.perf_counter()
        tag, out, rows = wire.decode_frame(blob)
        trials.append((mid - t0, time.perf_counter() - mid))
        if tag != ("x", 1, 0) or rows != n or out != payload:
            fail("etl sharded: bench_exchange's frame did not decode to "
                 "the payload encoded")
    best = min(trials, key=sum)
    sums_us = [(e + d) / n * 1e6 for e, d in trials]
    return {
        "exchange_bytes_per_row": round(len(blob) / n, 1),
        "exchange_encode_us_per_row": round(best[0] / n * 1e6, 3),
        "exchange_decode_us_per_row": round(best[1] / n * 1e6, 3),
        "exchange_encdec_us_per_row": round(min(sums_us), 3),
        "exchange_encdec_us_per_row_single_trial": round(sums_us[0], 3),
        "exchange_encdec_us_per_row_worst": round(max(sums_us), 3),
    }, blob[3]


def phase_etl_sharded(card: str) -> None:
    """bench.py's bench_etl at n workers (bench.py:1900-1990), host only:
    ``run_once(1)`` (its scheduler gives ``etl_exchange_rounds_per_tick``),
    ``run_once(8)``, then the fit run at ``min(8, os.cpu_count())``
    workers (the 8-worker run again when that is 8, as bench.py reuses
    it), over bench's draws (``default_rng(0)``, 100,000 rows, 50 ticks, a
    vocabulary of 5,000). Holds: the sharded final table equal to the
    plain numpy count, sum and dict join (phase_etl's oracle), its
    consolidated events (keys included) equal to the one-worker run's,
    the groupby's and the join's state on at least 2 of the 8 workers with
    no key on two, and no kernel launched. Then bench_exchange through the
    port's ``wire.py`` on bench's 20,000-row payload. Prints bench.py's
    keys: ``etl_rows_per_s_8w``, ``etl_8w_oversubscribed``,
    ``etl_n_cores``, ``etl_rows_per_s_per_core``,
    ``etl_exchange_rounds_per_tick`` and the six ``exchange_*`` keys."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    label = "etl sharded"
    # built (and loaded) before the clock starts: phase_etl has built them
    # in the whole script, this phase alone builds them here
    if ops._get_fastjoin() is None or ops._get_fastgroup() is None:
        fail(f"{label}: a native pass did not load: {ops.NATIVE_ERRORS}")
    rng = np.random.default_rng(0)  # bench.py's draws, in its order
    words = rng.integers(0, ETL_VOCAB, size=ETL_ROWS)
    qtys = rng.integers(1, 10, size=ETL_ROWS)
    ticks = np.sort(rng.integers(0, ETL_TICKS, size=ETL_ROWS))
    n_of = np.bincount(words, minlength=ETL_VOCAB)
    total_of = np.zeros(ETL_VOCAB, np.int64)
    np.add.at(total_of, words, qtys)
    want = sorted((f"w{i}", int(n_of[i]), int(total_of[i]), f"cat{i % 7}")
                  for i in np.flatnonzero(n_of))
    cores = os.cpu_count() or 1
    fit = min(ETL_WORKERS, cores)
    for count in LAUNCH_COUNTS:
        count.launches = 0
    one = etl_run(words, qtys, ticks, 1)
    rounds = one["runner"]._scheduler.exchange_rounds_per_tick()
    eight = etl_run(words, qtys, ticks, ETL_WORKERS)
    runs = [one, eight]
    if 1 < fit != ETL_WORKERS:
        runs.append(etl_run(words, qtys, ticks, fit))
    launched = {c.name: c.launches for c in LAUNCH_COUNTS if c.launches}
    if launched:
        fail(f"{label}: kernels launched in a host-only phase: {launched}")
    ref = sorted((t, int(k), d, row)
                 for k, row, t, d in one["cap"].consolidated_events())
    for run in runs:
        n = run["runner"]._scheduler.n_workers
        if sorted(run["cap"].snapshot().values()) != want:
            fail(f"{label}: the {n}-worker final table differs from the "
                 "plain numpy count, sum and dict join")
        got = sorted((t, int(k), d, row)
                     for k, row, t, d in run["cap"].consolidated_events())
        if got != ref:
            fail(f"{label}: the {n}-worker consolidated events differ "
                 "from the one-worker run's")
    groups, lefts = etl_worker_state(eight)
    for what, per in (("groupby", groups), ("join", lefts)):
        flat = [k for w in per for k in w]
        if len(per) != ETL_WORKERS or sum(1 for w in per if w) < 2 \
                or len(flat) != len(set(flat)):
            fail(f"{label}: the {what}'s state is not partitioned over "
                 f"the {ETL_WORKERS} workers: {[len(w) for w in per]}")
    r1, r8 = one["rate"], eight["rate"]
    rn = runs[2]["rate"] if len(runs) == 3 else r8
    per_core = rn / fit if fit > 1 else r1
    print(f"[{label}] bench.py's keys: etl_rows_per_s_8w {r8:.1f}, "
          f"etl_8w_oversubscribed {cores < ETL_WORKERS}, etl_n_cores "
          f"{cores}, etl_rows_per_s_per_core {per_core:.1f} (fit run at "
          f"{fit} workers{' = the 8-worker run' if fit == 8 else ''}), "
          f"etl_exchange_rounds_per_tick {rounds}; the one-worker run "
          f"{r1:.1f} rows/s in this phase; host CPU {cpu_model()} [{card}]",
          flush=True)
    print(f"[{label}] by run: " + "; ".join(
        f"{r['runner']._scheduler.n_workers} workers {r['rate']:.1f} rows/s,"
        f" {r['gc_n']} collections {r['gc_s'] * 1e3:.1f} ms, groupby "
        f"{r['op_ms']['ColumnarGroupByOperator']:.1f} ms, join "
        f"{r['op_ms']['JoinOperator']:.1f} ms, capture "
        f"{r['op_ms']['OutputOperator']:.1f} ms" for r in runs)
          + f" [{card}]", flush=True)
    keys, kind = bench_exchange(words, qtys)
    print(f"[{label}] bench.py's keys (bench_exchange, the port's wire.py, "
          f"{min(EXCHANGE_ROWS, ETL_ROWS)} rows, frame kind {kind}): "
          + ", ".join(f"{k} {v}" for k, v in keys.items()) + f" [{card}]",
          flush=True)
    print(f"[{label}] holds: the {ETL_WORKERS}-worker final table = plain "
          f"numpy count/sum/dict join ({len(want)} words), its consolidated "
          f"events (keys included) = the one-worker run's ({len(ref)} "
          f"events), groupby groups on {sum(1 for w in groups if w)} of "
          f"{ETL_WORKERS} workers and join rows on "
          f"{sum(1 for w in lefts if w)}, no key on two workers, 0 kernel "
          f"launches; bench_exchange's frame decodes to the payload encoded"
          f" (5 of 5)", flush=True)


WINDOW = 100            # bench.py's run_windowed: tumbling(100)
SENSORS = 200           # its instance: s{word % 200}
SESSION_ROWS = 10_000   # session windows over the first rows (cut: O(rows) a tick)
JOIN_ROWS = 5_000       # phase_temporal's left and right tables (cut from
                        # 10,000 for the script's clock)
JOIN_KEYS = 2000        # their join key: a draw below 2000
JOIN_SPAN = 20_000      # their times: distinct draws below 20,000


def etl_draws() -> tuple:
    """bench.py's bench_etl draws in its order (bench.py:1857-1860, then
    run_windowed's ``at``, bench.py:1943); returns the generator too, so
    phase_temporal's tables are drawn after bench's."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, ETL_VOCAB, size=ETL_ROWS)
    qtys = rng.integers(1, 10, size=ETL_ROWS)
    ticks = np.sort(rng.integers(0, ETL_TICKS, size=ETL_ROWS))
    at = np.sort(rng.integers(0, ETL_ROWS // 10, size=ETL_ROWS))
    return rng, [f"s{w % SENSORS}" for w in words], qtys, ticks, at


def windowed_table(pw, sensors, qtys, ticks, at):
    """bench.py's run_windowed source (bench.py:1941-1948): (sensor, v,
    at) rows at time 2 x tick."""
    class S(pw.Schema):
        sensor: str
        v: int
        at: int

    return pw.debug.table_from_rows(
        S, [(sensors[i], int(qtys[i]), int(at[i]), int(ticks[i]) * 2, 1)
            for i in range(len(at))], is_stream=True)


def windowed_reduce(pw, t, window, behavior=None):
    """bench.py's reduce (bench.py:1949-1953) over ``window``."""
    return pw.temporal.windowby(
        t, t.at, window=window, instance=t.sensor, behavior=behavior,
    ).reduce(sensor=pw.this._pw_instance, start=pw.this._pw_window_start,
             s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())


def window_sums(pairs) -> list:
    """Plain (sensor, start, sum, count) from (sensor, v, start) triples,
    one a row and window."""
    acc: dict = {}
    for sensor, v, start in pairs:
        s, c = acc.get((sensor, start), (0, 0))
        acc[(sensor, start)] = (s + int(v), c + 1)
    return sorted((k[0], k[1], s, c) for k, (s, c) in acc.items())


def snapshot_rows(run: dict) -> list:
    return sorted(run["cap"].snapshot().values(), key=repr)


def phase_etl_windowed(card: str) -> None:
    """bench.py's bench_etl windowed leg (``run_windowed``,
    bench.py:1936-1964) through the port at bench's sizes: 100,000 rows
    over 50 ticks, ``at`` sorted draws below 10,000, ``tumbling(100)``
    with instance ``s{word % 200}``, reduced to sensor, start,
    ``s=sum(v)``, ``c=count()`` under ``run_batch(n_workers=1)``. Host
    code: the window assignment is column arithmetic (the tumbling fast
    path) and the groupby is ``ColumnarGroupByOperator`` with its native
    pass. Runs native, Python loops, loops, native. Holds: the graph's
    operators are the JAX package's (Source, Map, ColumnarGroupByOperator,
    Map, Output), the native groupby pass taken on every input tick (never
    with it off), the final table equal to a plain sum and count per
    (sensor, at // 100 x 100) (19,875 windows), the native runs'
    consolidated events (keys included) equal to the loops', and no
    kernel launched. Prints bench.py's ``etl_windowed_rows_per_s``."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    label = "etl windowed"
    fastjoin, fastgroup = ops._get_fastjoin(), ops._get_fastgroup()
    if fastgroup is None:
        fail(f"{label}: the native groupby pass did not load: "
             f"{ops.NATIVE_ERRORS}")
    _, sensors, qtys, ticks, at = etl_draws()
    input_ticks = len(np.unique(ticks))
    want = window_sums(zip(sensors, qtys, (at // WINDOW) * WINDOW))
    if len(want) != 19_875:
        fail(f"{label}: the plain windows are {len(want)}, not bench's "
             "19,875: the draws are not bench.py's")
    expect_ops = ["SourceOperator", "MapOperator", "ColumnarGroupByOperator",
                  "MapOperator", "OutputOperator"]
    for count in LAUNCH_COUNTS:
        count.launches = 0
    runs = []
    for native in (True, False, False, True):
        ops._FASTJOIN, ops._FASTGROUP = (fastjoin, fastgroup) if native \
            else (None, None)
        try:
            run = graph_run(lambda pw: windowed_reduce(
                pw, windowed_table(pw, sensors, qtys, ticks, at),
                pw.temporal.tumbling(WINDOW)))
        finally:
            ops._FASTJOIN, ops._FASTGROUP = fastjoin, fastgroup
        run["native"] = native
        runs.append(run)
    launched = {c.name: c.launches for c in LAUNCH_COUNTS if c.launches}
    if launched:
        fail(f"{label}: kernels launched in a host-only phase: {launched}")
    events = []
    for i, run in enumerate(runs):
        kinds = [type(op).__name__ for op in run["ops"]]
        if kinds != expect_ops:
            fail(f"{label} run {i}: the graph's operators are {kinds}, not "
                 f"the JAX package's {expect_ops}")
        want_steps = input_ticks if run["native"] else 0
        if run["ops"][2].native_steps != want_steps:
            fail(f"{label} run {i}: the groupby's native pass ran "
                 f"{run['ops'][2].native_steps} steps, not {want_steps}")
        got = sorted(run["cap"].snapshot().values())
        if got != want:
            fail(f"{label} run {i}: the final table differs from the plain "
                 f"sum and count per window ({len(got)} rows, {len(want)} "
                 "wanted)")
        events.append(sorted(
            (time_, int(key), diff, row)
            for key, row, time_, diff in run["cap"].consolidated_events()))
    if not (events[0] == events[1] == events[2] == events[3]):
        fail(f"{label}: the native runs' consolidated events differ from "
             "the Python loops'")
    rate = [ETL_ROWS / r["s"] for r in runs]
    print(f"[{label}] bench.py's keys: etl_windowed_rows_per_s "
          f"{rate[0]:.1f} (then {rate[3]:.1f}); with the groupby's Python "
          f"loops {rate[1]:.1f} (then {rate[2]:.1f}); {ETL_ROWS} rows, "
          f"{ETL_TICKS} ticks, tumbling({WINDOW}), {SENSORS} sensors; host "
          f"CPU {cpu_model()}, {os.cpu_count()} cores [{card}]", flush=True)
    print(f"[{label}] by run (native, loops, loops, native): "
          + "; ".join(f"{r['s'] * 1e3:.1f} ms, {r['gc_n']} collections, "
                      f"maps {r['op_ms']['MapOperator']:.1f} ms, "
                      f"groupby "
                      f"{r['op_ms']['ColumnarGroupByOperator']:.1f} ms, "
                      f"capture {r['op_ms']['OutputOperator']:.1f} ms"
                      for r in runs) + f" [{card}]", flush=True)
    print(f"[{label}] holds: operators {', '.join(expect_ops)} (the JAX "
          f"package's), native groupby steps = {input_ticks} input ticks "
          f"(0 with the loops), final table = plain sum/count per window "
          f"({len(want)} windows), native consolidated events = the loops' "
          f"({len(events[0])} events, keys included), 0 kernel launches",
          flush=True)


def plain_behavior(ticks, at, buffer_thr, forget_thr) -> list:
    """The rows a behavior's buffer -> forget -> filter chain admits
    (engine/temporal_ops.py's semantics), simulated tick by tick over an
    insert-only stream: the buffer holds a row while its threshold is above
    the largest time it has seen, releasing everything at the end of the
    stream; the forget step drops a released row whose threshold is at or
    below the largest released time; the filter keeps every admitted
    row's result."""
    order = np.argsort(ticks, kind="stable")
    bounds = np.searchsorted(ticks[order], np.unique(ticks), side="right")
    held: list = []
    wm_b = wm_f = None
    admitted = []
    start = 0
    for end in [*bounds, None]:  # None: the end-of-stream flush tick
        rows = [] if end is None else list(order[start:end])
        start = start if end is None else end
        if rows:
            top = max(at[i] for i in rows)
            wm_b = top if wm_b is None else max(wm_b, top)
        pool = held + rows
        if end is None:
            out, held = pool, []
        else:
            out = [i for i in pool if buffer_thr(i) <= wm_b]
            held = [i for i in pool if buffer_thr(i) > wm_b]
        if out:
            top = max(at[i] for i in out)
            wm_f = top if wm_f is None else max(wm_f, top)
        admitted += [i for i in out if forget_thr(i) > wm_f]
    return sorted(admitted)


def sessions_of(times: list, max_gap) -> list:
    """(start, end) of each time's session: sorted times split where the
    gap to the previous one is at least max_gap."""
    out, cur = [], []
    for t in sorted(times):
        if cur and t - cur[-1] >= max_gap:
            out.append(cur)
            cur = []
        cur.append(t)
    if cur:
        out.append(cur)
    return {t: (s[0], s[-1]) for s in out for t in s}


def join_side(rng, n: int) -> list:
    """(k, v, at, tick) rows: key below JOIN_KEYS, distinct sorted times."""
    keys = rng.integers(0, JOIN_KEYS, size=n)
    vals = rng.integers(0, 1000, size=n)
    at = np.sort(rng.choice(JOIN_SPAN, size=n, replace=False))
    ticks = np.sort(rng.integers(0, ETL_TICKS, size=n))
    return [(f"k{keys[i]}", int(vals[i]), int(at[i]), int(ticks[i]))
            for i in range(n)]


def side_table(pw, rows):
    return pw.debug.table_from_rows(
        pw.schema_from_types(k=str, v=int, at=int),
        [(k, v, at, 2 * tick, 1) for k, v, at, tick in rows], is_stream=True)


def plain_pairs(left, right, match) -> tuple[list, set, set]:
    """(lv, lat, rv, rat) of every same-key pair ``match`` accepts, and
    the left and right rows that have one."""
    by_key: dict = {}
    for j, r in enumerate(right):
        by_key.setdefault(r[0], []).append(j)
    pairs, lhit, rhit = [], set(), set()
    for i, l in enumerate(left):
        for j in by_key.get(l[0], ()):
            if match(l, right[j]):
                pairs.append((l[1], l[2], right[j][1], right[j][2]))
                lhit.add(i)
                rhit.add(j)
    return pairs, lhit, rhit


def padded(pairs, left, right, lhit, rhit, how: str) -> list:
    rows = list(pairs)
    if how in ("left", "outer"):
        rows += [(l[1], l[2], None, None) for i, l in enumerate(left)
                 if i not in lhit]
    if how in ("right", "outer"):
        rows += [(None, None, r[1], r[2]) for j, r in enumerate(right)
                 if j not in rhit]
    return sorted(rows, key=repr)


def phase_temporal(card: str) -> None:
    """Every other temporal entry point of the port once, on the card
    machine (which has no pandas), each held against a plain Python
    computation over the same rows:
    - over bench's 100,000 rows: ``sliding(hop=50, duration=100)``; the
      tumbling graph under ``common_behavior(delay=50, cutoff=200)`` and
      ``exactly_once_behavior()`` (against a tick-by-tick simulation of
      the buffer and forget thresholds);
    - ``session(max_gap=3)`` over the first 10,000 rows (cut from 100,000:
      sessions re-sort each instance's times every tick);
    - over two JOIN_ROWS-row tables drawn next from the same generator (key
      below 2000, distinct times below 20,000, 50 ticks):
      ``asof_now_join`` (inner, left: right rows up to the query's tick),
      ``asof_join`` (backward, forward, nearest; inner, outer),
      ``interval_join`` (interval(-30, 30), all four ``how``),
      ``window_join`` (tumbling(100) and session(max_gap=40), inner),
      ``sort``, ``diff`` and ``interpolate``.
    Holds every final table, no kernel launched, and pandas never
    imported. Prints each run's rows and host time."""
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    label = "temporal"
    for count in LAUNCH_COUNTS:
        count.launches = 0
    rng, sensors, qtys, ticks, at = etl_draws()
    lines = []

    def hold(name: str, build, want, got_of=snapshot_rows, n_in=ETL_ROWS):
        run = graph_run(build)
        got = got_of(run)
        if callable(want):
            want = want(run)
        if got != want:
            fail(f"{label} {name}: the port's final table differs from the "
                 f"plain computation ({len(got)} rows, {len(want)} wanted)")
        lines.append(f"{name} {n_in} rows -> {len(want)} in "
                     f"{run['s'] * 1e3:.1f} ms ({n_in / run['s']:.1f} rows/s)")
        return run

    start0 = (at // 50) * 50
    hold("sliding(50, 100)", lambda pw: windowed_reduce(
        pw, windowed_table(pw, sensors, qtys, ticks, at),
        pw.temporal.sliding(hop=50, duration=100)),
        window_sums([*zip(sensors, qtys, start0),
                     *zip(sensors, qtys, start0 - 50)]),
        got_of=lambda r: sorted(r["cap"].snapshot().values()))
    starts = (at // WINDOW) * WINDOW
    for name, behavior, thr in (
            ("common_behavior(delay=50, cutoff=200)",
             lambda pw: pw.temporal.common_behavior(delay=50, cutoff=200),
             (lambda i: starts[i] + 50, lambda i: starts[i] + WINDOW + 200)),
            ("exactly_once_behavior()",
             lambda pw: pw.temporal.exactly_once_behavior(),
             (lambda i: starts[i] + WINDOW, lambda i: starts[i] + WINDOW))):
        kept = plain_behavior(ticks, at, *thr)
        want = window_sums((sensors[i], qtys[i], starts[i]) for i in kept)
        hold(f"tumbling({WINDOW}) {name}", lambda pw, b=behavior:
             windowed_reduce(pw, windowed_table(pw, sensors, qtys, ticks, at),
                             pw.temporal.tumbling(WINDOW), b(pw)),
             want, got_of=lambda r: sorted(r["cap"].snapshot().values()))
        lines[-1] += f" ({len(kept)} rows admitted, {len(want)} windows)"
    n = SESSION_ROWS
    spans: dict = {}
    for s in set(sensors[:n]):
        idx = [i for i in range(n) if sensors[i] == s]
        of = sessions_of([int(at[i]) for i in idx], 3)
        for i in idx:
            spans[i] = of[int(at[i])]
    hold("session(max_gap=3)", lambda pw: windowed_reduce(
        pw, windowed_table(pw, sensors[:n], qtys[:n], ticks[:n], at[:n]),
        pw.temporal.session(max_gap=3)),
        window_sums((sensors[i], qtys[i], spans[i][0]) for i in range(n)),
        got_of=lambda r: sorted(r["cap"].snapshot().values()), n_in=n)

    left, right = join_side(rng, JOIN_ROWS), join_side(rng, JOIN_ROWS)
    n_in = 2 * JOIN_ROWS

    def joined(call):
        def build(pw):
            lt, rt = side_table(pw, left), side_table(pw, right)
            return call(pw, lt, rt).select(
                lv=lt.v, lat=lt.at, rv=rt.v, rat=rt.at), rt
        return build

    for how in ("inner", "left"):
        pairs, lhit, _ = plain_pairs(left, right, lambda l, r: r[3] <= l[3])
        hold(f"asof_now_join {how}", joined(
            lambda pw, lt, rt, how=how: pw.temporal.asof_now_join(
                lt, rt, lt.k == rt.k, how=how)),
            padded(pairs, left, right, lhit, set(), how), n_in=n_in)
    by_key: dict = {}
    for j, r in enumerate(right):
        by_key.setdefault(r[0], []).append(j)

    def asof_want(run, direction: str, how: str) -> list:
        """The plain choice for each left row: the latest right row at or
        before it (backward), the earliest at or after (forward), the
        nearest (ties: the smaller right row key, the argmin reducer's
        rule); unchosen right rows padded in outer mode."""
        key_of = {row[2]: int(k)
                  for k, row in run["caps"][1].snapshot().items()}
        best = {}
        for i, l in enumerate(left):
            cands = [(abs(right[j][2] - l[2]), key_of[right[j][2]], j)
                     for j in by_key.get(l[0], ())
                     if direction == "nearest"
                     or (direction == "backward" and right[j][2] <= l[2])
                     or (direction == "forward" and right[j][2] >= l[2])]
            if cands:
                best[i] = min(cands)[2]
        pairs = [(left[i][1], left[i][2], right[j][1], right[j][2])
                 for i, j in best.items()]
        return padded(pairs, left, right, set(best), set(best.values()), how)

    for direction in ("backward", "forward", "nearest"):
        for how in ("inner", "outer"):
            hold(f"asof_join {direction} {how}", joined(
                lambda pw, lt, rt, how=how, d=direction: pw.temporal.asof_join(
                    lt, rt, lt.at, rt.at, lt.k == rt.k, how=how,
                    direction=d)),
                lambda run, how=how, d=direction: asof_want(run, d, how),
                n_in=n_in)
    for how in ("inner", "left", "right", "outer"):
        pairs, lhit, rhit = plain_pairs(
            left, right, lambda l, r: -30 <= r[2] - l[2] <= 30)
        hold(f"interval_join {how}", joined(
            lambda pw, lt, rt, how=how: pw.temporal.interval_join(
                lt, rt, lt.at, rt.at, pw.temporal.interval(-30, 30),
                lt.k == rt.k, how=how)),
            padded(pairs, left, right, lhit, rhit, how), n_in=n_in)
    pairs, _, _ = plain_pairs(
        left, right, lambda l, r: l[2] // WINDOW == r[2] // WINDOW)
    hold(f"window_join tumbling({WINDOW})", joined(
        lambda pw, lt, rt: pw.temporal.window_join(
            lt, rt, lt.at, rt.at, pw.temporal.tumbling(WINDOW),
            lt.k == rt.k)), sorted(pairs, key=repr), n_in=n_in)
    times: dict = {}
    for r in left + right:
        times.setdefault(r[0], []).append(r[2])
    span = {k: sessions_of(ts, 40) for k, ts in times.items()}
    pairs, _, _ = plain_pairs(
        left, right, lambda l, r: span[l[0]][l[2]] == span[r[0]][r[2]])
    hold("window_join session(max_gap=40)", joined(
        lambda pw, lt, rt: pw.temporal.window_join(
            lt, rt, lt.at, rt.at, pw.temporal.session(max_gap=40),
            lt.k == rt.k)), sorted(pairs, key=repr), n_in=n_in)

    def ordered_got(run):
        """key -> row of the source, and the result's rows in time order."""
        src, out = run["caps"][1].snapshot(), run["cap"].snapshot()
        keys = sorted(src, key=lambda k: src[k][2])
        return [(src[k][2], *out[k]) for k in keys], keys

    def sort_want(run):
        """prev / next: the neighbours in time order (times distinct)."""
        got, keys = ordered_got(run)
        return [(row[0], keys[i - 1] if i else None,
                 keys[i + 1] if i + 1 < len(keys) else None)
                for i, row in enumerate(got)]

    hold("sort", lambda pw: (lambda t: (t.sort(t.at), t))(
        side_table(pw, left)), sort_want,
        got_of=lambda run: ordered_got(run)[0], n_in=JOIN_ROWS)
    by_time = sorted(left, key=lambda r: r[2])
    diffs = [(r[2], None if i == 0 else r[1] - by_time[i - 1][1])
             for i, r in enumerate(by_time)]
    hold("diff", lambda pw: (lambda t: (t.diff(t.at, t.v), t))(
        side_table(pw, left)), diffs,
        got_of=lambda run: ordered_got(run)[0], n_in=JOIN_ROWS)
    gaps = rng.random(JOIN_ROWS) < 0.3
    xs = [None if gaps[i] else float(r[1]) for i, r in enumerate(by_time)]
    filled = []
    for i, x in enumerate(xs):
        if x is None:
            p = next((j for j in range(i - 1, -1, -1) if xs[j] is not None),
                     None)
            q = next((j for j in range(i + 1, len(xs)) if xs[j] is not None),
                     None)
            if p is not None and q is not None:
                t, tp, tq = by_time[i][2], by_time[p][2], by_time[q][2]
                x = xs[p] + (xs[q] - xs[p]) * ((t - tp) / (tq - tp))
            else:
                x = xs[p] if p is not None else (xs[q] if q is not None
                                                  else None)
        filled.append((by_time[i][2], x))

    def interp_build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(at=int, x=typing.Optional[float]),
            [(r[2], xs[i], 2 * r[3], 1) for i, r in enumerate(by_time)],
            is_stream=True)
        return t.interpolate(t.at, t.x)

    hold("interpolate", interp_build, filled,
         got_of=lambda run: sorted(run["cap"].snapshot().values()),
         n_in=JOIN_ROWS)
    launched = {c.name: c.launches for c in LAUNCH_COUNTS if c.launches}
    if launched:
        fail(f"{label}: kernels launched in a host-only phase: {launched}")
    if "pandas" in sys.modules:
        fail(f"{label}: pandas was imported")
    for line in lines:
        print(f"[{label}] {line} [{card}]", flush=True)
    print(f"[{label}] holds: {len(lines)} runs, each final table = its plain "
          "computation; 0 kernel launches; pandas never imported", flush=True)


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
        peak_flops, peak_bytes = peaks()
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
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


# bench.py's bench_embed (bench.py:926-1057): its batch, width cap,
# vocabulary and clock, never cut
EMBED_BATCH = 2048        # bench.py's BATCH
EMBED_SEQ = 128           # bench.py's SEQ
EMBED_WINDOW_S = 15.0     # the timed loop runs at least this long ...
EMBED_MIN_BATCHES = 8     # ... and at least this many batches
EMBED_MFU_REPS = 8        # _device_only_mfu: forwards a loop, best of 3
EMBED_MODEL = "BAAI/bge-small-en-v1.5"


def embed_pack(ids: np.ndarray, mask: np.ndarray) -> tuple:
    """bench.py's ``pack`` (bench.py:973-980): int16 ids cut to the batch's
    longest row rounded up to a multiple of 16 (at most SEQ), and per-row
    lengths."""
    lens = mask.sum(axis=1).astype(np.int32)
    width = min(EMBED_SEQ, max(16, int(-(-int(lens.max()) // 16) * 16)))
    return ids[:, :width].astype(np.int16), lens


def embed_model(card: str) -> tuple:
    """bench_embed's model (bench.py:941-951): the local BGE-small
    checkpoint when one is on disk, else random weights at BGE-small's
    shape (``init_params_host(0)``) and bench's synthetic vocabulary, which
    the native WordPiece engine tokenizes either way."""
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.models.hf_loader import (find_local_checkpoint,
                                                    load_model)

    path = find_local_checkpoint(EMBED_MODEL)
    if path:
        params, config, tokenizer = load_model(EMBED_MODEL)
        tokenizer.max_len = EMBED_SEQ
        print(f"[embed] weights and vocabulary: the local checkpoint of "
              f"{EMBED_MODEL} at {path}", flush=True)
    else:
        config = EncoderConfig.bge_small()
        params = init_params_host(0, config)
        tokenizer = framework_tokenizer(EMBED_SEQ)
        print(f"[embed] no local checkpoint of {EMBED_MODEL}: random "
              f"BGE-small weights (init_params_host(0)) and bench's "
              f"synthetic vocabulary, native WordPiece {tokenizer.native} "
              f"[{card}]", flush=True)
    return params, config, tokenizer


def device_only_mfu(model, config, peak: float) -> tuple[float, float]:
    """bench.py's ``_device_only_mfu`` (bench.py:1063-1103): EMBED_MFU_REPS
    forwards at EMBED_BATCH x EMBED_SEQ of ``ids + i``, each folded into a
    device accumulator, no host sync between them; best of 3 after a warm
    run. The ids are drawn below ``vocab - reps`` so ``ids + i`` stays in the
    table (the JAX gather clamps an index past it; torch's would fault).
    Returns (MFU, best seconds)."""
    import torch

    from pathway_tpu_torch._device import upload
    from pathway_tpu_torch.engine import device_sanitizer as ds
    from pathway_tpu_torch.engine.profiler import encoder_flops_per_token
    from pathway_tpu_torch.models.encoder import encode

    B, W, reps = EMBED_BATCH, EMBED_SEQ, EMBED_MFU_REPS
    dev = model.embeddings.token.weight.device
    ids = upload(torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size - reps, (B, W))), dev)
    lens = torch.full((B,), W - 5, dtype=torch.int32, device=dev)

    def loop() -> float:
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(reps):
            mask = torch.arange(W, device=dev)[None, :] < lens[:, None]
            acc = acc + encode(model, ids + i, mask).sum()
        with ds.explicit_sync("device-only MFU"):
            return float(acc)

    loop()  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        loop()
        best = min(best, time.perf_counter() - t0)
    flops = reps * B * W * encoder_flops_per_token(
        config.hidden, config.intermediate, config.layers, W)
    return flops / best / peak, best


def phase_embed(card: str) -> tuple[int, int]:
    """bench.py's bench_embed, as bench.py runs it, on one card: the
    model (``embed_model``), ``BruteForceKnnIndex(384, reserved_space=1 <<
    20, metric="cos", dtype="bfloat16")`` (paged), ``make_fused_ingest``
    over ``EncoderEmbedder.device_producer`` (int16 ids and row lengths up
    through pinned staging, the mask rebuilt on the card: bench's
    producer), bench's ``pack``, ``make_docs(BATCH * 4)``; one batch and
    three more to warm, the self-retrieval probe (doc 3 finds itself),
    then the timed loop: at least 15 s and 8 batches or until the index is
    full, batch i+1 tokenized while batch i runs, ``drain()`` at the end,
    the first batch dropped; then ``device_only_mfu``. Every ingest must
    take the fused path (True). Over the whole leg, as bench.py's
    ``_DeviceEventCounter`` counts them, CUDA graph captures
    (``embed_compile_count``: must be 0) and implicit host syncs
    (``embed_transfer_count``, report mode). Returns the launches of K1 and
    K2 over the leg (counts set to 0 at its start)."""
    import torch

    from pathway_tpu_torch.engine import device_sanitizer as ds
    from pathway_tpu_torch.engine.profiler import encoder_flops_per_token
    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.knn_kernels import TOPK_BF16
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    peak_tflops = peaks()[0] / 1e12
    params, config, tokenizer = embed_model(card)
    t_leg = time.perf_counter()
    compiles = ds.install_compile_counter()
    c0 = compiles()
    for count in LAUNCH_COUNTS:
        count.launches = 0
    with ds.count_syncs() as syncs:
        with ds.explicit_sync("weights upload"):
            emb = EncoderEmbedder(config=config, params=params,
                                  tokenizer=tokenizer, max_len=EMBED_SEQ,
                                  device="cuda")
        index = BruteForceKnnIndex(config.hidden, reserved_space=1 << 20,
                                   metric="cos", dtype="bfloat16")
        ingest = index.make_fused_ingest(emb.device_producer)
        docs = make_docs(EMBED_BATCH * 4)

        def run_batch(ids16, lens, key_base: int) -> None:
            keys = [Pointer(key_base + i) for i in range(len(ids16))]
            if not ingest(keys, emb.model, ids16, lens):
                fail(f"embed: the fused ingest of keys from {key_base} did "
                     f"not take the fused path")

        def packed(batch_docs):
            return embed_pack(*tokenizer.batch(batch_docs, pad_to=EMBED_SEQ))

        # warm-up: one batch and three more, then the self-retrieval probe
        for _ in range(4):
            run_batch(*packed(docs[:EMBED_BATCH]), 0)
        ids, mask = tokenizer.batch(docs[:8], pad_to=EMBED_SEQ)
        probe = emb.device_producer(emb.model, ids.astype(np.int16),
                                    mask.sum(axis=1).astype(np.int32))
        with ds.explicit_sync("probe embeddings"):
            probe = probe.cpu().numpy()
        res = index.search([(Pointer(10**9), probe[3], 1, None)])
        if not (res and res[0] and res[0][0][0] == Pointer(3)):
            fail(f"embed: self-retrieval failed: {res}")
        print(f"[embed] self-retrieval probe: doc 3's embedding finds doc 3 "
              f"first (distance {res[0][0][1]:.3e})", flush=True)

        # the timed loop (bench.py:1000-1036)
        window = {c: c.launches for c in LAUNCH_COUNTS}
        widths = []
        n_batches, key_base = 0, EMBED_BATCH
        batch_times, batch_tokens, batch_flops = [], [], []
        ids16, lens = packed(docs[:EMBED_BATCH])
        start = last_t = time.perf_counter()
        while True:
            run_batch(ids16, lens, key_base)
            widths.append(ids16.shape[1])
            batch_tokens.append(ids16.shape[0] * ids16.shape[1])
            batch_flops.append(batch_tokens[-1] * encoder_flops_per_token(
                config.hidden, config.intermediate, config.layers,
                ids16.shape[1]))
            nxt = docs[((n_batches + 1) % 4) * EMBED_BATCH:][:EMBED_BATCH]
            ids16, lens = packed(nxt)
            now = time.perf_counter()
            batch_times.append(now - last_t)
            last_t = now
            n_batches += 1
            key_base += EMBED_BATCH
            if (now - start > EMBED_WINDOW_S
                    and len(batch_times) >= EMBED_MIN_BATCHES) or \
                    key_base + EMBED_BATCH > index.capacity:
                break
        index.drain()
        now = time.perf_counter()
        batch_times[-1] += now - last_t
        window = {c: c.launches - window[c] for c in LAUNCH_COUNTS}
        sustained = batch_times[1:]
        docs_per_s = EMBED_BATCH * len(sustained) / float(np.sum(sustained))
        tokens_per_s = float(np.sum(batch_tokens[1:]) / np.sum(sustained))
        mfu = float(np.sum(batch_flops[1:]) / np.sum(sustained)) \
            / (peak_tflops * 1e12)
        mfu_dev, best_s = device_only_mfu(emb.model, config,
                                          peak_tflops * 1e12)
    forwards = emb.dispatches + 4 * EMBED_MFU_REPS
    k1, k2 = ATTENTION.launches, TOPK_BF16.launches
    n_compiles = compiles() - c0
    keys = {"docs_per_s": docs_per_s,
            "tokens_per_s": round(tokens_per_s, 0),
            "mfu_est": round(mfu, 3),
            "mfu_device_only": round(mfu_dev, 3),
            "mfu_peak_tflops": peak_tflops,
            "embed_compile_count": n_compiles,
            "embed_transfer_count": syncs.count}
    print(f"[embed] bench.py's keys: {json.dumps(keys)} [{card}]",
          flush=True)
    print(f"[embed] unrounded: tokens_per_s {tokens_per_s:.1f}, mfu_est "
          f"{mfu:.5f}, mfu_device_only {mfu_dev:.5f} (best of 3 loops of "
          f"{EMBED_MFU_REPS} forwards at {EMBED_BATCH}x{EMBED_SEQ}: "
          f"{best_s * 1e3:.2f} ms, {best_s / EMBED_MFU_REPS * 1e3:.2f} ms a "
          f"forward) [{card}]", flush=True)
    print(f"[embed] timed window: {n_batches} batches of {EMBED_BATCH} "
          f"(the first dropped), widths {sorted(set(widths))}, "
          f"{float(np.sum(batch_times)):.2f} s; batch ms p50 "
          f"{np.percentile(np.array(sustained) * 1e3, 50):.2f} p90 "
          f"{np.percentile(np.array(sustained) * 1e3, 90):.2f}; launches "
          f"in the window: K1 {window[ATTENTION]} ({N_LAYERS} x "
          f"{n_batches} = {N_LAYERS * n_batches}), K2 {window[TOPK_BF16]}; "
          f"over the leg K1 {k1} ({N_LAYERS} x {forwards} forwards), K2 "
          f"{k2} (the probe); "
          f"leg {time.perf_counter() - t_leg:.1f} s [{card}]", flush=True)
    if n_compiles != 0:
        fail(f"embed: {n_compiles} CUDA graphs captured in the leg")
    if window[ATTENTION] != N_LAYERS * n_batches or window[TOPK_BF16] != 0 \
            or any(n for c, n in window.items()
                   if c not in (ATTENTION, TOPK_BF16)):
        fail(f"embed: launches in the timed window {window}, expected K1 "
             f"{N_LAYERS * n_batches} and nothing else")
    if k1 != N_LAYERS * forwards or k2 != 1:
        fail(f"embed: K1 launched {k1} times over the leg (expected "
             f"{N_LAYERS * forwards}), K2 {k2} (expected 1)")
    if not (np.isfinite(docs_per_s) and docs_per_s > 0 and 0 < mfu_dev):
        fail(f"embed: keys out of range: {keys}")
    # free the leg's device state (the extent, the model) before the
    # phases after it, as bench.py frees it before its 10M leg
    del index, ingest, emb
    gc.collect()
    torch.cuda.empty_cache()
    return k1, k2


WARMUP_DOCS = 512         # documents ingested in steady state after warm-up


def phase_warmup(seed: int, card: str) -> None:
    """``pw.warmup`` on BGE-small under PATHWAY_DEVICE_SANITIZER=1 (raise
    mode), twice: padded (bench's framework embedder, max_len 128, batches
    of 512) into a bf16 ``DeviceEmbeddingKnnIndex`` already holding 512
    documents, with ``ks=(10,)``; and ragged (sequences of 512) into an
    empty int8 index, whose ladder captures one CUDA graph per chunk bucket.
    After each, in steady state, 512 fresh documents are ingested and a
    text query searched: nothing may raise (no capture, no implicit host
    sync), ``post_warmup_compiles()`` must read 0, the copy must find its
    document, and for the ragged run the warm-up captures must equal
    ``len(ragged_buckets())``. The sanitizer is closed after each run."""
    import traceback

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import device_sanitizer as ds
    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed, cfg)
    docs = make_docs(3 * WARMUP_DOCS, seed=seed + 5)
    saved = os.environ.get("PATHWAY_DEVICE_SANITIZER")
    os.environ["PATHWAY_DEVICE_SANITIZER"] = "1"
    try:
        for ragged in (False, True):
            label = "ragged, int8" if ragged else "padded, bf16"
            if ragged:
                emb = EncoderEmbedder(config=cfg, params=params, ragged=True,
                                      max_len=RAGGED_SEQ,
                                      tokenizer=framework_tokenizer(
                                          RAGGED_SEQ), device="cuda")
            else:
                emb = EncoderEmbedder(config=cfg, params=params,
                                      max_len=BENCH_SEQ,
                                      max_batch_size=WARMUP_DOCS,
                                      tokenizer=framework_tokenizer(
                                          BENCH_SEQ), device="cuda")
            index = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
                cfg.hidden, reserved_space=4 * WARMUP_DOCS, metric="cos",
                dtype="int8" if ragged else "bfloat16", device="cuda"))
            held = [] if ragged else list(range(WARMUP_DOCS))
            if held:
                index.add_batch([Pointer(i) for i in held],
                                [docs[i] for i in held])
            w0 = ds.warmup_compiles()
            t0 = time.perf_counter()
            out = pw.warmup(emb, index=index, ks=(10,))
            warm_s = time.perf_counter() - t0
            captures = ds.warmup_compiles() - w0
            fresh = range(WARMUP_DOCS, 2 * WARMUP_DOCS)
            try:
                t0 = time.perf_counter()
                index.add_batch([Pointer(i) for i in fresh],
                                [docs[i] for i in fresh])
                res = index.search([(Pointer(10**9), docs[WARMUP_DOCS + 7],
                                     10, None)])
                index.drain()
                steady_s = time.perf_counter() - t0
            except Exception as e:
                traceback.print_exc()
                fail(f"warmup ({label}): the steady state raised "
                     f"{type(e).__name__}: {e}")
            finally:
                ds.disarm()
            kinds = sorted({k for k, _ in out["compiled"]})
            print(f"[warmup] {label}: pw.warmup walked "
                  f"{len(out['compiled'])} entries {kinds} in {warm_s:.2f} "
                  f"s, {captures} CUDA graphs captured as warm-up"
                  f"{' (buckets ' + str(emb.ragged_buckets()) + ')' if ragged else ''}; "
                  f"steady state: {len(fresh)} fresh documents ingested and "
                  f"one text search in {steady_s * 1e3:.1f} ms, "
                  f"post-warm-up captures {ds.post_warmup_compiles()}, "
                  f"violations {len(ds.violations())}, index "
                  f"{len(index)} documents [{card}]", flush=True)
            if ds.post_warmup_compiles() != 0 or ds.violations():
                fail(f"warmup ({label}): {ds.post_warmup_compiles()} "
                     f"post-warm-up captures, violations {ds.violations()}")
            if ragged and captures != len(emb.ragged_buckets()):
                fail(f"warmup (ragged): {captures} captures, expected one "
                     f"a bucket ({len(emb.ragged_buckets())})")
            if not ragged and ("search", (10,)) not in [
                    (k, tuple(s)) for k, s in out["compiled"]]:
                fail(f"warmup (padded): no search warmed: {out['compiled']}")
            if len(index) != len(held) + len(fresh):
                fail(f"warmup ({label}): the index holds {len(index)} "
                     f"documents, expected {len(held) + len(fresh)}")
            if not res[0] or res[0][0][0] != Pointer(WARMUP_DOCS + 7):
                fail(f"warmup ({label}): the copy of document "
                     f"{WARMUP_DOCS + 7} found {res[0][:3]}")
            del index, emb
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ds.disarm()
        if saved is None:
            os.environ.pop("PATHWAY_DEVICE_SANITIZER", None)
        else:
            os.environ["PATHWAY_DEVICE_SANITIZER"] = saved


LOADER_DOCS = 64


def bert_state_dict(params: dict, gen) -> dict:
    """A BertModel's state dict (its key names, torch ``Linear`` weights
    as (out, in)) holding the JAX-layout tree ``params``; the pooler, which
    the encoder never reads, random from ``gen``."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    e = params["embeddings"]
    sd = {"embeddings.word_embeddings.weight": t(e["token"]),
          "embeddings.position_embeddings.weight": t(e["position"]),
          "embeddings.token_type_embeddings.weight": t(e["token_type"]),
          "embeddings.LayerNorm.weight": t(e["ln_scale"]),
          "embeddings.LayerNorm.bias": t(e["ln_bias"])}
    names = {"attention.self.query": ("attn", "wq", "bq"),
             "attention.self.key": ("attn", "wk", "bk"),
             "attention.self.value": ("attn", "wv", "bv"),
             "attention.output.dense": ("attn", "wo", "bo"),
             "intermediate.dense": ("mlp", "w1", "b1"),
             "output.dense": ("mlp", "w2", "b2")}
    for i, layer in enumerate(params["layers"]):
        pre = f"encoder.layer.{i}."
        for name, (block, w, b) in names.items():
            sd[pre + name + ".weight"] = t(layer[block][w].T)
            sd[pre + name + ".bias"] = t(layer[block][b])
        for name, block in (("attention.output.LayerNorm", "attn"),
                            ("output.LayerNorm", "mlp")):
            sd[pre + name + ".weight"] = t(layer[block]["ln_scale"])
            sd[pre + name + ".bias"] = t(layer[block]["ln_bias"])
    H = e["token"].shape[1]
    sd["pooler.dense.weight"] = t(gen.normal(size=(H, H)) * 0.02)
    sd["pooler.dense.bias"] = t(np.zeros(H))
    return sd


def phase_loader(seed: int, card: str) -> None:
    """The HF checkpoint loader on the card: a random BGE-small checkpoint
    in BertModel's layout written with ``torch.save`` to
    ``pytorch_model.bin``, beside ``config.json``, ``vocab.txt`` (bench's
    synthetic vocabulary) and ``1_Pooling/config.json`` (CLS), with no
    ``transformers``; loaded through ``EncoderEmbedder(model=dir)`` on the
    card. Held: the loaded tree equal to the written one (exact), the
    config, the tokenizer's vocabulary, and LOADER_DOCS documents' bf16
    embeddings (K1) against the same weights' plain float32 forward on the
    CPU (``attention_reference``) at row cosine >= 0.999."""
    import tempfile

    import torch

    from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig,
                                                  encode, init_params_host)
    from pathway_tpu_torch.models.hf_loader import load_checkpoint
    from pathway_tpu_torch.models.tokenizer import make_synthetic_vocab
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed + 7, cfg)
    vocab = make_synthetic_vocab([f"word{i}" for i in range(4096)],
                                 vocab_size=cfg.vocab_size)
    docs = make_docs(LOADER_DOCS, seed=seed + 8)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        torch.save(bert_state_dict(params, np.random.default_rng(seed)),
                   os.path.join(d, "pytorch_model.bin"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"model_type": "bert", "architectures": ["BertModel"],
                       "vocab_size": cfg.vocab_size,
                       "hidden_size": cfg.hidden,
                       "num_hidden_layers": cfg.layers,
                       "num_attention_heads": cfg.heads,
                       "intermediate_size": cfg.intermediate,
                       "max_position_embeddings": cfg.max_len,
                       "type_vocab_size": cfg.type_vocab_size,
                       "layer_norm_eps": cfg.layer_norm_eps,
                       "hidden_act": "gelu"}, f)
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write("\n".join(vocab) + "\n")
        os.makedirs(os.path.join(d, "1_Pooling"))
        with open(os.path.join(d, "1_Pooling", "config.json"), "w") as f:
            json.dump({"pooling_mode_cls_token": True,
                       "pooling_mode_mean_tokens": False}, f)
        size_mb = os.path.getsize(os.path.join(d, "pytorch_model.bin")) \
            / 2**20
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        emb = EncoderEmbedder(model=d, device="cuda")
        load_s = time.perf_counter() - t0
        loaded, lcfg, ltok = load_checkpoint(d)
    bad = [f"{name}[{i}]" if i is not None else name
           for name, i, a, b in _tree_pairs(loaded, params)
           if not np.array_equal(a, b)]
    if bad or lcfg != cfg or emb.config != cfg:
        fail(f"loader: the loaded checkpoint differs: tensors {bad[:5]}, "
             f"config {lcfg}")
    if emb.tokenizer.vocab_list != vocab or not emb.tokenizer.native:
        fail("loader: the tokenizer is not the checkpoint's vocabulary "
             "under the native WordPiece engine")
    ATTENTION.launches = 0
    got = emb.embed_batch(docs)
    launches = ATTENTION.launches
    ids, lens = emb.pack_tokens(docs)
    ref_model = Encoder.from_params(
        params, EncoderConfig.bge_small(compute_dtype=torch.float32),
        device="cpu")
    lens_t = torch.from_numpy(lens)
    mask = torch.arange(ids.shape[1])[None, :] < lens_t[:, None]
    want = encode(ref_model, torch.from_numpy(ids).long(), mask).numpy()
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                   * np.linalg.norm(want, axis=1))
    print(f"[loader] BGE-small checkpoint ({size_mb:.1f} MiB "
          f"pytorch_model.bin, BertModel keys, written in {write_s:.2f} s) "
          f"loaded by EncoderEmbedder(model=dir) in {load_s:.2f} s: tree and "
          f"config exact, {LOADER_DOCS} documents at width {ids.shape[1]}, "
          f"card (bf16, K1 launches {launches}) vs the CPU's float32 plain "
          f"forward: min row cosine {cos.min():.6f} [{card}]", flush=True)
    if launches != N_LAYERS or cos.min() < 0.999 or not np.isfinite(
            got).all():
        fail(f"loader: K1 launches {launches} (expected {N_LAYERS}), min "
             f"row cosine {cos.min():.6f} (expected >= 0.999)")


def _tree_pairs(a: dict, b: dict):
    """(name, layer or None, array of a, array of b) over two JAX-layout
    encoder trees."""
    for k in a["embeddings"]:
        yield f"embeddings/{k}", None, a["embeddings"][k], b["embeddings"][k]
    for i, (la, lb) in enumerate(zip(a["layers"], b["layers"])):
        for block in la:
            for k in la[block]:
                yield f"layers/{block}/{k}", i, la[block][k], lb[block][k]


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
# config 5's documents
ENGINE_DOCS = 50_000
# the engine and framework phases' documents: 48 ticks of 512 and 12 of
# 2048 (cut from --docs, 100,000, as configs 1, 3 and 5 joined the run, so
# that the script keeps inside its clock)
FRAMEWORK_DOCS = 24_576


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
    ``GraphRunner.run_batch``, over the first ``FRAMEWORK_DOCS`` of path
    1's documents (padded, bf16; 48 ticks of 512), then the ragged embedder over
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
                  window: int | None, before_run=None,
                  count_syncs: bool = False) -> dict:
    """bench.py's ``bench_embed_framework`` graph through the port:
    ``VectorStoreServer(docs, embedder=emb, index_builder=...
    default_brute_force_knn_document_index(chunks.text, chunks,
    embedder=emb, dimensions=384, reserved_space=n_docs + 64, dtype))``,
    ``retrieve_query`` captured, warmed through the built index
    (``framework_warm``), then ``GraphRunner.run_batch(n_workers=1)`` and
    the index's ``drain()`` timed as bench.py times them, with
    ``PATHWAY_DEVICE_INFLIGHT`` unset (``window`` None: the device bridge
    at its default window, 2) or set to ``window``; every launch count set
    to 0 just before the run and read just after, and ``before_run()``
    called just before it (after the warm-up); with ``count_syncs`` the
    run's implicit host syncs are counted (``device_sanitizer.
    count_syncs``, report mode for the run). Each operator's step is
    timed on the host clock by the thread it ran on (the calling thread's
    host leg, the bridge worker's device leg), the index's ``add_batch``
    and searches too; each search's queries and replies are kept for the
    checks."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.engine import device_sanitizer
    from pathway_tpu_torch.engine.device_bridge import \
        device_inflight_from_env
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
    from pathway_tpu_torch.internals import autojit
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
    autojit.reset_stats()
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
    # the warm-up's captures and replays are not the window's: captures are
    # the device sanitizer's count (every capture site reports to it)
    compiles = device_sanitizer.install_compile_counter()
    captures0 = compiles()
    replays0 = step.replays if step is not None else 0
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
        if before_run is not None:
            before_run()
        sync_count = device_sanitizer.count_syncs() if count_syncs \
            else contextlib.nullcontext()
        with GcClock() as gc_clock, sync_count as syncs:
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
            "captures": compiles() - captures0,
            "replays": (step.replays if step is not None else 0) - replays0,
            "inflight": inflight,
            "syncs": syncs.count if count_syncs else None,
            "bridge": runner._scheduler.bridge_stats(),
            "autojit": autojit.autojit_stats()}


def framework_direct(emb, dtype: str, texts: list[str], keys: list,
                     widths: list) -> dict:
    """The same documents through ``DeviceEmbeddingKnnIndex.add_batch``
    directly, in the engine's batches and with its keys, into a fresh
    index warmed as the engine's is (``framework_warm``, so both hand out
    the same slots); returns the index, the wall (s) and the graphs
    captured inside it."""
    import torch

    from pathway_tpu_torch.engine import device_sanitizer
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex)

    index = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
        emb.get_embedding_dimension(), reserved_space=len(texts) + 64,
        metric="cos", dtype=dtype, device="cuda"))
    framework_warm(index, emb, widths)
    compiles = device_sanitizer.install_compile_counter()
    captures0 = compiles()
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b0 in range(0, len(texts), FRAMEWORK_BATCH):
        index.add_batch(keys[b0:b0 + FRAMEWORK_BATCH],
                        texts[b0:b0 + FRAMEWORK_BATCH])
    index.drain()
    wall = time.perf_counter() - t0
    return {"index": index, "wall": wall, "captures": compiles() - captures0}


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
    runs bridged, direct, direct, bridged, then at window 1, then bridged
    once more with the live profiler on (``framework_profiled``), then the
    embedder's default HashTokenizer at window 1 beside its own direct
    index. Returns each kernel's launches in the counted (first bridged)
    runs, by LaunchCount, and in the profiled runs, by ("profiled",
    LaunchCount)."""
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
    profiled = {}
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
            # kernel once, then the key selection. framework_run's warm-up
            # then walks the padded widths, or every ragged chunk bucket
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

        def run(e, w, window, tag, count_syncs=False):
            return dict(framework_run(e, dtype, rows, qspec, w, window,
                                      count_syncs=count_syncs), tag=tag)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # bridged, direct, direct, bridged (host-clock times drift between
        # consecutive runs, so each side is timed twice in mirrored order),
        # then the same at window 1; the first bridged run is the counted
        # one, and the profiler-off run the profiled one is held against
        first = run(emb, widths, None, "bridged", count_syncs=True)
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
        profiled[ragged] = framework_profiled(
            emb, dtype, rows, qspec, widths, first, direct["index"], expect,
            ingest, query, docs, keys, seed, label, card)
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
              f"framework_bridge_queue_wait_ms {br['queue_wait_ms']}, "
              + ", ".join(f"framework_autojit_{k} {first['autojit'][k]}"
                          for k in ("enabled", "programs", "compiles",
                                    "demotions", "bucket_count"))
              + f" [{card}]", flush=True)
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
    for ragged, launches in profiled.items():
        for c, n in launches.items():
            key = (c, ragged) if c is ATTENTION else c
            counted[("profiled", key)] = counted.get(("profiled", key), 0) + n
    return counted


PROFILER_OVERHEAD = 0.02  # the sampler's contract (tests/profiling_canary.py)


def profiler_capture(prof, index, seed: int) -> dict:
    """``start_device_capture`` / ``stop_device_capture`` around two more
    ticks of ingest and a search on ``index``, run as one profiler leg on
    this thread (``begin_leg`` / ``end_leg``, flushed before the capture
    stops). Fails unless exactly one non-empty trace holding K1 was
    written (the directory is removed after), or if the trace's K1 kernel
    time exceeds what the profiler gave the forward family over the same
    leg: K1 is a part of every forward, so a bytes split that gives the
    forward less than its K1 is wrong. Returns the trace's bytes, the leg's
    CUDA-event ms, the trace's kernel-busy ms and K1 ms, and each family's
    ms of the leg."""
    import shutil
    import tempfile

    from pathway_tpu_torch.internals.keys import Pointer

    fam0 = prof.family_stats()
    leg0 = prof.leg_stats()["ms_total"]
    cap_dir = tempfile.mkdtemp(prefix="pathway-capture-")
    try:
        prof.start_device_capture(cap_dir)
        prof.begin_leg(-1)
        t0 = time.perf_counter()
        extra = make_docs(2 * FRAMEWORK_BATCH, seed=seed + 7)
        for b in range(2):
            part = extra[b * FRAMEWORK_BATCH:(b + 1) * FRAMEWORK_BATCH]
            index.add_batch([Pointer((1 << 61) + b * FRAMEWORK_BATCH + i)
                             for i in range(len(part))], part)
        index.search([(Pointer(1 << 60), extra[0], 3, None)])
        prof.end_leg((time.perf_counter() - t0) * 1e3)
        prof.flush()
        if prof.stop_device_capture() != cap_dir:
            fail("[profiler live] the capture wrote elsewhere")
        traces = [os.path.join(cap_dir, f) for f in os.listdir(cap_dir)]
        if len(traces) != 1:
            fail(f"[profiler live] the capture wrote {traces}")
        with open(traces[0]) as f:
            text = f.read()
    finally:
        shutil.rmtree(cap_dir, ignore_errors=True)
    kernels = [e for e in json.loads(text).get("traceEvents", [])
               if e.get("cat") == "kernel"]
    k1_ms = sum(e["dur"] for e in kernels
                if any(n in e["name"] for n in K1_BF16)) / 1e3
    fam1 = prof.family_stats()
    fam_ms = {f: s["attributed_device_ms_total"]
              - fam0.get(f, {}).get("attributed_device_ms_total", 0.0)
              for f, s in fam1.items()}
    got = {"bytes": len(text), "leg_ms": prof.leg_stats()["ms_total"] - leg0,
           "busy_ms": sum(e["dur"] for e in kernels) / 1e3, "k1_ms": k1_ms,
           "fam_ms": fam_ms}
    if not text or not k1_ms or k1_ms > fam_ms.get("encoder_forward", 0.0):
        fail(f"[profiler live] the capture's trace: {len(text)} B, "
             f"{len(kernels)} kernels, K1 {k1_ms:.3f} ms against the "
             f"forward family's {fam_ms.get('encoder_forward', 0.0):.3f} ms "
             f"of the leg")
    return got


def framework_profiled(emb, dtype: str, rows: list, qspec: list,
                       widths: list, first: dict, direct, expect: dict,
                       ingest: int, query: int, docs: list[str], keys: list,
                       seed: int, label: str, card: str) -> dict:
    """The configuration's graph once more, bridged at window 2, with
    ``PATHWAY_PROFILER=1``: ``Profiler.from_env()`` installed and sampling
    just before ``run_batch`` (after the warm-up). Held as every run of
    phase_framework is (``framework_holds``), its outputs equal to the
    counted run's (``first``, profiler off), and: each family's
    dispatches against the run's launches (K1 = 12 x the forward
    family's, K2 / K3 top-k + score = ``knn_search``'s, B's K4 =
    ``ingest_scatter``'s = graph replays; A's fused writes one a tick);
    every record re-timed inside a leg and every leg timed by CUDA events;
    the sampler's overhead below 0.02; 0 implicit host syncs with it on,
    as in the counted run. The families' ms summing to the legs' is an
    invariant of the split (its weights sum to 1), checked as one; the
    measured reading beside it is A's capture (``profiler_capture``): a
    ``start_device_capture`` / ``stop_device_capture`` over two ticks of
    ingest and a search. Returns the run's launches by LaunchCount."""
    from pathway_tpu_torch.engine import profiler as profiling
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   SCORE_BF16, SCORE_I8,
                                                   TOPK_BF16, TOPK_I8)

    tag = f"[profiler live {label[-1]}]"
    t_prof = time.perf_counter()
    family = "segment_attention" if emb.ragged else "encoder_forward"
    topk, score = (TOPK_I8, SCORE_I8) if emb.ragged else (TOPK_BF16,
                                                          SCORE_BF16)
    live = []

    def install():
        prof = profiling.Profiler.from_env()
        if prof is None or prof.device.type != "cuda":
            fail(f"{tag} PATHWAY_PROFILER=1 gave {prof}, not a profiler on "
                 f"the card")
        profiling.install_profiler(prof)
        prof.start()
        live.append(prof)

    saved = os.environ.get("PATHWAY_PROFILER")
    os.environ["PATHWAY_PROFILER"] = "1"
    try:
        on = framework_run(emb, dtype, rows, qspec, widths, None,
                           before_run=install, count_syncs=True)
        prof = live[0]
        prof.flush()
        st = prof.stats()
        overhead = prof.overhead_ratio()
        collapsed = prof.collapsed()
        # the outputs, before the capture adds rows to the index
        if repr(on["events"]) != repr(first["events"]):
            fail(f"{tag} the outputs differ with the profiler on")
        framework_holds(on, direct, expect, ingest, query, emb, docs, keys,
                        qspec, f"{label} profiler on")
        capture = None if emb.ragged else profiler_capture(
            prof, on["index"], seed)
        prof.stop()
    finally:
        profiling.install_profiler(None)
        os.environ.pop("PATHWAY_PROFILER", None)
        if saved is not None:
            os.environ["PATHWAY_PROFILER"] = saved
    fams = st["families"]
    launches = {c: n for c, n in on["launches"].items() if n}
    want = {family: on["dispatches"],
            "knn_search": launches.get(topk, 0) + launches.get(score, 0),
            "ingest_scatter": launches.get(QUANTIZE_SCATTER, 0)
            if emb.ragged else ingest}
    got = {f: s["dispatches"] for f, s in fams.items()}
    if got != want or launches.get(ATTENTION) != \
            N_LAYERS * got.get(family, -1):
        fail(f"{tag} family dispatches {got}, stated from the launches "
             f"{want} (K1 {launches.get(ATTENTION)} = 12 x the forward "
             f"family)")
    if emb.ragged and got["ingest_scatter"] != on["replays"]:
        fail(f"{tag} {got['ingest_scatter']} ingest records, "
             f"{on['replays']} graph replays")
    unattributed = {f: s["dispatches"] - s["attributed_dispatches"]
                    for f, s in fams.items()
                    if s["dispatches"] != s["attributed_dispatches"]}
    legs = st["legs"]
    fam_ms = sum(s["attributed_device_ms_total"] for s in fams.values())
    if unattributed or legs["pending"] or \
            legs["timed"] != legs["committed"] or not legs["committed"]:
        fail(f"{tag} records outside a timed leg {unattributed}; legs "
             f"{legs}")
    if abs(fam_ms - legs["ms_total"]) > 0.01 * legs["ms_total"]:
        fail(f"{tag} invariant: the families' {fam_ms:.3f} ms differ from "
             f"the legs' CUDA-event {legs['ms_total']:.3f} ms by > 1%")
    if not st["host"]["samples_total"] or overhead >= PROFILER_OVERHEAD:
        fail(f"{tag} sampler: {st['host']['samples_total']} samples, "
             f"overhead ratio {overhead:.5f} (contract < "
             f"{PROFILER_OVERHEAD})")
    if on["syncs"] or first["syncs"]:
        fail(f"{tag} implicit host syncs in the run: profiler on "
             f"{on['syncs']}, off {first['syncs']}")
    n_docs, n_ticks = len(rows), -(-len(rows) // FRAMEWORK_BATCH)
    fam_line = "; ".join(
        f"{f} {s['dispatches']} dispatches ({s['attributed_dispatches']} "
        f"re-timed), {s['attributed_device_ms_total']:.3f} ms, "
        f"{s['flops_total']:.4g} FLOP, {s['bytes_total']:.4g} B, MFU "
        f"{s['mfu']:.4f}, HBM use {s['hbm_bw_util']:.4f}, "
        f"{s['roofline']['bound_by']}-bound (AI "
        f"{s['roofline']['arithmetic_intensity']:.1f})"
        for f, s in sorted(fams.items()))
    print(f"{tag} {n_docs} docs in {n_ticks} ticks, bridge at window "
          f"{on['inflight']} ({on['bridge']['legs_resolved']} legs): "
          f"{fam_line} [{card}]", flush=True)
    print(f"{tag} legs timed by CUDA events {legs['timed']} of "
          f"{legs['committed']} with records, {legs['ms_total']:.3f} ms; "
          f"invariant: the families' sum {fam_ms:.3f} ms (ratio "
          f"{fam_ms / legs['ms_total']:.6f}); rolling MFU "
          f"{st['mfu_rolling']:.6f}, HBM use {st['hbm_bw_util']:.6f}; "
          f"sampler {st['host']['samples_total']} samples every "
          f"{st['host']['sample_interval_ms']} ms, "
          f"{st['host']['device_attributed_samples']} in a device leg, "
          f"overhead ratio {overhead:.6f}, "
          f"{st['host']['distinct_stacks']} stacks, top frame "
          f"{st['host']['top_frame']!r}; implicit syncs on {on['syncs']}, "
          f"off {first['syncs']} [{card}]", flush=True)
    roles = sorted({ln.split(";", 1)[0] for ln in collapsed.splitlines()})
    print(f"{tag} docs/s with the profiler on {n_docs / on['wall']:.1f}, "
          f"off (the counted run) {n_docs / first['wall']:.1f}; sampled "
          f"thread roles {roles}", flush=True)
    if capture is not None:
        print(f"{tag} capture over 2 ingest ticks and a search, one leg of "
              f"{capture['leg_ms']:.3f} ms by CUDA events: a "
              f"{capture['bytes']} B Chrome trace; its kernels busy "
              f"{capture['busy_ms']:.3f} ms (busy share "
              f"{capture['busy_ms'] / capture['leg_ms']:.4f}), K1 "
              f"{capture['k1_ms']:.3f} ms; the profiler's split of the "
              f"leg: " + ", ".join(f"{f} {ms:.3f} ms" for f, ms in
                                   sorted(capture["fam_ms"].items()))
              + f" (K1 <= the forward's, required) [{card}]", flush=True)
    print(f"{tag} the profiled run and its checks "
          f"{time.perf_counter() - t_prof:.1f} s", flush=True)
    return launches


SHARDED_TICKS = 8       # phase_framework_sharded: 8 ticks of 2048 docs
SHARDED_WORKERS = 4
# two bf16 steps at 1.0: per-worker query batches are other shapes, so a
# query's embedding, and its bf16 scores, may move by a rounding step
SHARDED_SCORE_TOL = 2.0 ** -7


def framework_sharded_run(emb, rows: list, qspec: list, widths: list,
                          n_workers: int) -> dict:
    """bench_embed_framework's graph A (``VectorStoreServer(...).
    retrieve_query`` over the padded embedder's bf16 cos index) under
    ``run_batch(n_workers)``, warmed through the built index first; the
    device bridge at its default window (it runs at one worker only).
    Records each query's reply from the inner index, the index's
    ``add_batch`` calls, each kernel's launches and the encoder's
    dispatches inside the run, the peak device memory and the wall of
    ``run_batch`` + ``drain()``."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.stdlib.indexing import \
        default_brute_force_knn_document_index
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    G.clear()
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
            reserved_space=n_docs + 64, dtype="bfloat16"))
    runner = GraphRunner()
    cap = runner.capture(store.retrieve_query(queries))
    node = next(n for n in runner.graph.nodes
                if isinstance(n.op, ExternalIndexOperator))
    index = node.op.index
    framework_warm(index, emb, widths)
    replies: dict[int, tuple] = {}
    searches: list[int] = []  # each inner search's largest limit
    adds: list[int] = []
    inner_search, add_batch = index.inner.search, index.add_batch

    def search(batch):
        out = inner_search(batch)
        searches.append(max(int(q[2]) for q in batch))
        for q, reply in zip(batch, out):
            replies[int(q[0])] = tuple(reply)
        return out

    def add(keys, *args, **kwargs):
        adds.append(len(keys))
        return add_batch(keys, *args, **kwargs)

    index.inner.search, index.add_batch = search, add
    saved = os.environ.pop("PATHWAY_DEVICE_INFLIGHT", None)
    try:
        gc.collect()
        for count in LAUNCH_COUNTS:
            count.launches = 0
        emb.dispatches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner.run_batch(n_workers=n_workers)
        index.drain()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        if saved is not None:
            os.environ["PATHWAY_DEVICE_INFLIGHT"] = saved
        G.clear()
    return {"events": cap.events, "replies": replies, "searches": searches,
            "adds": adds, "wall": wall, "peak": peak, "index": index,
            "dispatches": emb.dispatches,
            "launches": {c: c.launches for c in LAUNCH_COUNTS},
            "replicas": runner._scheduler._replicas[node.id],
            "n_workers": runner._scheduler.n_workers}


def phase_framework_sharded(n_docs: int, seed: int, card: str) -> dict:
    """bench_embed_framework's graph A (the padded BGE-small embedder with
    bench's WordPiece into a bf16 cos index: K1, K2, K2's score twin) at
    ``n_workers=4`` and at 1, 8 ticks of 2048 documents (``--docs`` cut to
    8 ticks), in the order 1, 4, 4, 1. Holds: the replicas of the index
    operator share the one index and its embedder, only replica 0 adds
    rows (8 ``add_batch`` calls of 2048, as at one worker), at least 2
    replicas answer queries, the index's live keys equal between the runs,
    each query's top k equal to the one-worker run's where the scores at a
    rank differ by more than SHARDED_SCORE_TOL (the scores at every rank
    within it), the launches as the code gives them (K1 = 12 x encoder
    dispatches = 12 x (ingest ticks + inner searches), K2 = the searches
    whose limits are all <= 64, K2 score the others), and the 4-worker
    peak device memory below the one-worker run's plus the model's
    parameter bytes, the least of each pair of runs (one extra copy of the
    model would reach the bound, three would pass it by twice).
    Prints docs/s at both counts on the host clock (a finding, not a
    claim), the launches and the peak memory. Returns K1's and K2's
    launches in the 4-worker run."""
    import torch

    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.keys import hash_values_uncached
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn_kernels import SCORE_BF16, TOPK_BF16
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    label = "framework sharded"
    n_docs = min(n_docs, SHARDED_TICKS * FRAMEWORK_BATCH)
    n_ticks = -(-n_docs // FRAMEWORK_BATCH)
    if n_ticks < 3:
        fail(f"{label}: needs 3 ticks of {FRAMEWORK_BATCH} docs")
    cfg = EncoderConfig.bge_small()
    emb = EncoderEmbedder(config=cfg, params=init_params_host(seed, cfg),
                          tokenizer=framework_tokenizer(BENCH_SEQ),
                          max_len=BENCH_SEQ, max_batch_size=FRAMEWORK_BATCH,
                          device="cuda")
    docs = make_docs(n_docs, seed=seed)
    metas = [Json({"path": f"/d{i}.txt"}) for i in range(n_docs)]
    rows = [(doc, metas[i], 2 * (i // FRAMEWORK_BATCH), 1)
            for i, doc in enumerate(docs)]
    qspec = framework_queries(docs, n_ticks, seed)
    ticks = [docs[b:b + FRAMEWORK_BATCH]
             for b in range(0, n_docs, FRAMEWORK_BATCH)]
    widths = sorted({emb.pack_tokens(t)[0].shape[1] for t in ticks})
    for w in emb.bucket_widths():
        emb.device_producer(emb.model,
                            np.zeros((FRAMEWORK_BATCH, w), np.int16),
                            np.full(FRAMEWORK_BATCH, w, np.int32))
    model_bytes = sum(p.numel() * p.element_size()
                      for p in emb.model.parameters())
    runs = []
    for n in (1, SHARDED_WORKERS, SHARDED_WORKERS, 1):
        gc.collect()
        torch.cuda.empty_cache()
        runs.append(framework_sharded_run(emb, rows, qspec, widths, n))
    one, four = runs[0], runs[1]
    reps = four["replicas"]
    if four["n_workers"] != SHARDED_WORKERS or len(reps) != SHARDED_WORKERS:
        fail(f"{label}: {len(reps)} index replicas at "
             f"{four['n_workers']} workers")
    if not all(r.index is reps[0].index and r.index.embedder is emb
               for r in reps):
        fail(f"{label}: the replicas do not share the index and embedder")
    if not reps[0]._is_primary or any(r._is_primary for r in reps[1:]):
        fail(f"{label}: a replica other than 0 maintains the index")
    answering = sum(1 for r in reps if r.answers)
    if answering < 2:
        fail(f"{label}: {answering} replica(s) answered queries")
    for run in runs:
        if run["adds"] != [len(t) for t in ticks]:
            fail(f"{label}: add_batch calls {run['adds']} at "
                 f"{run['n_workers']} workers, not one a tick")
        if len(run["events"]) != len(qspec) or len(run["replies"]) \
                != len(qspec):
            fail(f"{label}: {len(run['replies'])} replies for "
                 f"{len(qspec)} queries at {run['n_workers']} workers")
        searches = run["searches"]
        want = {ATTENTION: N_LAYERS * run["dispatches"],
                TOPK_BF16: sum(1 for k in searches if k <= 64),
                SCORE_BF16: sum(1 for k in searches if k > 64)}
        got = {c: run["launches"].get(c, 0) for c in want}
        if got != want or run["dispatches"] != n_ticks + len(searches):
            fail(f"{label}: launches at {run['n_workers']} workers "
                 f"{ {c.name: v for c, v in got.items()} }, the code gives "
                 f"{ {c.name: v for c, v in want.items()} } "
                 f"({run['dispatches']} dispatches, {len(searches)} "
                 "searches)")
    if any(set(r["index"].inner._key_to_slot)
           != set(one["index"].inner._key_to_slot) for r in runs):
        fail(f"{label}: the index's live keys differ between 1 and "
             f"{SHARDED_WORKERS} workers")
    qkeys = [int(hash_values_uncached("row", qi, text, k, None, None))
             for qi, (_, text, k, _) in enumerate(qspec)]
    exact = swaps = 0
    gap = 0.0
    for run in runs[1:]:
        for qk in qkeys:
            a, b = run["replies"].get(qk), one["replies"].get(qk)
            if a is None or b is None or len(a) != len(b):
                fail(f"{label}: query {qk} answered differently")
            exact += a == b
            for (ka, sa), (kb, sb) in zip(a, b):
                gap = max(gap, abs(float(sa) - float(sb)))
                swaps += ka != kb
    if gap > SHARDED_SCORE_TOL:
        fail(f"{label}: a rank's score moved by {gap:.3e} between 1 and "
             f"{SHARDED_WORKERS} workers (tolerance {SHARDED_SCORE_TOL})")
    # the least peak of each pair: allocator noise only ever adds, and a
    # copied model would be in every sharded run
    peak1 = min(r["peak"] for r in runs if r["n_workers"] == 1)
    peak4 = min(r["peak"] for r in runs if r["n_workers"] > 1)
    margin = peak1 + model_bytes - peak4
    if margin <= 0:
        fail(f"{label}: peak device memory {peak4 / 2**20:.1f} MiB "
             f"at {SHARDED_WORKERS} workers against {peak1 / 2**20:.1f} MiB"
             f" at 1 (the model is {model_bytes / 2**20:.1f} MiB)")
    for run in runs:
        run["launched"] = ", ".join(
            f"{c.name} {v}" for c, v in run["launches"].items() if v)
    print(f"[{label}] graph A ({n_docs} docs in {n_ticks} ticks of "
          f"{FRAMEWORK_BATCH}, {len(qspec)} queries, bf16 cos index, bench's "
          f"WordPiece), docs/s in the order 1, {SHARDED_WORKERS}, "
          f"{SHARDED_WORKERS}, 1 workers (1: bridged, window 2; "
          f"{SHARDED_WORKERS}: bulk-synchronous): " + " / ".join(
              f"{n_docs / r['wall']:.1f}" for r in runs)
          + f" (host clock, run_batch + drain(); a finding, not a claim); "
          f"peak device memory " + " / ".join(
              f"{r['peak'] / 2**20:.1f}" for r in runs)
          + f" MiB (model {model_bytes / 2**20:.1f} MiB) [{card}]",
          flush=True)
    print(f"[{label}] launches inside run_batch: 1 worker {one['launched']} "
          f"({one['dispatches']} encoder dispatches, {len(one['searches'])} "
          f"inner searches); {SHARDED_WORKERS} workers {four['launched']} "
          f"({four['dispatches']} dispatches, {len(four['searches'])} "
          f"searches, one a worker and query tick) [{card}]", flush=True)
    print(f"[{label}] holds: {SHARDED_WORKERS} index replicas share one "
          f"index and the embedder, only replica 0 adds ({len(four['adds'])}"
          f" add_batch calls of {FRAMEWORK_BATCH}), {answering} replicas "
          f"answer queries, the index's live keys equal "
          f"({len(one['index'].inner._key_to_slot)}), every reply of the "
          f"later runs within {SHARDED_SCORE_TOL} of the first one-worker "
          f"run's rank by rank (largest gap {gap:.3e}; {exact} of "
          f"{3 * len(qkeys)} replies identical, {swaps} near-tie key "
          f"swaps), launches as the code gives them in every run, the "
          f"least {SHARDED_WORKERS}-worker peak {peak4 / 2**20:.1f} MiB "
          f"under the least one-worker peak {peak1 / 2**20:.1f} MiB plus "
          f"the model by {margin / 2**20:.1f} MiB", flush=True)
    out = {"k1": four["launches"].get(ATTENTION, 0),
           "k2": four["launches"].get(TOPK_BF16, 0)}
    for run in runs:
        del run["index"], run["replicas"]
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    return out


C5_PARTITIONS = 4       # the document topic's partitions
C5_QUERIES = 256        # query texts, once the index holds every document
C5_PRODUCE_BATCH = 500  # documents a produce call (one record batch)
C5_COMMIT_MS = 20       # both readers' autocommit_duration_ms
C5_QUERY_GAP_S = 0.01   # between two query produces
C5_TIE_TOL = 2.0 ** -6  # an answer's top-1 against the exact search


class LogBroker:
    """A one-node Kafka broker on 127.0.0.1, built on the port's wire codecs
    (``pathway_tpu_torch/io/kafka/_protocol.py``), as
    tests/test_kafka_native.py builds the JAX package's: Metadata,
    ListOffsets, Fetch and Produce. Like a real broker it keeps each
    partition's record batches as they were produced (the base offset
    rewritten; the CRC does not cover it) and serves a fetch the stored
    batches from the one holding its offset, up to the partition's max
    bytes, without decoding them. ``close()`` closes the listening socket
    and every connection, which ends the threads serving them."""

    def __init__(self, topics: dict[str, int]):
        import socket
        import threading

        from pathway_tpu_torch.io.kafka import _protocol as kp

        self.kp = kp
        self.lock = threading.Lock()
        # topic -> partition -> [(base offset, record count, batch bytes)]
        self.logs = {t: [[] for _ in range(n)] for t, n in topics.items()}
        self.conns: list = []
        self.server = socket.create_server(("127.0.0.1", 0))
        self.port = self.server.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True,
                         name="smoke-broker").start()

    def end(self, topic: str, pid: int) -> int:
        log = self.logs[topic][pid]
        return log[-1][0] + log[-1][1] if log else 0

    def _accept(self) -> None:
        import threading

        while True:
            try:
                conn, _ = self.server.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="smoke-broker-conn").start()

    def _serve(self, conn) -> None:
        kp = self.kp
        try:
            while True:
                (length,) = struct.unpack(">i", self._read_exact(conn, 4))
                r = kp.Reader(self._read_exact(conn, length))
                api_key, _version, corr = r.int16(), r.int16(), r.int32()
                r.string()  # client id
                body = self._dispatch(api_key, r)
                resp = kp.enc_int32(corr) + body
                conn.sendall(kp.enc_int32(len(resp)) + resp)
        except (ConnectionError, OSError):
            return

    @staticmethod
    def _read_exact(conn, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    def _dispatch(self, api_key: int, r) -> bytes:
        kp = self.kp
        if api_key == kp.API_METADATA:
            wanted = [r.string() for _ in range(r.int32())]
            out = (kp.enc_int32(1) + kp.enc_int32(0)
                   + kp.enc_string("127.0.0.1") + kp.enc_int32(self.port)
                   + kp.enc_string(None) + kp.enc_int32(0)
                   + kp.enc_int32(len(wanted)))
            for t in wanted:
                logs = self.logs.get(t) or []
                out += (kp.enc_int16(0 if t in self.logs else 3)
                        + kp.enc_string(t) + kp.enc_int8(0)
                        + kp.enc_int32(len(logs)))
                for pid in range(len(logs)):
                    out += (kp.enc_int16(0) + kp.enc_int32(pid)
                            + kp.enc_int32(0) + kp.enc_int32(0)
                            + kp.enc_int32(0))
            return out
        if api_key == kp.API_LIST_OFFSETS:
            r.int32(), r.int32()  # replica, topics (one)
            topic = r.string()
            r.int32()  # partitions (one)
            pid, ts = r.int32(), r.int64()
            with self.lock:
                offset = 0 if ts == -2 else self.end(topic, pid)
            return (kp.enc_int32(1) + kp.enc_string(topic) + kp.enc_int32(1)
                    + kp.enc_int32(pid) + kp.enc_int16(0) + kp.enc_int64(-1)
                    + kp.enc_int64(offset))
        if api_key == kp.API_FETCH:
            r.int32(), r.int32(), r.int32(), r.int32(), r.int8(), r.int32()
            topic = r.string()
            wanted = [(r.int32(), r.int64(), r.int32())
                      for _ in range(r.int32())]
            out = (kp.enc_int32(0) + kp.enc_int32(1) + kp.enc_string(topic)
                   + kp.enc_int32(len(wanted)))
            for pid, offset, max_bytes in wanted:
                with self.lock:
                    log = list(self.logs[topic][pid])
                    end = self.end(topic, pid)
                blobs, size = [], 0
                for base, count, blob in log:
                    if base + count <= offset:
                        continue
                    if blobs and size + len(blob) > max_bytes:
                        break
                    blobs.append(blob)
                    size += len(blob)
                out += (kp.enc_int32(pid) + kp.enc_int16(0)
                        + kp.enc_int64(end) + kp.enc_int64(end)
                        + kp.enc_int32(0) + kp.enc_bytes(b"".join(blobs)))
            return out
        if api_key == kp.API_PRODUCE:
            r.string(), r.int16(), r.int32(), r.int32()
            topic = r.string()
            r.int32()  # partitions (one)
            pid = r.int32()
            batch = r.bytes_()
            # RecordBatch v2: lastOffsetDelta at byte 23 of the batch
            count = struct.unpack(">i", batch[23:27])[0] + 1
            with self.lock:
                base = self.end(topic, pid)
                self.logs[topic][pid].append(
                    (base, count, kp.enc_int64(base) + batch[8:]))
            return (kp.enc_int32(1) + kp.enc_string(topic) + kp.enc_int32(1)
                    + kp.enc_int32(pid) + kp.enc_int16(0)
                    + kp.enc_int64(base) + kp.enc_int64(-1))
        raise ValueError(f"the broker does not speak api {api_key}")

    def close(self) -> None:
        self.server.close()
        for conn in self.conns:
            try:
                conn.close()
            except OSError:
                pass


# -- auto-jit: bench.py's autojit leg (bench.py:2053-2302) -------------------
AUTOJIT_DOCS = 16 * 2048  # bench.py's AUTOJIT_DOCS
AUTOJIT_TICK = 2048       # bench.py's AUTOJIT_TICK
AUTOJIT_DIMS = (4096, 768, 1536, 1280)  # vocabulary, embedding, h1, h2
AUTOJIT_TRIALS = 3        # bench.py's best of 3, the modes interleaved
AUTOJIT_LADDER = 9        # pw.warmup's buckets 8, 16, ..., 2048


def autojit_line(label: str, reset: bool = False) -> None:
    """Print the auto-jit tier's counters for the phase just run (and zero
    them for the next when ``reset``): a graph that newly fuses a program
    shows here, and a fused map rides the device leg."""
    from pathway_tpu_torch.internals import autojit

    stats = autojit.autojit_stats()
    print(f"[{label}] auto-jit (on: {stats['enabled']}): programs "
          f"{stats['programs']} {stats['live_programs']}, compiles "
          f"{stats['compiles']}, demotions {stats['demotions']}, device "
          f"dispatches {stats['device_dispatches']}, vector dispatches "
          f"{stats['vector_dispatches']}, fallback batches "
          f"{stats['fallback_batches']}", flush=True)
    if reset:
        autojit.reset_stats()


def autojit_payload(dev):
    """bench.py's ``_autojit_payload`` (bench.py:2061-2083) on the card:
    ``embed(ids int32[n]) -> float64[n]`` = the row norm of ``tanh(emb[ids]
    @ w1) @ w2`` over bench's f32 parameters from ``default_rng(12)``, in
    float32 (no TF32), the result fetched as bench fetches it."""
    import torch

    from pathway_tpu_torch._device import upload
    from pathway_tpu_torch.engine import device_sanitizer

    vocab, e, h1, h2 = AUTOJIT_DIMS
    rng = np.random.default_rng(12)
    params = tuple(
        torch.from_numpy((np.asarray(rng.standard_normal(s), np.float32)
                          / np.sqrt(s[0])).astype(np.float32)).to(dev)
        for s in ((vocab, e), (e, h1), (h1, h2)))

    def embed(ids: np.ndarray) -> np.ndarray:
        emb, w1, w2 = params
        x = upload(torch.from_numpy(np.ascontiguousarray(ids, np.int32)),
                   dev).long()
        o = torch.tanh(emb[x] @ w1) @ w2
        out = torch.sqrt((o * o).sum(dim=1))
        with device_sanitizer.explicit_sync("autojit embed result"):
            return out.cpu().numpy().astype(np.float64)

    return embed


def autojit_rows(n_docs: int) -> list:
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 1_000_000, size=n_docs)
    ys = rng.random(size=n_docs)
    return [(int(x), float(y), i // AUTOJIT_TICK, 1)
            for i, (x, y) in enumerate(zip(xs, ys))]


def phase_autojit(card: str, n_docs: int = AUTOJIT_DOCS) -> dict:
    """bench.py's ``bench_autojit`` in the port: the same doc-scoring
    pipeline as (a) raw kernels + a hand-written loop, (b) the Table path
    with the auto-jit tier on, (c) with it off. Six sync scalar UDFs fuse
    into one program (boost and gate on the card as one CUDA graph replay
    a tick, mix, norm, damp and step on numpy), the host-only ``tag`` is
    split out onto the host thread, and a batch device UDF (bench's embed
    payload, torch on the card) rides the bridge. Each framework run builds
    its graph, runs ``pw.warmup`` (the tier's bucket ladder) and primes
    the payload, then times ``run_batch`` under a flight recorder. The
    three modes run interleaved, best of AUTOJIT_TRIALS (bench's 3).
    Checks: the three outputs byte-identical (bench.py:2276-2281); the
    tier on the ``torch`` backend on the card, zero demotions, one device
    dispatch a tick; the warm-up captured the ladder (9 graphs) and the
    timed runs captured none and made no implicit host sync; no hand-written
    kernel launched. Prints bench.py's keys under their names, the device
    partition's CUDA-event ms a tick beside the numpy partition's host ms,
    and the phase's seconds."""
    import math

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch._device import resolve_device
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.engine import device_sanitizer
    from pathway_tpu_torch.engine.flight_recorder import FlightRecorder
    from pathway_tpu_torch.internals import autojit
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    label = "autojit"
    t_phase = time.perf_counter()
    n_docs -= n_docs % AUTOJIT_TICK
    n_ticks = n_docs // AUTOJIT_TICK
    vocab = AUTOJIT_DIMS[0]
    embed_kernel = autojit_payload(resolve_device("cuda"))

    @pw.udf
    def boost(x: int) -> int:
        return x * 3 + 7

    @pw.udf
    def gate(y: float) -> float:
        return y if y < 0.75 else 0.75

    @pw.udf
    def mix(x: int, y: float) -> float:
        return x * 0.0001 + y * 0.5

    @pw.udf
    def norm(y: float) -> float:
        return math.sqrt(y) + 1.0

    @pw.udf
    def damp(y: float) -> float:
        return y * 0.5 + 0.25

    @pw.udf
    def step(x: int) -> int:
        return (x % 7) + (x // 3)

    @pw.udf(deterministic=True)
    def tag(x: int) -> str:
        return f"doc-{x % 97}"

    @pw.udf(batch=True, device=True, deterministic=True, return_type=float)
    def embed(xs):
        ids = np.asarray(xs, np.int64) % vocab
        return embed_kernel(ids.astype(np.int32)).tolist()

    rows = autojit_rows(n_docs)
    schema = pw.schema_from_types(x=int, y=float)
    captures = device_sanitizer.install_compile_counter()

    def run_framework() -> dict:
        G.clear()
        gc.collect()  # earlier trials' programs leave the registry
        autojit.reset_stats()
        t = table_from_rows(schema, rows, is_stream=True)
        t1 = t.select(sb=boost(t.x), sg=gate(t.y), sm=mix(t.x, t.y),
                      sn=norm(t.y), sd=damp(t.y), st=step(t.x),
                      tg=tag(t.x))
        t2 = t1.select(emb=embed(t1.sb), tg=t1.tg, sg=t1.sg, sm=t1.sm,
                       sn=t1.sn, sd=t1.sd, st=t1.st)
        runner = GraphRunner()
        cap = runner.capture(t2)
        progs = [p for n in runner.graph.nodes
                 for p in (getattr(getattr(n.op, "fn", None), "autojit",
                                   None) or ())]
        c0 = captures()
        warm = pw.warmup(cache=False)
        embed_kernel(np.zeros(AUTOJIT_TICK, np.int32))
        torch.cuda.synchronize()
        warm_captures = captures() - c0
        rec = FlightRecorder()
        rec.enabled = True
        for count in LAUNCH_COUNTS:
            count.launches = 0
        c1 = captures()
        with device_sanitizer.count_syncs() as syncs, GcClock() as gc_clock:
            t0 = time.perf_counter()
            runner.run_batch(n_workers=1, recorder=rec)
            dt = time.perf_counter() - t0
        stages = [
            {"op": s["name"], "op_class": s["op_class"],
             "ms": round(s["sum_ms"], 1), "steps": s["count"],
             "rows_in": s["rows_in"]}
            for s in sorted(rec.op_stats(), key=lambda s: -s["sum_ms"])]
        out = {
            "dt": dt, "rows": [r for _, r, _, d in cap.events if d > 0],
            "gc": (gc_clock.s, gc_clock.n),
            "bridge": runner._scheduler.bridge_stats(),
            "stats": autojit.autojit_stats(), "stages": stages,
            "warm_entries": sum(1 for kind, _ in warm["compiled"]
                                if kind == "autojit"),
            "warm_captures": warm_captures,
            "run_captures": captures() - c1, "syncs": syncs.count,
            "launches": sum(c.launches for c in LAUNCH_COUNTS),
            "programs": [(p.backend, p.device, p.label, len(p.graphs),
                          p.device_ms, p.numpy_ms, p._device_part,
                          p._np_part, p.verify_ms) for p in progs],
            "lowering": [(n.name.split(":")[0], type(n.op).__name__,
                          bool(getattr(n.op, "device_bound", False)))
                         for n in runner.graph.nodes],
        }
        G.clear()
        return out

    def run_raw() -> tuple[float, list]:
        t0 = time.perf_counter()
        out = []
        for tk in range(n_ticks):
            lo = tk * AUTOJIT_TICK
            chunk = rows[lo:lo + AUTOJIT_TICK]
            xa = np.fromiter((r[0] for r in chunk), np.int64, len(chunk))
            ya = np.fromiter((r[1] for r in chunk), np.float64, len(chunk))
            sb = xa * 3 + 7
            sg = np.minimum(ya, 0.75)
            sm = xa * 0.0001 + ya * 0.5
            sn = np.sqrt(ya) + 1.0
            sd = ya * 0.5 + 0.25
            st = (xa % 7) + (xa // 3)
            tg = [f"doc-{int(v) % 97}" for v in xa.tolist()]
            emb = embed_kernel((sb % vocab).astype(np.int32))
            out.extend(zip(emb.tolist(), tg, sg.tolist(), sm.tolist(),
                           sn.tolist(), sd.tolist(), st.tolist()))
        return time.perf_counter() - t0, out

    prev = os.environ.get("PATHWAY_AUTO_JIT")
    on_runs, off_runs, raw_runs = [], [], []
    try:
        embed_kernel(np.zeros(AUTOJIT_TICK, np.int32))
        for _ in range(AUTOJIT_TRIALS):
            raw_runs.append(run_raw())
            os.environ["PATHWAY_AUTO_JIT"] = "1"
            on_runs.append(run_framework())
            os.environ["PATHWAY_AUTO_JIT"] = "0"
            off_runs.append(run_framework())
    finally:
        os.environ.pop("PATHWAY_AUTO_JIT", None)
        if prev is not None:
            os.environ["PATHWAY_AUTO_JIT"] = prev
    # the same tier-on run with every operator on the calling thread
    # (window 1): the bridged run's device leg shares the interpreter lock
    # with the host thread, and this is the run without that
    os.environ["PATHWAY_AUTO_JIT"] = "1"
    os.environ["PATHWAY_DEVICE_INFLIGHT"] = "1"
    try:
        serial = run_framework()
    finally:
        os.environ.pop("PATHWAY_DEVICE_INFLIGHT", None)
        os.environ.pop("PATHWAY_AUTO_JIT", None)
        if prev is not None:
            os.environ["PATHWAY_AUTO_JIT"] = prev
    raw_dt, raw_out = min(raw_runs, key=lambda r: r[0])
    on = min(on_runs, key=lambda r: r["dt"])
    off = min(off_runs, key=lambda r: r["dt"])
    # byte-identity across all three paths (bench.py:2276-2281; sorted:
    # the source's consolidation may reorder within a tick)
    for r in on_runs + off_runs:
        if sorted(r["rows"]) != sorted(off_runs[0]["rows"]):
            fail(f"{label}: auto-jit changed the framework output")
    if sorted(serial["rows"]) != sorted(raw_out):
        fail(f"{label}: the window-1 run's output diverged")
    if sorted(on["rows"]) != sorted(raw_out):
        fail(f"{label}: the framework output diverged from the raw "
             "comparator")
    if len(raw_out) != n_docs:
        fail(f"{label}: {len(raw_out)} raw rows, not {n_docs}")
    for r in on_runs:
        st = r["stats"]
        backends = {(b, str(d)) for b, d, *_ in r["programs"]}
        if st["programs"] != 1 or len(r["programs"]) != 1 \
                or backends != {("torch", str(resolve_device("cuda")))}:
            fail(f"{label}: expected one fused program on the torch "
                 f"backend on the card, got {r['programs']} ({st})")
        if st["demotions"] or st["device_dispatches"] != n_ticks \
                or st["vector_dispatches"] != n_ticks \
                or st["fallback_batches"]:
            fail(f"{label}: tier counters {st}, expected 0 demotions and "
                 f"{n_ticks} device and vector dispatches")
        if r["warm_entries"] != AUTOJIT_LADDER \
                or r["warm_captures"] != AUTOJIT_LADDER \
                or r["programs"][0][3] != AUTOJIT_LADDER:
            fail(f"{label}: warm-up walked {r['warm_entries']} buckets and "
                 f"captured {r['warm_captures']} graphs, expected "
                 f"{AUTOJIT_LADDER} (8 .. 2048)")
        if ("map_dev", "MapOperator", True) not in r["lowering"]:
            fail(f"{label}: no device-bound map_dev node: {r['lowering']}")
    for r in on_runs + off_runs:
        if r["run_captures"] or r["syncs"]:
            fail(f"{label}: {r['run_captures']} graphs captured and "
                 f"{r['syncs']} implicit host syncs in a timed run_batch")
        if r["launches"]:
            fail(f"{label}: {r['launches']} hand-written kernel launches")
    for r in off_runs:
        if r["stats"]["programs"] or r["warm_entries"]:
            fail(f"{label}: the tier built programs with it off")
    (backend, device, plabel, n_graphs, dev_ms, np_ms, dpart, npart,
     verify_ms) = on["programs"][0]
    st = on["stats"]
    br = on["bridge"]
    keys = {
        "autojit_n_docs": n_docs,
        "autojit_raw_docs_per_s": round(n_docs / raw_dt, 1),
        "autojit_framework_docs_per_s": round(n_docs / on["dt"], 1),
        "autojit_framework_docs_per_s_nojit": round(n_docs / off["dt"], 1),
        "framework_vs_raw_ratio": round(raw_dt / on["dt"], 3),
        "framework_vs_raw_ratio_nojit": round(raw_dt / off["dt"], 3),
        "autojit_programs": st["programs"],
        "autojit_compiles": st["compiles"],
        "autojit_demotions": st["demotions"],
        "autojit_bucket_count": st["bucket_count"],
        "autojit_device_dispatches": st["device_dispatches"],
        "autojit_vector_dispatches": st["vector_dispatches"],
        "autojit_fallback_batches": st["fallback_batches"],
        "autojit_warmup_compiles": on["warm_entries"],
        "autojit_bridge_overlap_ratio": round(br["overlap_ratio"], 3)
        if br else None,
    }
    print(f"[{label}] bench.py's keys ({n_docs} docs in {n_ticks} ticks of "
          f"{AUTOJIT_TICK}; raw, tier on, tier off interleaved, best of "
          f"{AUTOJIT_TRIALS}): {json.dumps(keys)} [{card}]", flush=True)
    print(f"[{label}] unrounded: raw {raw_dt:.6f} s, on {on['dt']:.6f} s, "
          f"off {off['dt']:.6f} s a run; every trial (raw / on / off s): "
          + ", ".join(f"{r[0]:.4f} / {a['dt']:.4f} / {b['dt']:.4f}"
                      for r, a, b in zip(raw_runs, on_runs, off_runs))
          + f"; garbage collector in the best on / off run "
          f"{on['gc'][0]:.3f} s ({on['gc'][1]} collections) / "
          f"{off['gc'][0]:.3f} s ({off['gc'][1]}) [{card}]", flush=True)
    print(f"[{label}] the tier: program {plabel}, backend {backend} on "
          f"{device}; device partition trees {dpart}, numpy partition trees "
          f"{npart}; warm-up walked {on['warm_entries']} buckets and "
          f"captured {on['warm_captures']} CUDA graphs (ladder "
          f"{AUTOJIT_LADDER}), {n_graphs} held; in the timed runs: "
          f"{on['run_captures']} captures, {on['syncs']} implicit host "
          f"syncs; device partition {dev_ms / n_ticks:.4f} ms a tick "
          f"(CUDA events, graph replay), numpy partition "
          f"{np_ms / n_ticks:.4f} ms a tick (host); the first tick's "
          f"verification against the interpreter {verify_ms:.3f} ms "
          f"[{card}]", flush=True)
    print(f"[{label}] autojit_stage_breakdown (ms over the run, top 8): on "
          f"{json.dumps(on['stages'][:8])}; off "
          f"{json.dumps(off['stages'][:8])}", flush=True)
    print(f"[{label}] lowering (on): {on['lowering']}", flush=True)

    def tick_ms(r, op):
        return sum(x["ms"] for x in r["stages"]
                   if x["op"].split(":")[0] == op) / n_ticks

    print(f"[{label}] tier on at window 1 (no bridge, one run): "
          f"{n_docs / serial['dt']:.1f} docs/s, framework_vs_raw_ratio "
          f"{raw_dt / serial['dt']:.3f}; ms a tick by node, bridged best "
          f"run / window 1: map_dev {tick_ms(on, 'map_dev'):.3f} / "
          f"{tick_ms(serial, 'map_dev'):.3f}, map_host "
          f"{tick_ms(on, 'map_host'):.3f} / {tick_ms(serial, 'map_host'):.3f}"
          f", device partition {dev_ms / n_ticks:.4f} / "
          f"{serial['programs'][0][4] / n_ticks:.4f} [{card}]", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[{label}] holds: raw == on == off byte for byte (sorted rows, "
          f"{n_docs}); one program on torch/cuda, 0 demotions, {n_ticks} "
          f"device dispatches; ladder captured in warm-up, 0 captures and 0 "
          f"implicit syncs timed; no hand-written kernel; phase {secs:.1f} s "
          f"[{card}]", flush=True)
    autojit.reset_stats()
    return keys


def phase_config5(seed: int, card: str) -> dict:
    """BASELINE.md config 5 (BASELINE.md:30, "multi-worker distributed KNN
    over Kafka stream"): ``ENGINE_DOCS`` ``make_docs`` documents produced
    as JSON ``{"doc_id", "doc"}`` to a 4-partition topic of a
    ``LogBroker`` on 127.0.0.1, in record batches of C5_PRODUCE_BATCH,
    before ``pw.run`` starts (the producer encodes in Python under the
    same GIL as the workers, so it stays off the clock), then read by
    ``pw.io.kafka.read(format="json")`` under ``pw.run`` at
    PATHWAY_THREADS=4; bench's framework embedder (padded
    BGE-small, bench's WordPiece; K1 in every forward) as the DataIndex's
    UDF into ``default_brute_force_knn_document_index(..., mesh="auto",
    dtype="bfloat16", metric cos)`` inside ``use_mesh`` of 4 shards on
    cuda:0 (the port's sharded index: K2 on every shard a search). Once
    the index holds every document, C5_QUERIES texts (half copies of
    documents, half fresh) are produced one at a time to a second topic
    and answered ``query_as_of_now`` (k=10), recorded by
    ``pw.io.subscribe``. Holds: the built index is the sharded one over 4
    shards; it holds each document once (its keys are the document
    table's, each doc_id once); every query answered, with the keys its
    search returned; each answer's top-1 equals an exact float32 search of
    the query's embedding (the one the engine passed to the index) over
    the index's own host mirror, or scores within C5_TIE_TOL of the exact
    best (a near-tie, counted: bf16 rows and queries); K1 = 12 x encoder
    dispatches and K2 = searches x 4 shards x extents, both non-zero, no
    other kernel. Prints docs/s from the readers' first fetched record to
    the last document indexed (and the producer's seconds apart), answer
    p50 / p99 (produce to subscribe), peak device
    memory and seconds. Returns each kernel's launches, by LaunchCount."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.io.kafka._protocol import KafkaClient
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn_kernels import TOPK_BF16
    from pathway_tpu_torch.parallel import (MeshConfig, ShardedKnnIndex,
                                            make_mesh, use_mesh)
    from pathway_tpu_torch.stdlib.indexing import (
        default_brute_force_knn_document_index, nearest_neighbors)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    label = "config 5"
    clock = time.perf_counter
    t_phase = clock()
    n_docs = ENGINE_DOCS
    docs = make_docs(n_docs, seed=seed + 50)
    copies = np.random.default_rng(seed + 51).choice(
        n_docs, C5_QUERIES // 2, replace=False).tolist()
    queries = [docs[i] for i in copies] + make_docs(
        C5_QUERIES - len(copies), seed=seed + 52)
    cfg = EncoderConfig.bge_small()
    emb = EncoderEmbedder(config=cfg, params=init_params_host(seed, cfg),
                          tokenizer=framework_tokenizer(BENCH_SEQ),
                          max_len=BENCH_SEQ, max_batch_size=FRAMEWORK_BATCH,
                          device="cuda")
    for w in emb.bucket_widths():  # cuBLAS and the allocator warm
        emb.device_producer(emb.model,
                            np.zeros((FRAMEWORK_BATCH, w), np.int16),
                            np.full(FRAMEWORK_BATCH, w, np.int32))
    mesh = make_mesh(MeshConfig(data=SHARDED_WORKERS),
                     devices=[torch.device("cuda")] * SHARDED_WORKERS)
    broker = LogBroker({"docs": C5_PARTITIONS, "queries": 1})
    settings = {"bootstrap.servers": f"127.0.0.1:{broker.port}"}
    built, searches, doc_keys = [], [], {}
    answers: dict[int, tuple] = {}
    lock = threading.Lock()
    build = nearest_neighbors.BruteForceKnnFactory.build
    fetch_many, first_fetch = KafkaClient.fetch_many, []

    def tapped_build(factory):
        index = build(factory)
        search = index.search

        def tapped_search(batch):
            replies = search(batch)
            searches.append((batch, replies))
            return replies

        index.search = tapped_search
        built.append(index)
        return index

    def tapped_fetch(client, topic, offsets, *args, **kwargs):
        got = fetch_many(client, topic, offsets, *args, **kwargs)
        if topic == "docs" and any(got.values()):
            first_fetch.append(clock())
        return got

    def on_doc(key, row, time, is_addition):
        with lock:
            doc_keys[int(key)] = row["doc_id"]

    def on_answer(key, row, time, is_addition):
        if is_addition:
            with lock:
                answers[row["query_id"]] = (clock(), int(key), row["ids"])

    saved = os.environ.get("PATHWAY_THREADS")
    os.environ["PATHWAY_THREADS"] = str(SHARDED_WORKERS)
    nearest_neighbors.BruteForceKnnFactory.build = tapped_build
    G.clear()
    served = None
    try:
        with use_mesh(mesh):
            table = pw.io.kafka.read(
                settings, topic="docs", format="json",
                schema=pw.schema_from_types(doc_id=int, doc=str),
                autocommit_duration_ms=C5_COMMIT_MS)
            qs = pw.io.kafka.read(
                settings, topic="queries", format="json",
                schema=pw.schema_from_types(query_id=int, query=str),
                autocommit_duration_ms=C5_COMMIT_MS)
            index = default_brute_force_knn_document_index(
                table.doc, table, embedder=emb, dimensions=384,
                reserved_space=n_docs + 1024, mesh="auto",
                dtype="bfloat16")
            res = index.query_as_of_now(qs.query, number_of_matches=10)
            pw.io.subscribe(table, on_doc)
            pw.io.subscribe(res.select(query_id=qs.restrict(res).query_id,
                                       ids=res._pw_index_reply_id),
                            on_answer)
            producer = KafkaClient(settings["bootstrap.servers"])
            t_produce = clock()
            for b in range(0, n_docs, C5_PRODUCE_BATCH):
                producer.produce("docs", (b // C5_PRODUCE_BATCH)
                                 % C5_PARTITIONS, [
                    (None, json.dumps({"doc_id": i, "doc": docs[i]}).encode())
                    for i in range(b, min(b + C5_PRODUCE_BATCH, n_docs))])
            produce_s = clock() - t_produce
            KafkaClient.fetch_many = tapped_fetch
            gc.collect()
            for count in LAUNCH_COUNTS:
                count.launches = 0
            emb.dispatches = 0
            torch.cuda.reset_peak_memory_stats()
            t_run = clock()
            served = Served(label, pw.run)
            wait_for(lambda: built and len(built[0]) == n_docs,
                     "every document indexed", served)
            t_indexed = clock()
            sent = {}
            for qi, text in enumerate(queries):
                producer.produce("queries", 0, [(None, json.dumps(
                    {"query_id": qi, "query": text}).encode())])
                sent[qi] = time.perf_counter()
                time.sleep(C5_QUERY_GAP_S)
            wait_for(lambda: len(answers) == len(queries), "every answer",
                     served)
            producer.close()
            launches = {c: c.launches for c in LAUNCH_COUNTS if c.launches}
            dispatches = emb.dispatches
            peak = torch.cuda.max_memory_allocated()
            served.stop()
            served = None
    finally:
        nearest_neighbors.BruteForceKnnFactory.build = build
        KafkaClient.fetch_many = fetch_many
        if served is not None:
            served.stop()
        broker.close()
        os.environ.pop("PATHWAY_THREADS", None)
        if saved is not None:
            os.environ["PATHWAY_THREADS"] = saved
    idx = built[0]
    if not isinstance(idx, ShardedKnnIndex) or idx.n_shards != \
            SHARDED_WORKERS or len(built) != 1:
        fail(f"{label}: mesh='auto' built {[type(b).__name__ for b in built]}"
             f", not one sharded index over {SHARDED_WORKERS} shards")
    index_keys = sorted(int(k) for k in idx._key_to_slot)
    if index_keys != sorted(doc_keys) or len(idx) != n_docs or sorted(
            doc_keys.values()) != list(range(n_docs)) or \
            int(idx._host_valid.sum()) != n_docs:
        fail(f"{label}: the index holds {len(idx)} rows for {len(doc_keys)} "
             f"documents: not each document once")
    # every answer is the reply of the search that carried its query
    replies = {}
    for batch, reps in searches:
        for (qkey, qvec, limit, _), rep in zip(batch, reps):
            replies[int(qkey)] = (np.asarray(qvec, np.float32), rep)
    if len(replies) != len(queries):
        fail(f"{label}: {len(replies)} queries searched, not "
             f"{len(queries)}")
    # exact float32 cos over the index's host mirror
    live = np.flatnonzero(idx._host_valid)
    mirror = idx._host_vectors[live]
    mirror = mirror / (np.linalg.norm(mirror, axis=1, keepdims=True) + 1e-12)
    slot_key = np.array([int(idx._slot_to_key[int(s)]) for s in live])
    near_ties = found = 0
    for qi in range(len(queries)):
        _, qkey, ids = answers[qi]
        ids = tuple(int(k) for k in ids)
        qv, rep = replies.get(qkey, (None, ()))
        if ids != tuple(int(k) for k, _ in rep) or len(ids) != 10:
            fail(f"{label}: query {qi}'s answer is not its search's reply")
        scores = mirror @ (qv / (np.linalg.norm(qv) + 1e-12))
        best = int(np.argmax(scores))
        got = int(np.flatnonzero(slot_key == ids[0])[0])
        if slot_key[best] != ids[0]:
            if scores[best] - scores[got] > C5_TIE_TOL:
                fail(f"{label}: query {qi}'s top-1 scores "
                     f"{scores[got]:.5f} exactly, the best "
                     f"{scores[best]:.5f}")
            near_ties += 1
        if qi < len(copies) and doc_keys[ids[0]] == copies[qi]:
            found += 1
    n_ext = len(idx._extents)
    want = {ATTENTION: N_LAYERS * dispatches,
            TOPK_BF16: len(searches) * SHARDED_WORKERS * n_ext}
    got = {c: launches.get(c, 0) for c in want}
    others = {c.name: v for c, v in launches.items() if c not in want}
    if got != want or others or not all(got.values()):
        fail(f"{label}: launches {({c.name: v for c, v in got.items()})}, "
             f"the code gives {({c.name: v for c, v in want.items()})}; "
             f"others {others}")
    lat = [(answers[qi][0] - sent[qi]) * 1e3 for qi in range(len(queries))]
    t_first = min(first_fetch)
    docs_per_s = n_docs / (t_indexed - t_first)
    print(f"[{label}] {n_docs} documents on a {C5_PARTITIONS}-partition "
          f"Kafka topic (LogBroker on 127.0.0.1, batches of "
          f"{C5_PRODUCE_BATCH}, produced before pw.run in {produce_s:.2f} s)"
          f", pw.io.kafka.read at PATHWAY_THREADS={SHARDED_WORKERS}, "
          f"BGE-small into mesh='auto' over {SHARDED_WORKERS} shards on "
          f"cuda:0 (bf16 cos): {docs_per_s:.1f} docs/s from the readers' "
          f"first fetched record to the last document indexed "
          f"({t_indexed - t_first:.2f} s; {t_indexed - t_run:.2f} s from "
          f"pw.run's start) [{card}]", flush=True)
    print(f"[{label}] {len(queries)} queries (k=10), one produce each "
          f"{C5_QUERY_GAP_S * 1e3:.0f} ms apart: answer p50 "
          f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f}"
          f" ms (produce to subscribe); peak device memory "
          f"{peak / 2**20:.1f} MiB; launches K1 {got[ATTENTION]} (12 x "
          f"{dispatches} encoder dispatches), K2 {got[TOPK_BF16]} "
          f"({len(searches)} searches x {SHARDED_WORKERS} shards x {n_ext} "
          f"extent(s)); {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    print(f"[{label}] holds: one sharded index over {SHARDED_WORKERS} "
          f"shards holding each of the {n_docs} documents once; every "
          f"answer its search's reply; top-1 against an exact f32 search "
          f"of the host mirror: {len(queries) - near_ties} identical, "
          f"{near_ties} near-ties within {C5_TIE_TOL}; {found} of "
          f"{len(copies)} copies find their document first", flush=True)
    del emb, idx, built, searches
    gc.collect()
    torch.cuda.empty_cache()
    return got


SERVING_N = 100_000     # bench.py's SERVING_N: graph A's vectors, B's docs
SERVING_B_DOCS = 25_000  # graph B's documents in the script (cut: clock)
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
    launches and no graph captured in the timed window; prints the index's
    result cache counters (the cache is on by default). Returns the run's
    launches by LaunchCount."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
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
        caches = [n.op.index.result_cache for n in rt.runner.graph.nodes
                  if isinstance(n.op, ExternalIndexOperator)]
    finally:
        served.stop()
    launches = {c: c.launches for c in LAUNCH_COUNTS}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    if len(caches) != 1 or caches[0] is None:
        fail(f"{label}: the index carries no result cache (on by default)")
    cache_stats = caches[0].stats()
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
    print(f"[{label}] result cache (on, the default) beside knn_p50_e2e_ms "
          f"{keys['knn_p50_e2e_ms']}: " + json.dumps(cache_stats)
          + f" [{card}]", flush=True)
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
    from pathway_tpu_torch.engine.operators import JoinOperator
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
        # statistics and inputs go through join_left(stats, id=queries.id),
        # as in the JAX package: two left joins keyed by the query (and
        # retrieve's ix), no statistics ix
        joins = sorted((n.name, n.op.mode, n.op._bilinear)
                       for n in rt.runner.graph.nodes
                       if isinstance(n.op, JoinOperator))
        if joins != [("ix", "inner", False), ("join:left", "left", False),
                     ("join:left", "left", False)]:
            fail(f"{label}: the served graph's joins are {joins}, not "
                 "retrieve's ix and the two join_left of statistics and "
                 "inputs")
        # before the first document: the left join's row without a match
        empty = (post_json(base + "/v1/statistics", {})[0],
                 post_json(base + "/v1/inputs", ask_none)[0])
        if empty != ({"file_count": None, "last_modified": None}, []):
            fail(f"{label}: statistics and inputs before the first "
                 f"document: {empty}")
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
          f"and /v1/inputs through join_left (graph joins: {joins}), "
          f"before the first document {empty}, then file_count "
          f"{stats['file_count']} = documents pushed and "
          f"{len(inputs)} inputs; VectorStoreClient's reply = the "
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


RAG_FILES = 5_000        # BASELINE.md config 3's corpus, one text file each
                         # (cut from 10,000 for the script's clock)
RAG_TEXTS_PER_FILE = 6   # make_docs texts a file: 540 words
RAG_FILE_BATCH = 1000    # files written at once (each batch one backlog tick)
RAG_MAX_TOKENS = 120     # TokenCountSplitter(max_tokens=120): 5 chunks a file
RAG_QUESTIONS = 64       # aimed in turn at 2, 4, 8 documents and never
RAG_NEW_FILES = 500      # written while the server runs
RAG_NEW_QUESTIONS = 16   # whose marker only a new file holds
RAG_RETRIEVES = 4
# the filtered retrieves: the first ten files by path glob, the next ten
# by a jmespath-lite metadata filter
RAG_FILTERS = (("filepath_globpattern", "**/f0000?.txt"),
               ("metadata_filter", "contains(path, '/f0001')"))
RAG_BASE_WORDS = 60      # a question: 60 words of one chunk + a marker
RAG_RERANK_K = 4
# EncoderReranker's cosines through K1 against the plain attention in
# all 12 layers, bf16: the row cosine of the two embeddings is >= 0.999
# (the earlier phases' bound), and at that bound two unit vectors differ
# by up to 0.045; 2^-7 asks far less
RERANK_TOL = 2.0 ** -7


def rag_texts(n_files: int, first: int, seed: int) -> list[str]:
    """``n_files`` file texts of ``RAG_TEXTS_PER_FILE`` make_docs texts
    each, a marker word ``ж<file>x<chunk>`` before every 119 words, so
    that each of the splitter's 120-token chunks starts with its own
    marker. Bench's WordPiece reads every marker as [UNK]: which marker a
    text holds does not move its embedding."""
    texts = make_docs(n_files * RAG_TEXTS_PER_FILE, seed=seed)
    k, step = RAG_TEXTS_PER_FILE, RAG_MAX_TOKENS - 1
    out = []
    for f in range(n_files):
        words = " ".join(texts[f * k:(f + 1) * k]).split()
        parts = []
        for c, w0 in enumerate(range(0, len(words), step)):
            parts.append(f"ж{first + f}x{c}")
            parts.extend(words[w0:w0 + step])
        out.append(" ".join(parts))
    return out


def write_files(docs_dir: str, stage: str, texts: list[str], first: int
                ) -> None:
    """Each text to ``docs_dir/f<first + i>.txt``, written in ``stage``
    and renamed in, so the reader never sees half a file."""
    for i, text in enumerate(texts):
        name = f"f{first + i:05d}.txt"
        tmp = os.path.join(stage, name)
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, os.path.join(docs_dir, name))


def prompt_parts(prompt: str) -> tuple[list[str], str]:
    """The documents and the question of a ``prompt_qa_geometric_rag``
    prompt."""
    import re

    m = re.search(r"Documents:\n(.*)\n\nQuestion: (.*)\nAnswer:$", prompt,
                  re.S)
    if m is None:
        raise ValueError("not a geometric RAG prompt")
    body, question = m.groups()
    return re.split(r"(?:^|\n\n)\[doc \d+\]\n", body)[1:], question


def marker_answer(docs: list[str], question: str) -> str:
    """The offline chat's rule: the question's marker is its word holding
    ``ж``; the answer names the first document holding that word, else it
    is ``NO_INFO_ANSWER``."""
    from pathway_tpu_torch.xpacks.llm.prompts import NO_INFO_ANSWER

    marker = next(w for w in question.split() if "ж" in w)
    for i, doc in enumerate(docs):
        if f" {marker} " in f" {doc} ":
            return f"{marker}: document {i + 1} of {len(docs)}"
    return NO_INFO_ANSWER


def plain_geometric(docs: list[str], question: str, n0: int, factor: int,
                    iterations: int) -> tuple[str, list[int]]:
    """``answer_with_geometric_rag_strategy`` on the host over ``docs``
    with ``marker_answer`` as the chat: (answer, documents a call)."""
    from pathway_tpu_torch.xpacks.llm.prompts import NO_INFO_ANSWER

    calls, n = [], n0
    for _ in range(iterations):
        ctx = docs[:n]
        calls.append(len(ctx))
        answer = marker_answer(ctx, question)
        if answer != NO_INFO_ANSWER:
            return answer, calls
        if n >= len(docs):
            break
        n *= factor
    return NO_INFO_ANSWER, calls


def post_text(url: str, payload, timeout: float = 120.0):
    """One POST whose reply is text (a route answering a string): (text,
    client ms)."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode("utf-8")
    return body, (time.perf_counter() - t0) * 1e3


def plain_embed(emb, texts: list[str]):
    """The plain encoder (``attention_reference`` in every layer, padded)
    over ``texts`` on the embedder's device: (B, hidden) float64 on the
    host."""
    import torch

    from pathway_tpu_torch.models.encoder import encode
    from pathway_tpu_torch.ops.attention import attention_reference

    out = []
    for b in range(0, len(texts), 256):
        ids, lens = emb.pack_tokens(texts[b:b + 256])
        ids_d = torch.from_numpy(ids).to(emb.device).long()
        lens_d = torch.from_numpy(lens).to(emb.device)
        mask = torch.arange(ids_d.shape[1], device=emb.device)[None, :] \
            < lens_d[:, None]
        out.append(encode(emb.model, ids_d, mask,
                          attn_fn=attention_reference).float().cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def bf16_scan(vecs, slab, valid):
    """``score_float_reference`` of the queries ``vecs`` (B, D) as the
    bf16 cos index takes them (unit rows, bf16) over the index's rows."""
    import torch

    from pathway_tpu_torch.ops.knn_kernels import score_float_reference

    q = torch.from_numpy(np.asarray(vecs, np.float32)).to(slab.device)
    q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    return score_float_reference(q.to(torch.bfloat16).float(), slab, valid,
                                 "cos")


def marker_chat():
    """A deterministic offline chat in the manner of the JAX package's
    tests' ``FakeChat`` (tests/test_llm_xpack.py:37): ``marker_answer``
    over the prompt's documents; every call's document count recorded by
    question."""
    import threading

    from pathway_tpu_torch.xpacks.llm import llms

    class Chat(llms.BaseChat):
        def __init__(self):
            super().__init__()
            self.calls: dict = {}
            self._lock = threading.Lock()

        async def __wrapped__(self, messages, **kwargs):
            prompt = self._as_messages(messages)[-1]["content"]
            docs, question = prompt_parts(prompt)
            with self._lock:
                self.calls.setdefault(question, []).append(len(docs))
            return marker_answer(docs, question)

    return Chat()


def tap_index(index) -> dict:
    """Records what an engine index (a ``DeviceEmbeddingKnnIndex``) is
    fed and asked: ``added`` (key -> text), ``adds`` (rows and host
    seconds of each ``add_batch``) and ``searches`` ((batch, replies) of
    its inner index, whose batch holds the query vectors)."""
    rec = {"inner": index.inner, "added": {}, "searches": [], "adds": []}
    add_batch, search = index.add_batch, index.inner.search

    def tapped_add(keys, texts, filter_data=None):
        for k, t in zip(keys, texts):
            rec["added"][int(k)] = str(t)
        t0 = time.perf_counter()
        out = add_batch(keys, texts, filter_data)
        rec["adds"].append((len(keys), time.perf_counter() - t0))
        return out

    def tapped_search(batch):
        replies = search(batch)
        rec["searches"].append((batch, replies))
        return replies

    index.add_batch = tapped_add
    index.inner.search = tapped_search
    return rec


def index_rows(inner) -> tuple:
    """(key of each slot or -1, the slab's rows, their valid flags) over
    an index's established extents (the slab's one)."""
    import torch

    exts = [e for e in inner._extents() if e.established]
    slots = np.concatenate([e.base + np.arange(e.rows) for e in exts])
    keys_of = np.array([int(inner._slot_to_key.get(int(s), -1))
                        for s in slots])
    return (keys_of, torch.cat([e.vectors for e in exts]),
            torch.cat([e.valid for e in exts]))


def phase_adaptive_rag(seed: int, card: str) -> dict:
    """BASELINE.md config 3, the Adaptive-RAG template, at BGE-small's
    full width through the port's normal entry points: ``RAG_FILES`` text
    files (``RAG_TEXTS_PER_FILE`` make_docs texts each) written into a
    directory in batches of ``RAG_FILE_BATCH`` while ``pw.io.fs.read(dir,
    format="plaintext_by_file", mode="streaming", with_metadata=True)``
    reads it; ``VectorStoreServer`` with ``TokenCountSplitter(max_tokens=
    120)``, bench's ``EncoderEmbedder`` (padded, max_len 128, bench's
    WordPiece) and a bf16 cos ``default_brute_force_knn_document_index``;
    ``AdaptiveRAGQuestionAnswerer(n_starting_documents=2, factor=2,
    max_iterations=3)`` with an offline chat (``marker_chat``: it answers
    when a document of its prompt holds the question's marker, its last
    three words) behind ``run_server(threaded=True)`` on a free port.

    Every chunk starts with its own marker word (``rag_texts``), which
    bench's WordPiece reads as [UNK]. A question is 60 words of a chunk
    and the marker of that chunk's 2nd-ranked neighbour, its 3rd or 4th,
    its 5th to 8th, or of a random chunk (ranked by the plain encoder and
    a plain scan), so that the plain path answers some at 2 documents,
    some at 4, some at 8 and some never. ``RAG_QUESTIONS`` ``POST
    /v1/pw_ai_answer``; then ``RAG_NEW_FILES`` files written while the
    server runs, and ``RAG_NEW_QUESTIONS`` (a new file's first chunk,
    whose marker no other chunk holds), asked once a tick has passed. Each answer and its chat
    calls are held against the plain path: the engine's query embedding
    against the plain encoder (row cosine >= 0.999), the engine's 8
    documents against a plain scan of the index's own rows (keys in rank
    order up to 1e-6 score ties), and the geometric strategy on the host
    over those documents (the same answer, the same documents in each
    call). Also ``/v1/retrieve`` (k=8, against the plain scan),
    ``/v1/statistics`` (file_count = files written) and ``RAGClient``
    against the raw POSTs; then ``EncoderReranker(emb)`` over the
    retrieved (document, question) pairs and ``rerank_topk_filter`` under
    ``run_batch``, the scores against the plain encoder and a numpy
    cosine (``RERANK_TOL``). Prints answer latency, chunks indexed a
    second, chat calls a question, K1 and K2 launches, peak memory and
    the phase's seconds; returns the launches by LaunchCount."""
    import shutil
    import tempfile

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
    from pathway_tpu_torch.internals.jmespath_lite import evaluate_filter
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params_host
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn_kernels import TOPK_BF16
    from pathway_tpu_torch.stdlib.indexing import \
        default_brute_force_knn_document_index
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder
    from pathway_tpu_torch.xpacks.llm.prompts import NO_INFO_ANSWER
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        AdaptiveRAGQuestionAnswerer, RAGClient)
    from pathway_tpu_torch.xpacks.llm.rerankers import (EncoderReranker,
                                                       rerank_topk_filter)
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    label = "adaptive rag"
    t_phase = time.perf_counter()
    n0, factor, iters = 2, 2, 3
    top_n = n0 * factor ** (iters - 1)
    cfg = EncoderConfig.bge_small()
    emb = EncoderEmbedder(
        config=cfg, params=init_params_host(seed, cfg),
        tokenizer=framework_tokenizer(BENCH_SEQ), max_len=BENCH_SEQ,
        max_batch_size=FRAMEWORK_BATCH, device="cuda")
    splitter = TokenCountSplitter(max_tokens=RAG_MAX_TOKENS)
    files = rag_texts(RAG_FILES, 0, seed + 31)
    new_files = rag_texts(RAG_NEW_FILES, RAG_FILES, seed + 32)
    file_chunks = [splitter.chunk(t) for t in files + new_files]
    if any(c.split()[0] != f"ж{f}x{i}"
           for f, fc in enumerate(file_chunks) for i, (c, _) in enumerate(fc)):
        fail(f"{label}: a chunk of the splitter does not start with its "
             "marker")
    n_chunks = sum(len(c) for c in file_chunks[:RAG_FILES])
    n_new_chunks = sum(len(c) for c in file_chunks[RAG_FILES:])
    root = tempfile.mkdtemp(prefix="smoke_rag_")
    docs_dir, stage = os.path.join(root, "docs"), os.path.join(root, "stage")
    os.makedirs(docs_dir)
    os.makedirs(stage)

    G.clear()
    docs = pw.io.fs.read(docs_dir, format="plaintext_by_file",
                         mode="streaming", with_metadata=True)
    store = VectorStoreServer(
        docs, embedder=emb, splitter=splitter,
        index_builder=lambda chunks: default_brute_force_knn_document_index(
            chunks.text, chunks, embedder=emb,
            dimensions=emb.get_embedding_dimension(),
            reserved_space=n_chunks + n_new_chunks + 64, dtype="bfloat16",
            metadata_column=chunks.metadata))
    chat = marker_chat()
    rag = AdaptiveRAGQuestionAnswerer(chat, store, n_starting_documents=n0,
                                      factor=factor, max_iterations=iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = Served(label, lambda: rag.run_server(
        host="127.0.0.1", port=0, threaded=True, with_cache=False))
    ask_none = {"metadata_filter": None, "filepath_globpattern": None}
    try:
        wait_for(lambda: rag.server is not None, "run_server", served)
        rt = served.runtime(rag.server.webserver)
        base = f"http://127.0.0.1:{rag.server.webserver.port}"
        # one index a query route, as in the JAX package: the answers'
        # and /v1/retrieve's, each fed every chunk
        taps = [tap_index(n.op.index) for n in rt.runner.graph.nodes
                if isinstance(n.op, ExternalIndexOperator)]
        if len(taps) != 2:
            fail(f"{label}: {len(taps)} engine indexes, not the answer "
                 "route's and the retrieve route's")
        inners = [t["inner"] for t in taps]
        for count in LAUNCH_COUNTS:
            count.launches = 0
        t_go = time.perf_counter()
        before = {st["id"]: (st["count"], st["sum_ms"])
                  for st in rt.recorder.op_stats()}
        tick0 = rt._last_completed_tick
        batch_s = []
        for b in range(0, RAG_FILES, RAG_FILE_BATCH):
            write_files(docs_dir, stage, files[b:b + RAG_FILE_BATCH], b)
            want = sum(len(c) for c in file_chunks[:b + RAG_FILE_BATCH])
            wait_for(lambda: min(len(x._key_to_slot) for x in inners)
                     >= want, f"{want} chunks in both indexes", served,
                     timeout=300)
            batch_s.append(time.perf_counter() - t_go - sum(batch_s))
        ingest_s = time.perf_counter() - t_go
        ingest_where = window_attribution(rt.recorder, before, tick0)
        want_chunks = sorted(c for fc in file_chunks[:RAG_FILES]
                             for c, _ in fc)
        for t in taps:
            if len(t["inner"]._key_to_slot) != n_chunks or \
                    sorted(t["added"].values()) != want_chunks:
                fail(f"{label}: an index holds {len(t['added'])} texts, not "
                     f"the {n_chunks} chunks of {RAG_FILES} files")
        added = taps[0]["added"]

        # the questions, aimed by the plain path (plain encoder, plain
        # scan): every marker is [UNK] to the tokenizer, so a question's
        # neighbours do not depend on which marker it ends with
        keys_of, slab, valid = index_rows(inners[0])
        old_keys = set(added)
        col_text = [added.get(int(k), "") for k in keys_of]
        rng = np.random.default_rng(seed + 33)
        live = np.flatnonzero(valid.cpu().numpy())
        picks = rng.choice(live, RAG_QUESTIONS, replace=False)
        bases = [" ".join(col_text[c].split()[1:RAG_BASE_WORDS + 1])
                 for c in picks]
        near = torch.topk(bf16_scan(plain_embed(
            emb, [f"{b} ж" for b in bases]), slab, valid), 12,
            dim=1).indices.cpu().numpy()
        aims = [(1,), (2, 3), (4, 5, 6, 7), None]
        questions = []
        for qi, c in enumerate(picks):
            aim = aims[qi % 4]
            if aim is None:
                target = int(rng.choice(live))
                while target in near[qi]:
                    target = int(rng.choice(live))
            else:
                target = int(near[qi][aim[(qi // 4) % len(aim)]])
            questions.append(f"{bases[qi]} {col_text[target].split()[0]}")
        answers, answer_ms = [], []
        s0 = [len(t["searches"]) for t in taps]
        for q in questions:
            text, ms = post_text(base + "/v1/pw_ai_answer", {"prompt": q})
            answers.append(text)
            answer_ms.append(ms)
        ans_tap = max(range(2), key=lambda i: len(taps[i]["searches"])
                      - s0[i])
        searches = taps[ans_tap]["searches"]
        ret_searches = taps[1 - ans_tap]["searches"]
        asked = searches[s0[ans_tap]:]
        # incremental re-index: new files while the server runs
        t_new = time.perf_counter()
        write_files(docs_dir, stage, new_files, RAG_FILES)
        wait_for(lambda: min(len(x._key_to_slot) for x in inners)
                 >= n_chunks + n_new_chunks,
                 "the new files' chunks in both indexes", served,
                 timeout=300)
        new_s = time.perf_counter() - t_new
        tick = rt._last_completed_tick
        wait_for(lambda: rt.scheduler.bridge_stats()["resolved_watermark"]
                 > tick, "a tick after the new files", served)
        # a new file's first chunk, word for word: its marker is in no
        # other chunk
        new_questions = [
            file_chunks[RAG_FILES + f][0][0] for f in range(
                0, RAG_NEW_FILES, RAG_NEW_FILES // RAG_NEW_QUESTIONS)
        ][:RAG_NEW_QUESTIONS]
        s1 = len(searches)
        new_answers = [post_text(base + "/v1/pw_ai_answer",
                                 {"prompt": q})[0] for q in new_questions]
        new_asked = searches[s1:]
        calls = {q: list(chat.calls.get(q, [])) for q in
                 questions + new_questions}
        # retrieve, statistics and the client against the raw POSTs
        s2 = len(ret_searches)
        retrieved = [post_json(base + "/v1/retrieve", {
            "query": q, "k": top_n, **ask_none})[0]
            for q in questions[:RAG_RETRIEVES]]
        retrieve_searches = ret_searches[s2:]
        # string filters: a path glob and a jmespath-lite metadata filter
        s3 = len(ret_searches)
        filtered = [post_json(base + "/v1/retrieve", {
            "query": questions[RAG_RETRIEVES + i], "k": top_n,
            **ask_none, field: value})[0]
            for i, (field, value) in enumerate(RAG_FILTERS)]
        filtered_searches = ret_searches[s3:]
        stats = post_json(base + "/v1/statistics", {})[0]
        client = RAGClient(url=base, timeout=120)
        via_client = (client.retrieve(questions[0], k=top_n),
                      client.statistics(), client.answer(questions[0]))
        raw = (post_json(base + "/v1/retrieve", {
            "query": questions[0], "k": top_n, **ask_none})[0],
            post_json(base + "/v1/statistics", {})[0],
            post_text(base + "/v1/pw_ai_answer",
                      {"prompt": questions[0]})[0])
        keys_of, slab, valid = index_rows(inners[ans_tap])
        r_rows = index_rows(inners[1 - ans_tap])
    finally:
        served.stop()
        shutil.rmtree(root, ignore_errors=True)
    # the reranker over the retrieved (document, question) pairs
    key_text = dict(added)
    pairs = []
    for qi, (q, (batch, replies)) in enumerate(zip(questions, asked)):
        for r, (k, _) in enumerate(replies[0]):
            pairs.append((key_text[int(k)], q, qi, r))
    rr = EncoderReranker(emb)
    pair_t = pw.debug.table_from_rows(
        pw.schema_from_types(doc=str, q=str, qi=int, r=int), pairs)
    runner = GraphRunner()
    cap = runner.capture(pair_t.select(pw.this.qi, pw.this.r,
                                       score=rr(pw.this.doc, pw.this.q)))
    runner.run_batch(n_workers=1)
    scored = {(qi, r): s for _, (qi, r, s), _, _ in cap.events}
    lists = [(tuple(p[0] for p in pairs if p[2] == qi),
              tuple(scored[(qi, r)] for r in range(top_n)), RAG_RERANK_K)
             for qi in range(len(questions))]
    list_t = pw.debug.table_from_rows(
        pw.schema_from_types(docs=tuple, scores=tuple, k=int), lists)
    runner = GraphRunner()
    kept_cap = runner.capture(list_t.select(kept=rerank_topk_filter(
        pw.this.docs, pw.this.scores, pw.this.k)))
    runner.run_batch(n_workers=1)
    launches = {c: c.launches for c in LAUNCH_COUNTS}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    # the holds
    if len(asked) != len(questions) or any(len(b) != 1 for b, _ in asked):
        fail(f"{label}: {len(questions)} questions made {len(asked)} "
             "searches, not one each")
    if len(new_asked) != len(new_questions):
        fail(f"{label}: the new questions made {len(new_asked)} searches")
    all_q = questions + new_questions
    all_s = asked + new_asked
    got_q = np.stack([np.asarray(b[0][1], np.float64) for b, _ in all_s])
    ref_q = plain_embed(emb, all_q)
    q_cos = np.sum(got_q * ref_q, 1) / (np.linalg.norm(got_q, axis=1)
                                        * np.linalg.norm(ref_q, axis=1))
    if not np.all(np.isfinite(got_q)) or q_cos.min() < 0.999:
        fail(f"{label}: a question's embedding is off the plain encoder's "
             f"(min row cosine {q_cos.min():.6f})")
    # the first questions were answered before the new files came
    old_rows = torch.from_numpy(np.array(
        [int(k) in old_keys for k in keys_of])).to(valid.device)
    n_q = len(questions)
    scan = torch.cat([bf16_scan(got_q[:n_q], slab, valid & old_rows),
                      bf16_scan(got_q[n_q:], slab, valid)])
    category = {}
    for qi, (q, (batch, replies)) in enumerate(zip(all_q, all_s)):
        got = list(replies[0])
        check_top10([got], scan[qi:qi + 1], keys_of,
                    f"{label} question {qi}", n=top_n)
        docs_got = [key_text[int(k)] for k, _ in got]
        want, want_calls = plain_geometric(docs_got, q, n0, factor, iters)
        reply = (answers + new_answers)[qi]
        if reply != want or calls[q] != want_calls:
            fail(f"{label} question {qi}: answer {reply!r} after calls "
                 f"{calls[q]}, the plain path's {want!r} after {want_calls}")
        category[qi] = want_calls[-1] if want != NO_INFO_ANSWER else None
    counts = {c: sum(1 for qi in range(len(questions))
                     if category[qi] == c) for c in (2, 4, 8, None)}
    if min(counts.values()) == 0:
        fail(f"{label}: answered at 2 / 4 / 8 documents / never: "
             f"{list(counts.values())}, each must be > 0")
    unanswered = [qi for qi in range(len(questions), len(all_q))
                  if category[qi] is None]
    if unanswered:
        fail(f"{label}: {len(unanswered)} questions on the new files were "
             "not answered once a tick had passed")
    for qi, reply in enumerate(retrieved):
        batch, replies = retrieve_searches[qi]
        if len(reply) != top_n:
            fail(f"{label} retrieve {qi}: {len(reply)} matches")
        text_key = {t: k for k, t in key_text.items()}
        got = [(text_key[m["text"]], m["dist"]) for m in reply]
        rs = bf16_scan(np.asarray(batch[0][1], np.float64)[None, :],
                       r_rows[1], r_rows[2])
        check_top10([got], rs, r_rows[0], f"{label} retrieve {qi}", n=top_n)
        cols = [int(np.flatnonzero(r_rows[0] == int(k))[0]) for k, _ in got]
        err = float(np.abs(np.array([d for _, d in got])
                           - (1.0 - rs[0, cols].cpu().numpy())).max())
        if not err <= 1e-5:
            fail(f"{label} retrieve {qi}: dist off the scan by {err:.3e}")
        for m in reply:
            f = int(os.path.basename(m["metadata"]["path"])[1:6])
            if m["text"] not in [c for c, _ in file_chunks[f]]:
                fail(f"{label} retrieve {qi}: a match's path is not its "
                     "file's")
    r_filter_data = {int(k): v for k, v in
                     inners[1 - ans_tap]._filter_data.items()}
    text_key = {t: k for k, t in key_text.items()}
    if len(filtered_searches) != len(RAG_FILTERS):
        fail(f"{label}: {len(RAG_FILTERS)} filtered retrieves made "
             f"{len(filtered_searches)} searches")
    n_passing = []
    for (field, value), reply, (batch, _) in zip(
            RAG_FILTERS, filtered, filtered_searches):
        filt = batch[0][3]
        if not isinstance(filt, str) or value not in filt:
            fail(f"{label}: the {field} retrieve reached the index with "
                 f"filter {filt!r}")
        passing = np.array([k >= 0 and evaluate_filter(
            filt, r_filter_data.get(int(k))) for k in r_rows[0]])
        n_passing.append(int(passing.sum()))
        rs = bf16_scan(np.asarray(batch[0][1], np.float64)[None, :],
                       r_rows[1], r_rows[2] & torch.from_numpy(passing).to(
                           r_rows[2].device))
        got = [(text_key[m["text"]], m["dist"]) for m in reply]
        if len(got) != min(top_n, n_passing[-1]) or n_passing[-1] < top_n:
            fail(f"{label}: the {field} retrieve gave {len(got)} matches, "
                 f"{n_passing[-1]} rows pass its filter")
        check_top10([got], rs, r_rows[0], f"{label} {field} retrieve",
                    n=top_n)
        cols = [int(np.flatnonzero(r_rows[0] == int(k))[0]) for k, _ in got]
        err = float(np.abs(np.array([d for _, d in got])
                           - (1.0 - rs[0, cols].cpu().numpy())).max())
        if not err <= 1e-5:
            fail(f"{label}: the {field} retrieve's dist is off the filtered "
                 f"scan by {err:.3e}")
    if stats.get("file_count") != RAG_FILES + RAG_NEW_FILES:
        fail(f"{label}: /v1/statistics file_count {stats.get('file_count')}"
             f", {RAG_FILES + RAG_NEW_FILES} files written")
    if via_client != raw:
        fail(f"{label}: RAGClient's replies differ from the raw POSTs'")
    # the reranker's scores against the plain encoder and numpy
    if len(scored) != len(pairs):
        fail(f"{label}: {len(scored)} reranker scores for {len(pairs)} pairs")
    d_emb = plain_embed(emb, [p[0] for p in pairs])
    q_emb = plain_embed(emb, questions)[[p[2] for p in pairs]]
    plain = np.sum(d_emb * q_emb, 1) / (np.linalg.norm(d_emb, axis=1)
                                        * np.linalg.norm(q_emb, axis=1))
    engine = np.array([scored[(p[2], p[3])] for p in pairs])
    rerank_err = float(np.abs(engine - plain).max())
    if not rerank_err <= RERANK_TOL:
        fail(f"{label}: reranker scores off the plain encoder's cosine by "
             f"{rerank_err:.3e} (> {RERANK_TOL})")
    for _, (kept,), _, _ in kept_cap.events:
        kept_docs, kept_scores = kept
        if len(kept_docs) != RAG_RERANK_K or list(kept_scores) != sorted(
                kept_scores, reverse=True):
            fail(f"{label}: rerank_topk_filter kept {kept_scores}")
    if len(kept_cap.events) != len(questions):
        fail(f"{label}: {len(kept_cap.events)} reranked lists")
    for c in (ATTENTION, TOPK_BF16):
        if not launches[c]:
            fail(f"{label}: {c.name} was not launched in the phase")
    n_calls = sum(len(calls[q]) for q in questions)
    seconds = time.perf_counter() - t_phase
    ms = np.array(answer_ms)
    print(f"[{label}] pw.io.fs.read(plaintext_by_file, streaming, "
          f"with_metadata) of {RAG_FILES} files -> TokenCountSplitter("
          f"max_tokens={RAG_MAX_TOKENS}) -> bench's embedder (WordPiece, "
          f"padded, max_len {BENCH_SEQ}) into a bf16 cos index -> "
          f"AdaptiveRAGQuestionAnswerer({n0}, {factor}, {iters}) behind "
          f"run_server: {n_chunks} chunks indexed in {ingest_s:.2f} s, "
          f"{n_chunks / ingest_s:.1f} chunks/s (files written in batches of "
          f"{RAG_FILE_BATCH}); /v1/pw_ai_answer from the client p50 "
          f"{np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} "
          f"ms over {len(questions)} questions; chat calls a question "
          f"{n_calls / len(questions):.3f} ({n_calls} calls); answered at 2 "
          f"/ 4 / 8 documents / never: {counts[2]} / {counts[4]} / "
          f"{counts[8]} / {counts[None]}; {RAG_NEW_FILES} new files "
          f"({n_new_chunks} chunks) indexed in {new_s:.2f} s [{card}]",
          flush=True)
    adds = [a for t in taps for a in t["adds"]]
    print(f"[{label}] ingest by batch of files: "
          + ", ".join(f"{s:.2f}" for s in batch_s)
          + f" s; add_batch calls {len(adds)} (both indexes), rows "
          f"{sum(n for n, _ in adds)}, host seconds inside "
          f"{sum(t for _, t in adds):.2f}; by operator (flight recorder, "
          f"host clock): {ingest_where} [{card}]", flush=True)
    print(f"[{label}] holds: {len(all_q)} answers and their chat calls equal "
          f"the plain path's (plain encoder: min row cosine "
          f"{q_cos.min():.6f} >= 0.999; a plain scan of the index's own "
          f"rows: keys in rank order up to 1e-6 score ties; the geometric "
          f"strategy on the host); the {len(new_questions)} questions on the "
          f"new files all answered a tick after their files; "
          f"{len(retrieved)} /v1/retrieve k={top_n} equal the scan (dist "
          f"within 1e-5); /v1/retrieve with "
          + " and with ".join(f"{f} {v!r} ({n} rows pass)" for (f, v), n in
                              zip(RAG_FILTERS, n_passing))
          + f" equal the same filter over the scan; /v1/statistics file_count {stats['file_count']} = "
          f"files written; RAGClient = the raw POSTs; EncoderReranker over "
          f"{len(pairs)} pairs within {rerank_err:.3e} of the plain "
          f"encoder's cosine (<= {RERANK_TOL}), rerank_topk_filter keeps "
          f"{RAG_RERANK_K} in order; launches in the phase: "
          + ", ".join(f"{c.name} {n}" for c, n in launches.items() if n)
          + f"; peak device memory {peak_mb:.1f} MiB; phase {seconds:.1f} s "
          f"[{card}]", flush=True)
    return launches


KNN_ROWS = 10_000        # BASELINE.md config 1: an in-memory CSV of 10k rows
KNN_DIM = 384
KNN_QUERIES = 256       # in one batch
KNN_SINGLE = 32         # one a tick, their searches timed
KNN_K = 3


def knn_groups_hold(got_ids, got_d, ref_ids, ref_d, tol_d: float,
                    label: str) -> None:
    """One query's ``k`` ids and distances against an exact scan's first
    ``k + extra`` (ids by rank, float64 distances, ascending), as
    tests/test_torch_knn_bf16.py holds the float32 probe: distances
    within ``tol_d``; ids equal rank by rank outside tie groups (runs of
    scan distances each within ``tol_d`` of the one before, whose order
    the float32 sums may set either way), the group's set inside one (a
    subset where rank k cuts it)."""
    k = len(got_ids)
    if not np.allclose(got_d, ref_d[:k], rtol=0, atol=tol_d):
        fail(f"{label}: distances {got_d} off the exact scan's "
             f"{ref_d[:k]} (atol {tol_d:.1e})")
    start = 0
    while start < k:
        end = start + 1
        while end < len(ref_d) and ref_d[end] - ref_d[end - 1] <= tol_d:
            end += 1
        got, want = list(got_ids[start:min(end, k)]), list(
            ref_ids[start:end])
        if (end - start == 1 and got != want) or not set(got) <= set(want) \
                or (end <= k and sorted(got) != sorted(want)):
            fail(f"{label} ranks {start}-{end - 1}: ids {got}, the exact "
                 f"scan's {want}")
        start = end


def phase_knn_index(seed: int, card: str) -> None:
    """BASELINE.md config 1, the classic ``stdlib.ml`` KNNIndex in batch
    mode over an in-memory CSV: ``KNN_ROWS`` rows of ``doc_id`` and 384
    float32 values (``default_rng(seed + 41)``) written to a temporary CSV
    and read with ``pw.io.csv.read(..., mode="static")`` (schema from the
    file), the vector made from the 384 columns by one ``apply``, a Json
    metadata column (``{"parity": doc_id % 2}``). ``KNNIndex(vec, data,
    n_dimensions=384, metadata=...)`` twice, ``distance_type="cosine"``
    and ``"euclidean"`` (float32 slabs on the card: ``torch.matmul`` plus
    the key selection, no hand-written kernel). ``KNN_QUERIES`` queries in
    one batch: ``get_nearest_items(k=3, with_distances=True)`` on both, and
    on the cosine index ``get_nearest_items_asof_now``, a
    ``metadata_filter`` (even ``doc_id``) and ``collapse_rows=False``; then
    ``KNN_SINGLE`` queries one a tick through ``get_nearest_items_asof_now``,
    whose searches are timed one query each; all in one ``run_batch``.
    Each reply against an exact float64 numpy scan (``knn_groups_hold``:
    distances within 1e-5 for cosine, 1e-5 of the largest squared norm for
    euclidean, ids in rank order outside tie groups). Prints rows ingested
    a second, the index search's p50 for one query and the phase's
    seconds."""
    import tempfile

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.ops import knn as knn_mod
    from pathway_tpu_torch.stdlib.ml import KNNIndex

    label = "knn index"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    rows = rng.standard_normal((KNN_ROWS, KNN_DIM)).astype(np.float32)
    queries = rng.standard_normal((KNN_QUERIES, KNN_DIM)).astype(np.float32)
    root = tempfile.mkdtemp(prefix="smoke_knn_")
    path = os.path.join(root, "vectors.csv")
    t0 = time.perf_counter()
    header = "doc_id," + ",".join(f"v{j}" for j in range(KNN_DIM))
    np.savetxt(path, np.column_stack([np.arange(KNN_ROWS), rows]),
               fmt=["%d"] + ["%.9g"] * KNN_DIM, delimiter=",",
               header=header, comments="")
    write_s = time.perf_counter() - t0
    exact = np.loadtxt(path, delimiter=",", skiprows=1)[:, 1:]

    G.clear()
    t0 = time.perf_counter()
    table = pw.io.csv.read(path, mode="static")
    read_s = time.perf_counter() - t0
    os.remove(path)
    os.rmdir(root)
    cols = [table[f"v{j}"] for j in range(KNN_DIM)]
    data = table.select(
        doc_id=pw.this.doc_id,
        vec=pw.apply_with_type(lambda *xs: np.array(xs), np.ndarray, *cols),
        meta=pw.apply_with_type(lambda i: {"parity": i % 2}, pw.Json,
                                pw.this.doc_id))
    even = (lambda m: (m.value if hasattr(m, "value") else m)["parity"]
            == 0)
    q_t = pw.debug.table_from_rows(
        pw.schema_from_types(qid=int, q=np.ndarray, filt=object),
        [(i, queries[i].astype(np.float64), even)
         for i in range(KNN_QUERIES)])
    single = pw.debug.table_from_rows(
        pw.schema_from_types(q=np.ndarray),
        [(queries[i].astype(np.float64), 2 * i + 2, 1)
         for i in range(KNN_SINGLE)], is_stream=True)
    cos = KNNIndex(data.vec, data, n_dimensions=KNN_DIM,
                   distance_type="cosine", metadata=data.meta)
    l2 = KNNIndex(data.vec, data, n_dimensions=KNN_DIM,
                  distance_type="euclidean", metadata=data.meta)
    outs = {
        "cos": cos.get_nearest_items(q_t.q, k=KNN_K, with_distances=True),
        "l2": l2.get_nearest_items(q_t.q, k=KNN_K, with_distances=True),
        "asof": cos.get_nearest_items_asof_now(q_t.q, k=KNN_K,
                                               with_distances=True),
        "filter": cos.get_nearest_items(q_t.q, k=KNN_K, with_distances=True,
                                        metadata_filter=q_t.filt),
        "flat": cos.get_nearest_items(q_t.q, k=KNN_K, collapse_rows=False),
        "single": cos.get_nearest_items_asof_now(single.q, k=KNN_K,
                                                 with_distances=True),
        "queries": q_t.select(pw.this.qid),
    }
    adds, search_ms = [], []
    add_batch, search = (knn_mod.BruteForceKnnIndex.add_batch,
                         knn_mod.BruteForceKnnIndex.search)

    def timed_add(self, *args, **kwargs):
        t = time.perf_counter()
        out = add_batch(self, *args, **kwargs)
        self.flush_device()
        torch.cuda.synchronize()
        adds.append((len(args[0]), time.perf_counter() - t))
        return out

    def timed_search(self, batch):
        t = time.perf_counter()
        out = search(self, batch)
        search_ms.append((len(batch), (time.perf_counter() - t) * 1e3))
        return out

    knn_mod.BruteForceKnnIndex.add_batch = timed_add
    knn_mod.BruteForceKnnIndex.search = timed_search
    try:
        runner = GraphRunner()
        caps = {name: runner.capture(t) for name, t in outs.items()}
        t0 = time.perf_counter()
        runner.run_batch(n_workers=1)
        run_s = time.perf_counter() - t0
    finally:
        knn_mod.BruteForceKnnIndex.add_batch = add_batch
        knn_mod.BruteForceKnnIndex.search = search
        G.clear()

    # the exact float64 scans
    unit = exact / np.linalg.norm(exact, axis=1, keepdims=True)
    qd = queries.astype(np.float64)
    qunit = qd / np.linalg.norm(qd, axis=1, keepdims=True)
    extra = KNN_K + 16
    scans = {
        "cos": 1.0 - qunit @ unit.T,
        "l2": ((qd ** 2).sum(1)[:, None] + (exact ** 2).sum(1)[None, :]
               - 2.0 * qd @ exact.T),
    }
    scans["filter"] = np.where(np.arange(KNN_ROWS)[None, :] % 2 == 0,
                               scans["cos"], np.inf)
    l2_tol = 1e-5 * float((exact ** 2).sum(1).max())
    qid_of = {int(k): row[0] for k, row, _, _ in caps["queries"].events}
    for name, cap in caps.items():
        if any(diff != 1 for _, _, _, diff in cap.events):
            fail(f"{label} {name}: a retraction in a batch run")
    for name in ("cos", "l2", "asof", "filter", "single"):
        if name == "single":
            got = [(t // 2 - 1, row) for _, row, t, _ in caps[name].events]
            n_want = KNN_SINGLE
        else:
            got = [(qid_of[int(k)], row) for k, row, _, _ in
                   caps[name].events]
            n_want = KNN_QUERIES
        if sorted(q for q, _ in got) != list(range(n_want)):
            fail(f"{label} {name}: {len(got)} replies, not one a query")
        scan = scans["cos" if name in ("asof", "single") else name]
        for qi, (dist, doc_ids, _vec, _meta) in got:
            order = np.argsort(scan[qi], kind="stable")[:extra]
            knn_groups_hold(
                np.asarray(doc_ids), np.asarray(dist, np.float64),
                order, scan[qi][order],
                l2_tol if name == "l2" else 1e-5,
                f"{label} {name} query {qi}")
    flat = sorted((int(row[0]), int(k)) for k, row, _, _ in
                  caps["flat"].events)
    collapsed = sorted((int(i), int(k)) for k, row, _, _ in
                       caps["cos"].events for i in row[1])
    if [i for i, _ in flat] != [i for i, _ in collapsed] or \
            len(flat) != KNN_QUERIES * KNN_K:
        fail(f"{label}: collapse_rows=False's rows differ from the collapsed"
             " replies'")
    one = [ms for n, ms in search_ms if n == 1]
    if len(one) != KNN_SINGLE:
        fail(f"{label}: {len(one)} one-query searches, {KNN_SINGLE} sent")
    n_added = sum(n for n, _ in adds)
    add_s = sum(s for _, s in adds)
    seconds = time.perf_counter() - t_phase
    print(f"[{label}] KNNIndex over pw.io.csv.read(static) of {KNN_ROWS} "
          f"rows x {KNN_DIM} floats, cosine and euclidean (float32 slabs on "
          f"the card): CSV written in {write_s:.2f} s, read in "
          f"{read_s:.2f} s ({KNN_ROWS / read_s:.1f} rows/s); index ingest "
          f"{n_added} rows in {add_s:.3f} s ({n_added / add_s:.1f} rows/s, "
          f"{len(adds)} add_batch calls, one a query route's index); "
          f"run_batch {run_s:.2f} s ({KNN_QUERIES} queries in one batch through 5 query routes, "
          f"then {KNN_SINGLE} one a tick); the index search for one query "
          f"p50 {np.percentile(one, 50):.3f} ms, p99 "
          f"{np.percentile(one, 99):.3f} ms, for {KNN_QUERIES} p50 "
          f"{np.percentile([ms for n, ms in search_ms if n > 1], 50):.3f} ms"
          f" (host clock, results on the host) [{card}]", flush=True)
    print(f"[{label}] holds: get_nearest_items (cosine, euclidean), "
          f"get_nearest_items_asof_now, a metadata_filter (even doc_id) and "
          f"collapse_rows=False over {KNN_QUERIES} queries, and "
          f"{KNN_SINGLE} one a tick, equal an exact float64 scan "
          f"(distances within 1e-5, euclidean within {l2_tol:.3e}; ids in "
          f"rank order outside groups of distances within those of each "
          f"other); phase {seconds:.1f} s [{card}]", flush=True)


SEM_POOL = 96           # bench.py's SEM_POOL: distinct query vectors
SEM_ZIPF_S = 1.1        # bench.py's SEM_ZIPF_S: their Zipf draw
RC_QUERIES = 4096       # the replay's queries, RC_TICK a tick
RC_TICK = 8
RC_K = 3
RC_TRICKLE = (16, 64)   # every 16th tick, 64 inserted rows
RC_DELETES = (64, 8)    # every 64th tick, 8 deletions of served rows
RC_DTYPES = ("bfloat16", "int8", "float32")


class PrebuiltFactory:
    """An index factory whose ``build()`` is an index made beforehand, so
    a phase can read the index the as-of-now operator runs on."""

    def __init__(self, index):
        self.index = index

    def build(self):
        return self.index


def stream_table(schema, keys: list, rows: list, times: list, diffs: list):
    """A streamed static table of the given keys: ``table_from_rows``'s
    plan with keys of the caller's (a retraction carries its insertion's
    key)."""
    from pathway_tpu_torch.internals.table import Plan, Table
    from pathway_tpu_torch.internals.universe import Universe

    return Table(Plan("static", keys=keys, rows=rows, times=times,
                      diffs=diffs), schema, Universe())


def rc_workload(n_rows: int, dim: int, seed: int, device: str) -> dict:
    """The replay's inputs, all from ``seed``: ``n_rows`` uniform rows in
    [-1, 1), the pool of ``SEM_POOL`` query vectors, ``RC_QUERIES`` Zipf
    draws from it, the trickled rows, and the deleted rows: the rows a
    plain cosine scan serves the hottest pool vectors first (their top
    ``RC_K``), ``RC_DELETES[1]`` at every deletion tick."""
    import torch

    rng = np.random.default_rng(seed + 51)
    base = rng.random((n_rows, dim), np.float32) * 2.0 - 1.0
    pool = rng.random((SEM_POOL, dim), np.float32) * 2.0 - 1.0
    draws = np.minimum(rng.zipf(SEM_ZIPF_S, RC_QUERIES) - 1, SEM_POOL - 1)
    n_ticks = RC_QUERIES // RC_TICK
    every, n_add = RC_TRICKLE
    trickle = rng.random((n_ticks // every, n_add, dim), np.float32) * 2 - 1
    b = torch.from_numpy(base).to(device)
    p = torch.from_numpy(pool).to(device)
    sims = (p / p.norm(dim=1, keepdim=True)) @ (
        b / b.norm(dim=1, keepdim=True)).T
    top = torch.topk(sims, RC_K, dim=1).indices.cpu().numpy()
    hot = np.argsort(-np.bincount(draws, minlength=SEM_POOL), kind="stable")
    served = list(dict.fromkeys(int(r) for q in hot for r in top[q]))
    n_del = (n_ticks // RC_DELETES[0]) * RC_DELETES[1]
    return {"base": base, "pool": pool, "draws": draws, "trickle": trickle,
            "deleted": served[:n_del], "n_ticks": n_ticks}


def rc_replay(work: dict, dtype: str, cache_on: bool, device: str) -> dict:
    """One replay of ``work`` through the as-of-now operator under
    ``GraphRunner.run_batch`` (the port's runtime, one worker): a data
    table (the rows at time 0, then the trickle and the deletions) and a
    query table (``RC_TICK`` a tick, k = ``RC_K``) into
    ``_external_index_as_of_now`` over a paged cos index of ``dtype``,
    with the result cache on or off (``PATHWAY_RESULT_CACHE`` at the
    index's construction). Returns the output events, each search call's
    query keys and kernel launches, the cache's statistics, the covered
    inserts the beat test let survive, the run's launches by LaunchCount,
    its implicit host syncs and seconds."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import device_sanitizer as ds
    from pathway_tpu_torch.internals.keys import hash_values_uncached
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    base, dim = work["base"], work["base"].shape[1]
    saved = os.environ.get("PATHWAY_RESULT_CACHE")
    os.environ["PATHWAY_RESULT_CACHE"] = "1" if cache_on else "0"
    try:
        index = BruteForceKnnIndex(dim, reserved_space=len(base),
                                   metric="cos", dtype=dtype, device=device)
    finally:
        if saved is None:
            os.environ.pop("PATHWAY_RESULT_CACHE")
        else:
            os.environ["PATHWAY_RESULT_CACHE"] = saved
    calls, survived = [], [0]
    search = index.search

    def counted_search(batch):
        before = sum(c.launches for c in LAUNCH_COUNTS)
        out = search(batch)
        calls.append((frozenset(int(q[0]) for q in batch),
                      sum(c.launches for c in LAUNCH_COUNTS) - before))
        return out

    index.search = counted_search
    cache = index.result_cache
    if cache is not None:
        on_insert = cache.on_insert_batch

        def counted_insert(slots, keys, vecs=None):
            before = len(cache._entries)
            on_insert(slots, keys, vecs)
            if before:
                survived[0] += len(cache._entries)

        cache.on_insert_batch = counted_insert

    dkeys = [hash_values_uncached("rc", i) for i in range(len(base))]
    drows = [(v,) for v in base]
    dtimes, ddiffs = [0] * len(base), [1] * len(base)
    qkeys, qrows, qtimes = [], [], []
    qkey_index = {}
    every, _ = RC_TRICKLE
    del_every, n_del = RC_DELETES
    deleted = iter(work["deleted"])
    for t in range(work["n_ticks"]):
        if t % every == every - 1:
            for v in work["trickle"][t // every]:
                dkeys.append(hash_values_uncached("rc", len(drows)))
                drows.append((v,))
                dtimes.append(t + 1)
                ddiffs.append(1)
        if t % del_every == del_every - 1:
            for _ in range(n_del):
                r = next(deleted)
                dkeys.append(dkeys[r])
                drows.append((base[r],))
                dtimes.append(t + 1)
                ddiffs.append(-1)
        for j in range(t * RC_TICK, (t + 1) * RC_TICK):
            key = hash_values_uncached("rcq", j)
            qkey_index[int(key)] = j
            qkeys.append(key)
            qrows.append((work["pool"][work["draws"][j]], RC_K))
            qtimes.append(t + 1)
    G.clear()
    data = stream_table(pw.schema_from_types(v=np.ndarray), dkeys, drows,
                        dtimes, ddiffs)
    queries = stream_table(pw.schema_from_types(q=np.ndarray, k=int), qkeys,
                           qrows, qtimes, [1] * len(qkeys))
    res = data._external_index_as_of_now(
        queries, index_factory=PrebuiltFactory(index),
        query_responses_limit_column=queries.k)
    runner = GraphRunner()
    cap = runner.capture(res)
    for count in LAUNCH_COUNTS:
        count.launches = 0
    with ds.count_syncs() as syncs:
        t0 = time.perf_counter()
        runner.run_batch(n_workers=1)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    events = sorted((time_, int(key), diff,
                     tuple((int(mk), s) for mk, s in row[0]))
                    for key, row, time_, diff in cap.events)
    return {"events": events, "calls": calls, "qkey_index": qkey_index,
            "stats": None if cache is None else cache.stats(),
            "survived": survived[0], "syncs": syncs.count,
            "seconds": seconds, "index": index,
            "launches": {c: c.launches for c in LAUNCH_COUNTS}}


def rc_account(off: dict, on: dict, label: str) -> tuple[int, int]:
    """The launch accounting of a cache-on replay against its cache-off
    twin: tick by tick (each search call maps to the tick of its query
    keys), the on run's search launches equal the off run's, or the on
    run made no search because every query of the tick was a hit.
    Returns (searches saved, launches saved)."""
    def by_tick(run):
        out = {}
        for keys, n in run["calls"]:
            ticks = {run["qkey_index"][k] // RC_TICK for k in keys}
            if len(ticks) != 1 or ticks & out.keys():
                fail(f"{label}: a search call spans ticks {sorted(ticks)}")
            out[ticks.pop()] = (keys, n)
        return out

    off_t, on_t = by_tick(off), by_tick(on)
    if len(off_t) != RC_QUERIES // RC_TICK:
        fail(f"{label}: the cache-off replay searched on {len(off_t)} ticks, "
             f"not {RC_QUERIES // RC_TICK}")
    saved_searches = saved_launches = 0
    for t, (keys, n) in off_t.items():
        if t in on_t:
            if on_t[t][1] != n:
                fail(f"{label}: tick {t}'s search launched {on_t[t][1]} "
                     f"kernels with the cache on, {n} with it off")
            if not on_t[t][0] <= keys:
                fail(f"{label}: tick {t} searched queries of another tick")
        else:
            saved_searches += 1
            saved_launches += n
    total_off = sum(n for _, n in off["calls"])
    total_on = sum(n for _, n in on["calls"])
    if total_on != total_off - saved_launches:
        fail(f"{label}: {total_on} search launches with the cache on, not "
             f"{total_off} - {saved_launches}")
    return saved_searches, saved_launches


def phase_result_cache(seed: int, card: str, n_rows: int = SERVING_N,
                       device: str = "cuda") -> dict:
    """The semantic result cache on the card: one paged cos index a dtype
    (bf16 as bench_serving's, int8, float32) of ``n_rows`` x 384 rows
    (bench's SERVING_N and SERVING_DIM) from ``seed``, driven through the
    as-of-now operator by a deterministic replay (``rc_replay``):
    ``RC_QUERIES`` queries drawn by Zipf(``SEM_ZIPF_S``) from a
    ``SEM_POOL``-vector pool, k = 3, ``RC_TICK`` a tick, 64 inserted rows
    every 16th tick (past the reservation: the store grows mid-replay) and
    8 deletions of served rows every 64th tick, once with the cache off,
    then on. Holds: the two replays' outputs equal byte for byte; hits > 0
    and invalidations > 0; on float32, covered inserts that survive the
    beat test; the launch accounting exact (``rc_account``); no implicit
    host sync in either replay. Prints the cache's counters, the hit
    ratio, invalidations a tick, K2 / K3 launches on and off and the
    seconds of each replay. Returns the cache-on replays' launches by
    LaunchCount, summed."""
    import torch

    label = "result cache"
    t_phase = time.perf_counter()
    work = rc_workload(n_rows, SERVING_DIM, seed, device)
    launches: dict = {}
    for dtype in RC_DTYPES:
        off = rc_replay(work, dtype, False, device)
        on = rc_replay(work, dtype, True, device)
        st = on["stats"]
        tag = f"{label} {dtype}"
        if on["events"] != off["events"]:
            diff = next(i for i, (a, b) in enumerate(zip(on["events"],
                                                        off["events"]))
                        if a != b)
            fail(f"{tag}: the cache-on replay's output differs from the "
                 f"cache-off one's at event {diff}: {on['events'][diff]} vs "
                 f"{off['events'][diff]}")
        n_replies = sum(1 for e in on["events"] if e[2] > 0)
        if n_replies != RC_QUERIES or any(len(e[3]) != RC_K
                                          for e in on["events"]):
            fail(f"{tag}: {n_replies} replies, not {RC_QUERIES} of {RC_K}")
        if not (st["hits"] > 0 and st["invalidations"] > 0):
            fail(f"{tag}: hits {st['hits']}, invalidations "
                 f"{st['invalidations']}: each must be > 0")
        if dtype == "float32" and not on["survived"]:
            fail(f"{tag}: no covered insert survived the beat test")
        if on["syncs"] or off["syncs"]:
            fail(f"{tag}: {on['syncs']} / {off['syncs']} implicit host "
                 "syncs in the cache-on / off replay")
        saved_searches, saved_launches = rc_account(off, on, tag)
        for c, n in on["launches"].items():
            launches[c] = launches.get(c, 0) + n
        lookups = st["hits"] + st["misses"]
        reused = RC_QUERIES - sum(len(k) for k, _ in on["calls"])
        search_kinds = ", ".join(
            f"{c.name} {on['launches'][c]} on / {off['launches'][c]} off"
            for c in off["launches"]
            if on["launches"][c] or off["launches"][c])
        print(f"[{tag}] {n_rows} x {SERVING_DIM} {dtype} cos index (paged, "
              f"grown to {on['index'].capacity} rows), {RC_QUERIES} queries "
              f"(Zipf {SEM_ZIPF_S} over {SEM_POOL}, k={RC_K}, {RC_TICK} a "
              f"tick) through the as-of-now operator under run_batch: hits "
              f"{st['hits']}, misses {st['misses']}, fills {st['fills']}, "
              f"invalidations {st['invalidations']} "
              f"({st['invalidations'] / work['n_ticks']:.3f} a tick), "
              f"evictions {st['evictions']}, hit ratio "
              f"{st['hits'] / lookups:.4f}; queries that reached no search "
              f"{reused} (hits + duplicate misses), searches saved "
              f"{saved_searches}, launches saved {saved_launches}; "
              f"launches: {search_kinds or 'none'}; "
              f"covered inserts surviving the beat test {on['survived']}; "
              f"replay {on['seconds']:.3f} s on, {off['seconds']:.3f} s off; "
              f"implicit host syncs {on['syncs']} on, {off['syncs']} off "
              f"[{card}]", flush=True)
        del on, off
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    print(f"[{label}] holds: bf16, int8 and float32 replies byte-identical "
          f"with the cache on and off ({RC_QUERIES} each), hits > 0 and "
          f"invalidations > 0 on each, covered float32 inserts surviving "
          f"the beat test, every tick's search launches equal on and off "
          f"or saved by hits, 0 implicit host syncs; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


PAGING_DIM = 256            # bench.py's BENCH_PAGING_DIM
PAGING_CHUNK = 4096         # BENCH_PAGING_CHUNK
PAGING_ROWS = 16 * 4096     # BENCH_PAGING_ROWS
FULL_PAGING_CHUNK = 65_536  # the full-width run: BGE-small's 384 dims,
FULL_PAGING_RESERVED = 131_072  # from this reservation ...
FULL_PAGING_ROWS = 1 << 20      # ... to this many rows
QUOTA_ROWS = {"a": 2048, "b": 4096}


def paging_ingest(index, vecs: np.ndarray, chunk: int) -> tuple:
    """bench_paging's ingest loop (bench.py:2466-2483): each chunk of rows
    ``add_batch`` + ``flush_device`` + ``drain``, its wall time in ms, and
    the chunks that grew the index. Returns (chunk ms, [(ms, capacity
    after)] of the growing chunks)."""
    from pathway_tpu_torch.internals.keys import Pointer

    chunk_ms, grows = [], []
    for base in range(0, len(vecs), chunk):
        m = min(chunk, len(vecs) - base)
        keys = [Pointer(base + i) for i in range(m)]
        cap_before = index.capacity
        t0 = time.perf_counter()
        index.add_batch(keys, vecs[base:base + m])
        index.flush_device()
        index.drain()
        ms = (time.perf_counter() - t0) * 1e3
        chunk_ms.append(ms)
        if index.capacity > cap_before:
            grows.append((ms, index.capacity))
    return chunk_ms, grows


def bench_paging(dim: int = PAGING_DIM, chunk: int = PAGING_CHUNK,
                 total: int = PAGING_ROWS, device: str = "cuda") -> dict:
    """bench.py's ``bench_paging`` (bench.py:2438-2525) in the port, with
    its keys: ``total`` rows of ``dim`` uniform float32 (``default_rng(
    0)``) ingested ``chunk`` at a time into a float32 cos index reserved
    for 2 chunks, paged and contiguous (``paging_ingest``), each searched
    once for row 7 (k=5); then ``pw.warmup`` of a tiny ragged embedder
    (max_len 512) through a fused paged index, its shapes counted against
    the embedder's padded bucket widths."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex, KnnMetric)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    rng = np.random.default_rng(0)
    vecs = rng.random((total, dim), np.float32) * 2.0 - 1.0

    def run_mode(paged: bool):
        index = BruteForceKnnIndex(dim, reserved_space=2 * chunk,
                                   metric=KnnMetric.COS, paged=paged,
                                   device=device)
        chunk_ms, grows = paging_ingest(index, vecs, chunk)
        res = index.search([(Pointer(10**9), vecs[7], 5, None)])
        return {
            "ingest_p50_ms": round(float(np.percentile(chunk_ms, 50)), 2),
            "ingest_p99_ms": round(float(np.percentile(chunk_ms, 99)), 2),
            "grow_stall_ms": round(max(ms for ms, _ in grows), 2)
            if grows else None,
            "grow_events": len(grows),
            "upload_amplification": round(index.upload_rows_total / total,
                                          3),
        }, res

    paged, res_p = run_mode(True)
    slab, res_s = run_mode(False)
    out = {"paging_rows": total, "paging_dim": dim, "paging_chunk": chunk,
           "paging_identical_topk": res_p == res_s}
    for k, v in paged.items():
        out[f"paging_{k}_paged"] = v
    for k, v in slab.items():
        out[f"paging_{k}_slab"] = v
    cfg = EncoderConfig.tiny(max_len=512)
    emb = EncoderEmbedder(config=cfg, ragged=True, max_len=512,
                          device=device)
    idx = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
        cfg.hidden, metric=KnnMetric.COS, paged=True, device=device))
    t0 = time.perf_counter()
    warm = pw.warmup(emb, index=idx, cache=False)
    out["paging_warmup_compiles_ragged"] = len(warm["compiled"])
    out["paging_warmup_seconds_ragged"] = round(time.perf_counter() - t0, 2)
    out["paging_warmup_bucket_shapes"] = len(emb.bucket_widths())
    return out


def phase_paging(seed: int, card: str, device: str = "cuda",
                 full_rows: int = FULL_PAGING_ROWS,
                 full_chunk: int = FULL_PAGING_CHUNK,
                 full_reserved: int = FULL_PAGING_RESERVED) -> dict:
    """The contiguous slab beside the paged store on the card. (1)
    ``bench_paging`` at bench's sizes; holds (tests/paging_canary.py's):
    identical top-k, both layouts grow, the paged upload amplification at
    most 1.5 and the slab's at least 0.5 above it, at most 6 ragged
    warm-up shapes. (2) The same ingest at
    BGE-small's width: 384 dims, bf16 and int8 cos indexes from
    ``full_reserved`` to ``full_rows`` rows in chunks of ``full_chunk``
    (``default_rng(seed + 61)``), each layout's stall at every growth, then
    16 searches of one query and 4 of 64 (k=10) timed on the host clock
    (results on the host) on both layouts over the same rows; holds: the
    same grow events, the paged amplification at least 0.5 below the slab's, and the
    top 10 of 64 queries equal on both layouts (keys, distances within
    1e-6), the int8 paged amplification exactly 1.0. (3) Quotas: two tenants' paged int8 indexes under
    ``QUOTA_ROWS``; tenant a's ``add_batch`` past its quota and tenant b's
    graphed ingest (one capture, four replays) past its quota raise
    ``PageQuotaExceeded`` and leave their index as it was. Returns the
    launches of (2) and (3) by LaunchCount."""
    import torch

    from pathway_tpu_torch.engine.paged_store import PageQuotaExceeded
    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    label = "paging"
    t_phase = time.perf_counter()
    out = bench_paging(device=device)
    # tests/paging_canary.py's gates: the paged store may count one dense
    # upload of a fresh extent's empty rows (1.125 here, as in the JAX
    # package), the slab re-ships every occupied row at each growth
    if not (out["paging_identical_topk"] and out["paging_grow_events_paged"]
            >= 1 and out["paging_grow_events_slab"] >= 1
            and out["paging_upload_amplification_paged"] <= 1.5
            and out["paging_upload_amplification_slab"]
            >= out["paging_upload_amplification_paged"] + 0.5
            and out["paging_warmup_compiles_ragged"] <= 6):
        fail(f"{label}: bench_paging's holds fail: {json.dumps(out)}")
    print(f"[{label}] bench.py's keys (bench_paging in the port: "
          f"{PAGING_ROWS} x {PAGING_DIM} float32 cos rows in chunks of "
          f"{PAGING_CHUNK}, paged vs contiguous slab): " + json.dumps(out)
          + f"; bench leg {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)

    t_full = time.perf_counter()
    rng = np.random.default_rng(seed + 61)
    vecs = rng.random((full_rows, SERVING_DIM), np.float32) * 2.0 - 1.0
    qs = rng.random((64, SERVING_DIM), np.float32) * 2.0 - 1.0
    for count in LAUNCH_COUNTS:
        count.launches = 0
    for dtype in ("bfloat16", "int8"):
        runs = {}
        for paged in (True, False):
            index = BruteForceKnnIndex(
                SERVING_DIM, reserved_space=full_reserved, metric="cos",
                dtype=dtype, paged=paged, device=device)
            chunk_ms, grows = paging_ingest(index, vecs, full_chunk)
            one = [(Pointer(-1), qs[i], 10, None) for i in range(64)]
            times_1, times_64 = [], []
            for i in range(16):
                t0 = time.perf_counter()
                index.search([one[i]])
                times_1.append((time.perf_counter() - t0) * 1e3)
            for _ in range(4):
                t0 = time.perf_counter()
                top = index.search(one)
                times_64.append((time.perf_counter() - t0) * 1e3)
            runs[paged] = {
                "grows": grows, "p50": float(np.percentile(chunk_ms, 50)),
                "amp": index.upload_rows_total / full_rows,
                "b1": float(np.percentile(times_1, 50)),
                "b64": float(np.percentile(times_64, 50)), "top": top,
                "type": type(index).__name__}
            del index
            gc.collect()
        p, s = runs[True], runs[False]
        tag = f"{label} {dtype}"
        for qi, (a, b) in enumerate(zip(p["top"], s["top"])):
            if [int(k) for k, _ in a] != [int(k) for k, _ in b] or max(
                    abs(x - y) for (_, x), (_, y) in zip(a, b)) > 1e-6:
                fail(f"{tag}: query {qi}'s top 10 differs between the "
                     f"layouts: {a} vs {b}")
        # int8 rows only ever go up by K4's scatter: each once. A bf16
        # extent's first dense upload also ships its empty rows
        if len(p["grows"]) != len(s["grows"]) or not s["grows"] or \
                (dtype == "int8" and p["amp"] != 1.0) or p["amp"] > 1.5 \
                or not s["amp"] >= p["amp"] + 0.5:
            fail(f"{tag}: grow events {len(p['grows'])} / {len(s['grows'])}"
                 f", amplification {p['amp']:.3f} / {s['amp']:.3f} "
                 "(paged / slab)")
        stalls = "; ".join(
            f"to {cs} rows: paged {pm:.1f} ms, slab {sm:.1f} ms"
            for (pm, _), (sm, cs) in zip(p["grows"], s["grows"]))
        print(f"[{tag}] {full_rows} x {SERVING_DIM} {dtype} cos rows from "
              f"a reservation of {full_reserved}, chunks of {full_chunk} "
              f"({p['type']} vs {s['type']}): stall at each growth "
              f"{stalls}; ingest p50 paged {p['p50']:.1f} ms, slab "
              f"{s['p50']:.1f} ms a chunk; upload amplification paged "
              f"{p['amp']:.3f}, slab {s['amp']:.3f}; search p50 (host "
              f"clock, results on the host) B=1 paged {p['b1']:.3f} ms, "
              f"slab {s['b1']:.3f} ms; B=64 paged {p['b64']:.3f} ms, slab "
              f"{s['b64']:.3f} ms; top 10 of 64 queries equal on both "
              f"[{card}]", flush=True)
        del runs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    del vecs
    full_s = time.perf_counter() - t_full

    quotas = {}
    qrng = np.random.default_rng(seed + 62)
    rows = {t: qrng.random((n, SERVING_DIM), np.float32) * 2.0 - 1.0
            for t, n in QUOTA_ROWS.items()}
    a = BruteForceKnnIndex(SERVING_DIM, reserved_space=QUOTA_ROWS["a"],
                           metric="cos", dtype="int8", device=device,
                           tenant="a", tenant_quotas=QUOTA_ROWS)
    a.add_batch([Pointer(i) for i in range(QUOTA_ROWS["a"])], rows["a"])
    try:
        a.add_batch([Pointer(10**6)], rows["a"][:1])
        fail(f"{label}: tenant a's add_batch past its quota did not raise")
    except PageQuotaExceeded as e:
        quotas["add_batch"] = str(e)
    b = BruteForceKnnIndex(SERVING_DIM, reserved_space=QUOTA_ROWS["b"],
                           metric="cos", dtype="int8", device=device,
                           tenant="b", tenant_quotas=QUOTA_ROWS)
    ingest = b.make_graphed_ingest(lambda model, x: x)
    step_rows = 1024
    for c0 in range(0, QUOTA_ROWS["b"], step_rows):
        if not ingest([Pointer(c0 + i) for i in range(step_rows)], None,
                      rows["b"][c0:c0 + step_rows]):
            fail(f"{label}: tenant b's graphed ingest left its extent")
    try:
        ingest([Pointer(10**6 + i) for i in range(step_rows)], None,
               rows["b"][:step_rows])
        fail(f"{label}: tenant b's graphed ingest past its quota did not "
             "raise")
    except PageQuotaExceeded as e:
        quotas["graphed ingest"] = str(e)
    for idx, t in ((a, "a"), (b, "b")):
        if len(idx) != QUOTA_ROWS[t] or idx.page_stats()["tenants"] != {
                t: QUOTA_ROWS[t] // idx.page_stats()["page_rows"]}:
            fail(f"{label}: tenant {t}'s index holds {len(idx)} rows, pages "
                 f"{idx.page_stats()['tenants']} after the refused write")
        got = idx.search([(Pointer(-1), rows[t][5], 1, None)])
        if int(got[0][0][0]) != 5:
            fail(f"{label}: tenant {t}'s row 5 is not its own nearest row")
    step = ingest.step
    if device == "cuda" and (step.captures, step.replays) != (1, 4):
        fail(f"{label}: the graphed ingest captured {step.captures} and "
             f"replayed {step.replays} graphs, not 1 and 4")
    launches = {c: c.launches for c in LAUNCH_COUNTS}
    print(f"[{label}] quotas ({QUOTA_ROWS} rows, paged int8 indexes of "
          f"tenants a and b): PageQuotaExceeded from tenant a's add_batch "
          f"({quotas['add_batch']}) and from tenant b's graphed ingest "
          f"({quotas['graphed ingest']}; {step.captures} capture, "
          f"{step.replays} replays before it), both indexes unchanged "
          f"after the refusal [{card}]", flush=True)
    print(f"[{label}] holds: bench_paging's identical top-k, grow events "
          f"paged {out['paging_grow_events_paged']} / slab "
          f"{out['paging_grow_events_slab']}, upload amplification "
          f"{out['paging_upload_amplification_paged']} <= 1.5, slab "
          f"{out['paging_upload_amplification_slab']}, ragged warm-up "
          f"shapes {out['paging_warmup_compiles_ragged']} <= 6; at 384 "
          f"dims bf16 and int8 the same grow events on both layouts, paged "
          f"amplification at least 0.5 below the slab's (int8: 1.0), top 10 "
          f"equal; "
          f"PageQuotaExceeded on the card; launches (full width and "
          f"quotas): " + ", ".join(f"{c.name} {n}" for c, n in
                                   launches.items() if n)
          + f"; full-width runs {full_s:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
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


ARRAY_SUM_SHARDED = (384, 4096, 64)  # D, rows a tick (two ticks), groups


def array_sum_sharded(seed: int, card: str) -> None:
    """The array_sum route at 4 workers, as tests/test_groupby.py:273-310
    holds the JAX package: ``groupby(g).reduce(g, a=npsum(v),
    s=sum(v))`` over two ticks of 4096 rows of D = 384 (64 groups; every
    7th row -0.0) with the route forced on and the row gate off
    (``_ARRAY_SUM_MIN_ROWS`` 1), so every worker's share of a tick goes
    through ``device_segsum`` on the card; against the one-worker per-row
    numpy loop. Holds: the events bit for bit equal (the arrays' bytes:
    -0.0's sign bits included), every one of the 4 replicas took the
    route on both ticks, ``device_segsum`` called 4 x 2 x 2 times (two
    reducers)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner

    d, r, groups = ARRAY_SUM_SHARDED
    rng = np.random.default_rng(seed + 5)
    vecs = rng.standard_normal((2 * r, d)).astype(np.float32)
    vecs[::7] = -0.0
    gids = rng.integers(0, groups, 2 * r)
    segsum = ops.device_segsum
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return segsum(*args)

    def run(route: str, n_workers: int, min_rows: int):
        G.clear()
        saved = ops._ARRAY_SUM_MIN_ROWS
        ops._ARRAY_SUM_MIN_ROWS = min_rows
        ops.device_segsum = counted
        try:
            t = table_from_rows(
                pw.schema_from_types(g=int, v=np.ndarray),
                [(int(gids[i]), vecs[i], 2 * (i // r), 1)
                 for i in range(2 * r)], is_stream=True)
            runner = GraphRunner()
            cap = runner.capture(t.groupby(t.g).reduce(
                t.g, a=pw.reducers.npsum(t.v), s=pw.reducers.sum(t.v)))
            calls[0] = 0
            with ArraySumRoute(route):
                t0 = time.perf_counter()
                runner.run_batch(n_workers=n_workers)
                wall = time.perf_counter() - t0
        finally:
            ops._ARRAY_SUM_MIN_ROWS = saved
            ops.device_segsum = segsum
            G.clear()
        node = next(n for n in runner.graph.nodes
                    if isinstance(n.op, ops.GroupByOperator))
        events = sorted(
            (int(k), row[0], row[1].tobytes(), row[2].tobytes(), tt, dd)
            for k, row, tt, dd in cap.consolidated_events())
        return {"events": events, "calls": calls[0], "wall": wall,
                "steps": [rep.segsum_steps for rep in
                          runner._scheduler._replicas[node.id]]}

    host = run("host", 1, ops._ARRAY_SUM_MIN_ROWS)
    sharded = run("device", 4, 1)
    if sharded["events"] != host["events"]:
        fail("array_sum 4 workers: the device route's events differ from "
             "the one-worker per-row loop's")
    if sharded["steps"] != [2] * 4 or sharded["calls"] != 4 * 2 * 2 \
            or host["calls"]:
        fail(f"array_sum 4 workers: segsum steps by replica "
             f"{sharded['steps']}, device_segsum calls {sharded['calls']} "
             f"(one-worker host leg {host['calls']}), want [2, 2, 2, 2], "
             "16 and 0")
    print(f"[array_sum] 4 workers, row gate off: D={d}, two ticks of {r} "
          f"rows in {groups} groups; device_segsum on every worker "
          f"(segsum steps by replica {sharded['steps']}, {sharded['calls']} "
          f"calls), events bit for bit the one-worker per-row loop's "
          f"(-0.0 sign bits included); run_batch {sharded['wall'] * 1e3:.1f}"
          f" ms at 4 workers, {host['wall'] * 1e3:.1f} ms for the host leg "
          f"[{card}]", flush=True)


def phase_array_sum(seed: int, card: str) -> None:
    """GroupByOperator's array_sum route: ``device_segsum`` (the torch
    form of the JAX package's ``_device_segsum_fn``: one in-order f32 add
    launch a row position over the padded (G, M, D) rows) on the card,
    bit for bit against the sequential numpy loop; then, for each case of
    ARRAY_SUM_CASES, the route forced on ("device"), off ("host") and
    under the rule alone ("rule"), once each in that order: the operator's host ms a tick, the device route's pre-pass
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
        for route in ("device", "host", "rule"):
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
              f"{dev[0]['step']:.3f}, per-row loop {host[0]['step']:.3f}; "
              f"the device route's pre-pass {dev[0]['pre-pass']:.3f} "
              f"against the per-row adds it replaces "
              f"{host[0]['adds']:.3f}; the rule takes the {'device' if want['rule'] else 'host'} route "
              f"({runs['rule'][0]['step']:.3f}); events bit for bit equal "
              f"[{card}]", flush=True)
    array_sum_sharded(seed, card)


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


SHARDED_KNN_SHARDS = 4      # config 5's data axis, four shards on one card
SHARDED_I8_ROWS = 1 << 20   # the int8 sharded index: the first 2 chunks


def hold_outside_ties(results, ref_top: list, label: str) -> int:
    """Each query's keys (``results``: [(key, distance)] best first)
    against ``ref_top`` (the same queries' keys from another index over the
    same rows): equal at every rank, except at a rank whose distance equals
    a neighbouring rank's (a tie group, which two indexes may order
    differently) or at the last rank (which may tie with the next). Returns
    the queries whose keys are identical."""
    same = 0
    for qi, ref in enumerate(ref_top):
        got = results[qi]
        keys, ref = [int(k) for k, _ in got], [int(k) for k in ref]
        if len(keys) != len(ref):
            fail(f"{label} query {qi}: {len(keys)} keys, not {len(ref)}")
        same += keys == ref
        for r in range(len(keys)):
            tied = r == len(keys) - 1 or any(
                0 <= j < len(keys) and got[j][1] == got[r][1]
                for j in (r - 1, r + 1))
            if keys[r] != ref[r] and not tied:
                fail(f"{label} query {qi} rank {r}: key {keys[r]} against "
                     f"{ref[r]}, not in a tie group")
    return same


def slot_keys(index) -> np.ndarray:
    """The key of each global slot of a sharded index (-1: none), the
    column order of a scan of its extents and shards in turn."""
    keys_of = np.full(index.total_capacity, -1, dtype=np.int64)
    n = len(index._slot_to_key)
    keys_of[np.fromiter(index._slot_to_key.keys(), np.int64, n)] = \
        np.fromiter(index._slot_to_key.values(), np.int64, n)
    return keys_of


def phase_sharded_knn(bf16_rows: tuple, card: str) -> dict:
    """The mesh-sharded index of BASELINE.md config 5 at bench_knn's size:
    ``ShardedKnnIndex(384, mesh=<4 shards on cuda:0>, reserved_space=n,
    dtype="bfloat16", metric="cos")`` (paged, the default) fed bench_knn's
    rows (``bench_knn_rows``, the bf16 10M phase's n rows, chunk by chunk,
    through ``add_batch`` from host float32: the per-key allocation to the
    emptiest shard, then one upload a shard on the first search). The host
    mirror is f32 (16.1 GB at 10M rows); ``rows_that_fit`` cuts n where
    the machine cannot hold it. Searches: bench_knn's 64 queries at B=1
    (64 calls after a warm-up) and B=64 (5 calls), k=10, then the filtered
    run (limit 20, a filter every row passes: fetch 80, past K_MAX, K2's
    score twin a chunk of each shard). Holds: the first 8 queries' top-10
    keys equal the bf16 10M phase's outside tie groups (same bf16 rows and
    queries, the same K2 arithmetic a row), every top-10 and filtered
    top-20 against a plain scan of the shards, each B=64 search equal to
    the B=1 ones, K2 = searches x 4 shards x extents, K2 score = filtered
    searches x 4 shards x chunks a shard. Then an int8 sharded index over
    the first SHARDED_I8_ROWS rows: codes, scales and vsq bit for bit the
    host quantizer's (``_quantize_i8_np``, the divide) of the mirror,
    every top-10 at B=64 against ``score_i8_reference`` over the same
    shard tensors, K3 top-k = searches x 4 shards; K1 and K3's score twin
    never launch. Prints rows/s added, p50 / p99 at B=1, p50 at B=64, the
    filtered p50s, peak device memory, launches and seconds. Returns each
    kernel's launches, by LaunchCount, K1's 0 included."""
    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, SCORE_I8,
                                                   TOPK_BF16, TOPK_I8,
                                                   score_float_reference,
                                                   score_i8_reference)
    from pathway_tpu_torch.parallel import (MeshConfig, ShardedKnnIndex,
                                            make_mesh)
    from pathway_tpu_torch.parallel.sharded_knn import _quantize_i8_np

    label = "sharded knn"
    t_phase = time.perf_counter()
    qs, top8, n_bf16 = bf16_rows
    D, chunk, S = 384, 1 << 19, SHARDED_KNN_SHARDS
    n = rows_that_fit(label, n_bf16, D * 4)
    mesh = make_mesh(MeshConfig(data=S), devices=[torch.device("cuda")] * S)
    counts = (ATTENTION, TOPK_BF16, SCORE_BF16, TOPK_I8, SCORE_I8)
    for c in counts:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = ShardedKnnIndex(D, mesh=mesh, reserved_space=n,
                            dtype="bfloat16", metric="cos")
    for ci, base in enumerate(range(0, n, chunk)):
        m = min(chunk, n - base)
        index.add_batch(list(map(Pointer, range(base, base + m))),
                        bench_knn_rows(ci, m, D).float().cpu().numpy())
    t_host = time.perf_counter()
    index.flush_device()
    index.drain()
    add_s = time.perf_counter() - t0
    exts = index._extents
    print(f"[{label}] {len(index):,} rows added in {add_s:.2f} s "
          f"({n / add_s:,.1f} rows/s; add_batch {t_host - t0:.2f} s, the "
          f"upload {add_s - (t_host - t0):.2f} s) over {S} shards of "
          f"{index.cap_per_shard:,} rows on cuda:0 ({len(exts)} extent(s)) "
          f"[{card}]", flush=True)
    if len(index) != n:
        fail(f"{label}: the index holds {len(index)} rows, not {n}")
    results, batch_res, lat1, lat64 = timed_searches(index, qs, 10**10, 10,
                                                     None)
    k2 = TOPK_BF16.launches
    f_res, f_batch, f_lat1, f_lat64 = timed_searches(
        index, qs, 2 * 10**10, 20, lambda data: True)
    k2_score, k2_after = SCORE_BF16.launches, TOPK_BF16.launches - k2
    chunks = sum(-(-e.cap_per_shard // _CHUNK_ROWS) for e in exts)
    print(f"[{label}] search p50 (host merge included) at B=1 "
          f"{np.percentile(lat1, 50):.3f} ms (p99 {np.percentile(lat1, 99):.3f}"
          f"), at B=64 {np.percentile(lat64, 50):.3f} ms per call; filtered "
          f"(limit 20, fetch 80): B=1 {np.percentile(f_lat1, 50):.3f} ms "
          f"(p99 {np.percentile(f_lat1, 99):.3f}), B=64 "
          f"{np.percentile(f_lat64, 50):.3f} ms [{card}]", flush=True)
    print(f"[{label}] launches: K2 {k2} ({FILTERED_10M} searches x {S} "
          f"shards x {len(exts)} extent(s)), K2 score {k2_score} "
          f"({FILTERED_10M} filtered searches x {chunks} chunks over the "
          f"shards' extents), K2 in the filtered run {k2_after}", flush=True)
    if k2 != FILTERED_10M * S * len(exts) or k2_after or \
            k2_score != FILTERED_10M * S * chunks:
        fail(f"{label}: K2 or its score twin did not launch once a shard "
             "and extent (chunk) a search")
    if n == n_bf16:
        same = hold_outside_ties(results, top8,
                                 f"{label} vs the bf16 10M index")
        print(f"[{label}] the first 8 queries' top-10 against the unsharded "
              f"bf16 10M index over the same rows: equal outside tie groups "
              f"({same}/8 identical)", flush=True)
    else:
        print(f"[{label}] CUT: {n:,} of the bf16 10M index's {n_bf16:,} "
              "rows, so its top-10 is not compared with that index's",
              flush=True)
    qraw = torch.from_numpy(qs).cuda()
    qf = (qraw / (qraw.norm(dim=1, keepdim=True) + 1e-12)).to(
        torch.bfloat16).float()
    keys_of = slot_keys(index)
    scan = torch.cat([score_float_reference(qf, e.vectors[s], e.valid[s],
                                            "cos")
                      for e in exts for s in range(S)], dim=1)
    for res, bres, k, what in ((results, batch_res, 10, "top-10"),
                               (f_res, f_batch, 20, "filtered top-20")):
        rank1 = check_top10(res, scan, keys_of, f"{label} {what}", n=k)
        if [[int(x) for x, _ in r] for r in bres] != \
                [[int(x) for x, _ in r] for r in res]:
            fail(f"{label} {what}: a B=64 search differs from the B=1 ones")
        print(f"[{label}] {what} vs a plain scan of the shards: all 64 "
              f"queries pass (rank 1 identical on {rank1}/64); the B=64 "
              "search returns the same keys", flush=True)
    peak_bf16 = torch.cuda.max_memory_allocated()
    del index, scan, results, batch_res, f_res, f_batch
    gc.collect()
    torch.cuda.empty_cache()
    # int8: the first SHARDED_I8_ROWS rows, quantized on the host
    t1 = time.perf_counter()
    n8 = min(SHARDED_I8_ROWS, n)
    i8 = ShardedKnnIndex(D, mesh=mesh, reserved_space=n8, dtype="int8",
                         metric="cos")
    for ci, base in enumerate(range(0, n8, chunk)):
        m = min(chunk, n8 - base)
        i8.add_batch(list(map(Pointer, range(base, base + m))),
                     bench_knn_rows(ci, m, D).float().cpu().numpy())
    i8.flush_device()
    i8.drain()
    add8_s = time.perf_counter() - t1
    for e in i8._extents:
        for s in range(S):
            lo = e.base + s * e.cap_per_shard
            q8, scale, vsq = _quantize_i8_np(
                i8._host_vectors[lo:lo + e.cap_per_shard])
            valid = i8._host_valid[lo:lo + e.cap_per_shard]
            for got, want, what in ((e.vectors[s], q8, "codes"),
                                    (e.scales[s], scale, "scales"),
                                    (e.vsq[s], vsq, "vsq")):
                got = got.cpu().numpy()[valid]
                if not np.array_equal(got.view(np.uint8),
                                      want[valid].view(np.uint8)):
                    fail(f"{label} int8: shard {s}'s {what} differ from "
                         "the host quantizer's")
    k3_before = TOPK_I8.launches
    res8 = i8.search([(Pointer(3 * 10**10 + i), qs[i], 10, None)
                      for i in range(64)])
    k3 = TOPK_I8.launches - k3_before
    qb = qf.to(torch.bfloat16)
    keys8 = slot_keys(i8)
    scan8 = torch.cat([score_i8_reference(qb, e.vectors[s], e.scales[s],
                                          e.vsq[s], e.valid[s], "cos")
                       for e in i8._extents for s in range(S)], dim=1)
    rank1 = check_top10(res8, scan8, keys8, f"{label} int8 top-10")
    n8_ext = len(i8._extents)
    if k3 != S * n8_ext or SCORE_I8.launches:
        fail(f"{label} int8: K3 top-k launched {k3} times for one search "
             f"over {S} shards x {n8_ext} extent(s)")
    print(f"[{label}] int8 over the first {n8:,} rows: added in "
          f"{add8_s:.2f} s; codes, scales and vsq of every shard bit for "
          f"bit the host quantizer's (the divide); the 64 queries' top-10 "
          f"(B=64) against score_i8_reference over the same shard tensors:"
          f" all pass (rank 1 identical on {rank1}/64); K3 top-k {k3} "
          f"({S} shards x {n8_ext} extent(s))", flush=True)
    launches = {c: c.launches for c in counts}
    if launches[ATTENTION]:
        fail(f"{label}: K1 launched {launches[ATTENTION]} times in a phase "
             "that runs no encoder")
    print(f"[{label}] peak device memory {peak_bf16 / 2**20:.1f} MiB (bf16 "
          f"index); launches K1 {launches[ATTENTION]}, K2 "
          f"{launches[TOPK_BF16]}, K2 score {launches[SCORE_BF16]}, K3 top-k "
          f"{launches[TOPK_I8]}, K3 score {launches[SCORE_I8]}; "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del i8, scan8
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "rows_per_s": n / add_s,
            "p50_ms": [float(np.percentile(lat1, 50)),
                       float(np.percentile(lat64, 50))],
            "filtered_p50_ms": [float(np.percentile(f_lat1, 50)),
                                float(np.percentile(f_lat64, 50))]}


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


# the model layer's training paths (phase_train, phase_moe, phase_clip)
TRAIN_PAIRS = 128  # query/document pairs a step
TRAIN_SEQ = 128    # tokens a side, valid lengths drawn from [16, 128]
TRAIN_WARM, TRAIN_STEPS = 3, 20
HOLD_B, HOLD_S = 8, 64  # the f32 card-against-CPU step
MOE_EXPERTS = 4         # the JAX package's tests' E
MOE_DOCS = 10_240
MOE_QUERIES = 64
MOE_HELD = 512          # documents whose K1 embeddings are held
MOE_STEPS = 10
CLIP_ITEMS = 512        # images and texts embedded
CLIP_HOLD_B = 4
CLIP_TRAIN_B = 64
CLIP_STEPS = 10
# Adam's rate for phase_clip's steps: at make_clip_optimizer's default,
# 1e-3, both packages' steps collapse the towers to chance from random
# init at ClipConfig()'s width (PERF.md, section 6); at 3e-5 the loss falls
CLIP_LR = 3e-5


def train_batch(pairs: int, seq: int, vocab: int, seed: int) -> dict:
    """Token ids from the seed, both sides (pairs, seq), each row's valid
    length drawn from [16, seq]: the mask and CLS pooling do real work."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in "qd":
        lens = rng.integers(16, seq + 1, size=pairs)
        mask = np.arange(seq)[None, :] < lens[:, None]
        ids = rng.integers(1000, vocab, size=(pairs, seq))
        out[f"{side}_ids"] = np.where(mask, ids, 0).astype(np.int32)
        out[f"{side}_mask"] = mask
    return out


def hold_grads(card_grads: dict, cpu_grads: dict, label: str,
               rel: float) -> float:
    """Every gradient tensor of the card's step against the CPU's: the
    largest error at most ``rel`` x the tensor's largest |grad| + 1e-5 x
    the model's largest |grad|. The floor is for gradients that are
    rounding noise on both sides: 0 (the key bias, to which the softmax
    is blind) or a sum that nearly cancels (CLIP's logit scale near
    uniform logits: 4.4e-5 with an error of 4.0e-8 at B=4, against a
    largest |grad| of 6.0e-3). Returns the worst error over the tensor's
    largest |grad|."""
    floor = 1e-5 * max(float(g.abs().max()) for g in cpu_grads.values())
    worst = 0.0
    for name, ref in cpu_grads.items():
        got = card_grads[name]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if not np.isfinite(err) or err > rel * scale + floor:
            fail(f"{label}: gradient of {name} differs from the CPU's by "
                 f"{err:.3e} (largest |grad| {scale:.3e}, tolerance "
                 f"{rel} x that + {floor:.3e})")
        if scale > floor:
            worst = max(worst, err / scale)
    return worst


def hold_train_step(cfg, params: dict, label: str, card: str) -> None:
    """One contrastive step in f32 at HOLD_B pairs x HOLD_S tokens and the
    model's full width, on the card and on the port's CPU path, same
    weights and batch: the losses and every gradient tensor."""
    import dataclasses

    import torch

    from pathway_tpu_torch.models.train import (contrastive_train_step,
                                                init_train_state)

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batch = train_batch(HOLD_B, HOLD_S, cfg.vocab_size, seed=11)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = init_train_state(0, cfg32, params=params, device=dev)
        state, loss = contrastive_train_step(state, batch)
        runs[dev] = (float(loss), {n: p.grad.detach().cpu() for n, p in
                                   state.model.named_parameters()},
                     time.perf_counter() - t0)
        del state
    (l_gpu, g_gpu, _), (l_cpu, g_cpu, cpu_s) = runs["cuda"], runs["cpu"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = hold_grads(g_gpu, g_cpu, label, 1e-3)
    print(f"[{label}] f32 step at B={HOLD_B} S={HOLD_S}, card vs the port's "
          f"CPU path: loss {l_gpu:.7f} vs {l_cpu:.7f} (rel {rel:.2e}, "
          f"tolerance 1e-4); {len(g_cpu)} gradient tensors, worst max|err| "
          f"/ max|grad| {worst:.2e} (tolerance 1e-3, floor 1e-5 x the "
          f"largest |grad|); CPU step {cpu_s:.1f} s"
          f" (host) [{card}]", flush=True)
    if not np.isfinite(l_gpu) or rel > 1e-4:
        fail(f"{label}: the card's f32 loss differs from the CPU's")


def timed_steps(step, n_warm: int, n_steps: int) -> tuple[list, list, float]:
    """``step() -> loss tensor`` n_warm + n_steps times, each timed by
    CUDA events; the losses are read after the last step. Returns (losses,
    step ms of the timed steps, host wall ms a timed step)."""
    import torch

    losses, ms = [], []
    for _ in range(n_warm):
        losses.append(step())
    torch.cuda.synchronize()
    events = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step())
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    ms = [s.elapsed_time(e) for s, e in events]
    return [float(x) for x in losses], ms, wall_ms


def profile_step(step, label: str, card: str, reps: int = 2) -> None:
    """torch.profiler over ``reps`` training steps: device time by kernel
    group (GEMM, the optimizer's multi-tensor kernels, the rest) and the
    kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        print(f"[{label}] torch.profiler recorded no device time",
              flush=True)
        return
    groups = {"GEMM": 0.0, "optimizer": 0.0, "other": 0.0}
    for e in events:
        name = e.key.lower()
        g = ("GEMM" if any(t in name for t in ("gemm", "xmma", "cutlass",
                                               "nvjet"))
             else "optimizer" if "multi_tensor" in name or "adam" in name
             else "other")
        groups[g] += e.self_device_time_total / reps / 1e3
    busy = sum(groups.values())
    print(f"[{label}] a step under torch.profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%): "
          + ", ".join(f"{g} {v:.2f} ms" for g, v in groups.items())
          + f" [{card}]", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[{label}]   {e.self_device_time_total / reps / 1e3:8.3f} ms"
              f" x{e.count // reps:<4d} {e.key[:90]}", flush=True)


def hold_losses(losses: list, label: str) -> None:
    if not np.all(np.isfinite(losses)):
        fail(f"{label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: first {losses[0]:.6f}, last "
             f"{losses[-1]:.6f}")


def train_run(cfg, params: dict, steps: int, label: str, card: str,
              flops_cfg=None) -> float:
    """bf16 contrastive training on one fixed batch of TRAIN_PAIRS pairs x
    TRAIN_SEQ tokens, AdamW at the JAX package's defaults: TRAIN_WARM
    warm-up steps, then ``steps`` timed ones. Returns the step p50 (ms)."""
    import torch

    from pathway_tpu_torch.models.encoder import encoder_cost
    from pathway_tpu_torch.models.train import (as_batch,
                                                contrastive_train_step,
                                                init_train_state)

    state = init_train_state(0, cfg, params=params, device="cuda")
    batch = as_batch(train_batch(TRAIN_PAIRS, TRAIN_SEQ, cfg.vocab_size,
                                 seed=12), next(state.model.parameters())
                     .device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        return contrastive_train_step(state, batch)[1]

    losses, ms, wall_ms = timed_steps(step, TRAIN_WARM, steps)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hold_losses(losses, label)
    p50, p90 = np.percentile(ms, 50), np.percentile(ms, 90)
    fwd, _ = encoder_cost(flops_cfg or cfg, 2 * TRAIN_PAIRS, TRAIN_SEQ)
    flops = 3 * fwd
    tokens = 2 * TRAIN_PAIRS * TRAIN_SEQ
    print(f"[{label}] bf16 AdamW steps on one batch of {TRAIN_PAIRS} pairs x"
          f" {TRAIN_SEQ} tokens a side: step p50 {p50:.3f} ms p90 "
          f"{p90:.3f} ms (CUDA events, {steps} steps after {TRAIN_WARM} "
          f"warm-up), host wall {wall_ms:.3f} ms a step; "
          f"{TRAIN_PAIRS / p50 * 1e3:.1f} pairs/s, {tokens / p50 * 1e3:.1f} "
          f"tokens/s (padded); {flops / p50 / 1e9:.1f} TFLOP/s counting 3 x "
          f"encoder_cost({2 * TRAIN_PAIRS}, {TRAIN_SEQ}) = "
          f"{flops / 1e12:.3f} TFLOP a step; peak device memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[{label}] losses: first {losses[0]:.6f}, after warm-up "
          f"{losses[TRAIN_WARM]:.6f}, last {losses[-1]:.6f}, all "
          f"{len(losses)} finite [{card}]", flush=True)
    profile_step(step, label, card)
    return float(p50)


def phase_train(seed: int, card: str) -> float:
    """Contrastive fine-tuning of BGE-small: the f32 step on the card
    against the CPU, then bf16 training steps. Returns the step p50."""
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)

    cfg = EncoderConfig.bge_small()
    params = init_params_host(seed, cfg)
    hold_train_step(cfg, params, "train", card)
    return train_run(cfg, params, TRAIN_STEPS, "train", card)


# the training half of parallel/ (phase_parallel), on meshes of cuda:0
PAR_B, PAR_S = 8, 512   # sequences of BGE's max length
PAR_RING_SHARDS = 4     # ring over a data axis of 4
PAR_ULYSSES_SHARDS = 2  # BGE-small's 6 heads: 2 or 3 divide, 512 % 3 != 0
PIPE_STAGES, PIPE_MICRO = 4, 8     # 12 layers, 3 a stage; 8 micro-batches
PIPE_MB, PIPE_SEQ = 8, 128         # of 8 x 128 tokens
SHARDED_DATA, SHARDED_MODEL = 2, 2
SHARDED_STEPS = 5       # bf16 steps timed, after one warm-up step


def hold_sequence_parallel(card: str) -> None:
    """Ring attention over a data axis of 4 and Ulysses over 2, at
    BGE-small's heads and head width, B=8, S=512, f32 and bf16, causal
    and not, against ``reference_attention`` on the card, with times."""
    import torch

    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from pathway_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention, ulysses_attention)

    cfg = EncoderConfig.bge_small()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    shape = (PAR_B, PAR_S, cfg.heads, cfg.head_dim)
    # bf16: |out| < 4, two bf16 steps there (the ring rounds unnormalised
    # probabilities, the reference normalised ones)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2 ** -5)):
        q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        for label, fn, n in (("ring", ring_attention, PAR_RING_SHARDS),
                             ("ulysses", ulysses_attention,
                              PAR_ULYSSES_SHARDS)):
            mesh = make_mesh(MeshConfig(data=n), devices=[dev] * n)
            for causal in (False, True):
                ref = reference_attention(q, k, v, causal=causal)
                out = fn(q, k, v, mesh=mesh, causal=causal)
                err = float((out.float() - ref.float()).abs().max())
                peak = float(ref.float().abs().max())
                ms = cuda_ms(lambda: fn(q, k, v, mesh=mesh, causal=causal),
                             10)
                ref_ms = cuda_ms(lambda: reference_attention(
                    q, k, v, causal=causal), 10)
                name = str(dtype).replace("torch.", "")
                print(f"[parallel] {label} over {n} shards of cuda:0, "
                      f"{name}, causal={causal}, (B, S, H, D) = {shape}: "
                      f"max|err| {err:.3e} against reference_attention "
                      f"(tolerance {tol:.3e}, max|out| {peak:.3f}); "
                      f"{ms:.4f} ms a call, reference {ref_ms:.4f} ms "
                      f"(CUDA events) [{card}]", flush=True)
                if not np.isfinite(err) or err > tol or \
                        out.shape != ref.shape or out.dtype != dtype:
                    fail(f"[parallel] {label} {name} causal={causal}: "
                         f"max|err| {err:.3e} > {tol:.3e}")


def hold_pipeline(seed: int, card: str) -> None:
    """BGE-small's 12 blocks over a 4-stage pipe mesh of cuda:0, 8
    micro-batches of 8 x 128 tokens, bf16, against the port's sequential
    blocks on the card (bit for bit), with times."""
    import torch

    from pathway_tpu_torch.models.convert import tree_map
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.parallel.mesh import Mesh
    from pathway_tpu_torch.parallel.pipeline import (
        pipeline_encoder_blocks, sequential_encoder_blocks,
        stack_stage_params)

    cfg = EncoderConfig.bge_small()
    dev = torch.device("cuda")
    params = init_params_host(seed, cfg)
    stacked = tree_map(lambda t: t.to(dev),
                       stack_stage_params(params["layers"]))
    layers = tree_map(lambda a: torch.from_numpy(a).to(dev),
                      params["layers"])
    run = pipeline_encoder_blocks(Mesh([dev] * PIPE_STAGES, ("pipe",)), cfg)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.hidden), device=dev,
                    generator=gen)
    lens = torch.randint(16, PIPE_SEQ + 1, (PIPE_MB,), device=dev,
                         generator=gen)
    mask = torch.arange(PIPE_SEQ, device=dev)[None, :] < lens[:, None]

    def sequential():
        return torch.stack([sequential_encoder_blocks(layers, x[i], mask, cfg)
                            for i in range(PIPE_MICRO)])

    out, seq = run(stacked, x, mask), sequential()
    same = torch.equal(out, seq)
    # host-bound: timed in turns, pipeline, sequential, sequential, pipeline
    ms = {"pipeline": [], "sequential": []}
    for name in ("pipeline", "sequential", "sequential", "pipeline"):
        ms[name].append(cuda_ms(sequential if name == "sequential" else
                                (lambda: run(stacked, x, mask)), 3))
    bubble = (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1)
    print(f"[parallel] pipeline: {cfg.layers} layers over {PIPE_STAGES} "
          f"stages of cuda:0 ({cfg.layers // PIPE_STAGES} each), "
          f"{PIPE_MICRO} micro-batches of {PIPE_MB} x {PIPE_SEQ} tokens, "
          f"bf16: {out.dtype}, equal to the sequential blocks bit for bit: "
          f"{same}; a run {ms['pipeline'][0]:.3f} / {ms['pipeline'][1]:.3f}"
          f" ms, sequential {ms['sequential'][0]:.3f} / "
          f"{ms['sequential'][1]:.3f} ms (CUDA events, in turns); bubble "
          f"(S-1)/(M+S-1) = {PIPE_STAGES - 1}/"
          f"{PIPE_MICRO + PIPE_STAGES - 1} = {bubble:.4f} of the stage-steps "
          f"(no micro-batch there: skipped) [{card}]", flush=True)
    if not same or not torch.isfinite(out.float()).all():
        fail("[parallel] pipeline: not equal to the sequential blocks")


def hold_sharded_step(seed: int, card: str, train_p50: float) -> None:
    """The sharded train step on a (data 2, model 2) mesh of cuda:0,
    dense and 4-expert MoE: one f32 step at HOLD_B x HOLD_S against the
    port's single-device step on the card from the same weights, then
    bf16 steps at TRAIN_PAIRS x TRAIN_SEQ."""
    import dataclasses

    import torch

    from pathway_tpu_torch.models.convert import params_from_jax
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.models.train import (as_batch,
                                                contrastive_train_step,
                                                init_sharded_train_state,
                                                init_train_state,
                                                make_sharded_train_step)
    from pathway_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh(MeshConfig(data=SHARDED_DATA, model=SHARDED_MODEL),
                     devices=[dev] * (SHARDED_DATA * SHARDED_MODEL))
    shape = f"(data {SHARDED_DATA}, model {SHARDED_MODEL}) mesh of cuda:0"
    for experts in (0, MOE_EXPERTS):
        cfg = EncoderConfig.bge_small(num_experts=experts)
        label = f"[parallel] sharded step, {experts or 'no'} experts"
        t0 = time.perf_counter()
        params = init_params_host(seed, cfg)
        t_params = time.perf_counter() - t0
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        batch = train_batch(HOLD_B, HOLD_S, cfg.vocab_size, seed=11)
        single = init_train_state(0, cfg32, params=params, device=dev)
        single, l_single = contrastive_train_step(single, batch)
        g_single = {n: p.grad.detach().cpu()
                    for n, p in single.model.named_parameters()}
        del single
        state = init_sharded_train_state(0, mesh, cfg32, params=params)
        step_fn, _, _ = make_sharded_train_step(mesh, cfg32)
        state, l_sharded = step_fn(state, batch)
        l_single, l_sharded = float(l_single), float(l_sharded)
        rel = abs(l_sharded - l_single) / abs(l_single)
        worst = hold_grads(params_from_jax(state.gather("grads")), g_single,
                           label, 1e-3)
        print(f"{label}: f32 at B={HOLD_B} S={HOLD_S} on a {shape} against "
              f"the single-device step on the card: loss {l_sharded:.7f} vs "
              f"{l_single:.7f} (rel {rel:.2e}, tolerance 1e-4); "
              f"{len(g_single)} gradient tensors, worst max|err| / "
              f"max|grad| {worst:.2e} (tolerance 1e-3, floor 1e-5 x the "
              f"largest |grad|); weights drawn in {t_params:.1f} s, the two "
              f"f32 steps {time.perf_counter() - t0 - t_params:.1f} s "
              f"(host) [{card}]", flush=True)
        if not np.isfinite(l_sharded) or rel > 1e-4:
            fail(f"{label}: the sharded f32 loss differs from the "
                 f"single-device step's")
        del state
        t0 = time.perf_counter()
        state = init_sharded_train_state(0, mesh, cfg, params=params)
        step_fn, _, _ = make_sharded_train_step(mesh, cfg)
        b = as_batch(train_batch(TRAIN_PAIRS, TRAIN_SEQ, cfg.vocab_size,
                                 seed=12), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, wall_ms = timed_steps(lambda: step_fn(state, b)[1], 1,
                                          SHARDED_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        hold_losses(losses, label)
        beside = (f", [train]'s single-device p50 {train_p50:.3f} ms"
                  if not experts else "")
        print(f"{label}: bf16 AdamW on a {shape}, one batch of {TRAIN_PAIRS} "
              f"pairs x {TRAIN_SEQ} tokens a side: step p50 "
              f"{np.percentile(ms, 50):.3f} ms, max {max(ms):.3f} ms (CUDA "
              f"events, {SHARDED_STEPS} steps after 1 warm-up){beside}; host "
              f"wall {wall_ms:.3f} ms a step; peak device memory "
              f"{peak_gb:.2f} GiB; losses {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}; {time.perf_counter() - t0:.1f} s with the "
              f"state's placement (host) [{card}]", flush=True)
        if not experts:  # where the dense step's time goes (one step:
            # the profiler's summary of ~10^4 host ops a step is slow)
            profile_step(lambda: step_fn(state, b)[1], "parallel", card,
                         reps=1)
        del state
        gc.collect()
        torch.cuda.empty_cache()


def phase_parallel(seed: int, card: str, train_p50: float) -> None:
    """The training half of parallel/ at BGE-small's width, on meshes of
    cuda:0: sequence-parallel attention, the GPipe pipeline, the sharded
    train step. No hand-written kernel is on these paths (they are the
    JAX package's dense attention and einsums): every launch count must
    stay 0."""
    from pathway_tpu_torch.ops.attention import ATTENTION
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    t0 = time.perf_counter()
    for count in LAUNCH_COUNTS:
        count.launches = 0
    parts = []
    for part, run in (("ring/ulysses", lambda: hold_sequence_parallel(card)),
                      ("pipeline", lambda: hold_pipeline(seed, card)),
                      ("sharded step", lambda: hold_sharded_step(
                          seed, card, train_p50))):
        t1 = time.perf_counter()
        run()
        parts.append(f"{part} {time.perf_counter() - t1:.1f} s")
    launched = {c.name: c.launches for c in LAUNCH_COUNTS if c.launches}
    print(f"[parallel] K1 launches {ATTENTION.launches} (the path is dense "
          f"attention); phase {time.perf_counter() - t0:.1f} s ("
          f"{', '.join(parts)}) [{card}]",
          flush=True)
    if launched:
        fail(f"[parallel] kernels launched on the parallel paths: "
             f"{launched}")


def routed(forward) -> tuple:
    """``forward()``'s result and each MoE layer's top-1 expert per token
    (``models.encoder._moe_route`` recorded while it runs)."""
    from pathway_tpu_torch.models import encoder

    tops, route = [], encoder._moe_route

    def record(x, router):
        gates, top = route(x, router)
        tops.append(top)
        return gates, top

    encoder._moe_route = record
    try:
        return forward(), tops
    finally:
        encoder._moe_route = route


def phase_moe(seed: int, card: str) -> tuple[int, int]:
    """BGE-small's width with a 4-expert switch MoE in every layer:
    serving (padded, into a bf16 index; ragged, one chunk through path 2's
    graphed step), then training. Returns the launches of K1 in the
    serving run and of K1 with segment ids in the ragged chunk."""
    import dataclasses

    import torch

    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig,
                                                  encode, init_params_host)
    from pathway_tpu_torch.ops.attention import (ATTENTION,
                                                 attention_reference)
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex)
    from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                                   score_float_reference)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.bge_small(num_experts=MOE_EXPERTS)
    params = init_params_host(seed, cfg)
    emb = EncoderEmbedder(config=cfg, params=params, device="cuda")
    index = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
        cfg.hidden, reserved_space=MOE_DOCS + 64, dtype="bfloat16",
        device="cuda"))
    docs = make_docs(MOE_DOCS, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dup_ids = sorted(rng.choice(MOE_DOCS, size=MOE_QUERIES // 2,
                                replace=False).tolist())
    queries = [docs[i] for i in dup_ids] + make_docs(MOE_QUERIES // 2,
                                                     seed=seed + 1)
    ids, lens = emb.pack_tokens(docs[:INGEST_BATCH])
    fwd_ms = cuda_ms(lambda: emb.device_producer(emb.model, ids, lens), 10)

    # the counted run: ingest, then single-query searches
    ATTENTION.launches = 0
    emb.dispatches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b0 in range(0, MOE_DOCS, INGEST_BATCH):
        sl = range(b0, min(b0 + INGEST_BATCH, MOE_DOCS))
        index.add_batch([Pointer(i) for i in sl], [docs[i] for i in sl])
    index.drain()
    ingest_s = time.perf_counter() - t0
    index.search([(Pointer(10**9), queries[0], 10, None)])  # warm-up
    lat_ms, results = [], []
    for qi, text in enumerate(queries):
        t1 = time.perf_counter()
        results.append(index.search([(Pointer(10**9 + qi), text, 10,
                                      None)])[0])
        lat_ms.append((time.perf_counter() - t1) * 1e3)
    launches, dispatches = ATTENTION.launches, emb.dispatches
    print(f"[moe] serving, padded embedder into a bf16 index: {MOE_DOCS} "
          f"docs in {ingest_s:.2f} s, {MOE_DOCS / ingest_s:.1f} docs/s; "
          f"forward per {INGEST_BATCH}-doc batch at width {ids.shape[1]} "
          f"{fwd_ms:.2f} ms (CUDA events); query p50 "
          f"{np.percentile(lat_ms, 50):.3f} ms over {len(queries)} "
          f"single-query searches; K1 launches {launches}, encoder "
          f"dispatches {dispatches} (x{N_LAYERS} = {N_LAYERS * dispatches})"
          f" [{card}]", flush=True)
    if len(index) != MOE_DOCS:
        fail(f"MoE index holds {len(index)} docs, expected {MOE_DOCS}")
    if dispatches == 0 or launches != N_LAYERS * dispatches:
        fail("K1 did not run on every layer of the MoE encoder")
    # every top 10 against a plain scan of the index's rows with the
    # queries' embeddings (B=1, as the search embeds them)
    inner = index.inner
    exts = [e for e in inner._pool.extents if e.established]
    rows = torch.cat([e.vectors for e in exts]).float()
    valid = torch.cat([e.valid for e in exts])
    base = np.concatenate([e.base + np.arange(e.rows) for e in exts])
    keys_of = np.array([int(inner._slot_to_key.get(int(s), -1))
                        for s in base])
    qv = torch.from_numpy(np.stack([emb.embed_batch([t])[0]
                                    for t in queries])).to(emb.device)
    qv = qv.to(torch.bfloat16).float()
    rank1 = check_top10(results, score_float_reference(
        qv, rows, valid, inner.metric.value), keys_of, "moe")
    # a copy's B=1 embedding against its document's row, embedded in a
    # batch of 512 (bf16 in the index)
    slot = {int(k): j for j, k in enumerate(keys_of)}
    copy_rows = rows[[slot[d] for d in dup_ids]]
    cos_copy = torch.nn.functional.cosine_similarity(
        qv[:len(dup_ids)].double(), copy_rows.double())
    found = sum(d in [int(k) for k, _ in results[qi]]
                for qi, d in enumerate(dup_ids))
    print(f"[moe] top-10 vs a plain scan of the index's rows: all "
          f"{len(queries)} queries pass, rank 1 identical on {rank1}; "
          f"copies: B=1 query embedding vs the document's row, min cosine "
          f"{float(cos_copy.min()):.6f} (required >= 0.99), "
          f"{found}/{len(dup_ids)} find their document in the top 10 "
          f"[{card}]", flush=True)
    if not float(cos_copy.min()) >= 0.99:
        fail("MoE: a copy's B=1 embedding disagrees with its document's")

    # K1 against the plain attention on the same documents and weights,
    # in bf16 (the served model) and in f32; and how many token-layers the
    # top-1 router sends to another expert between the two
    held = docs[:MOE_HELD]
    ids, lens = emb.pack_tokens(held)
    dev = emb.device
    ids_d = torch.from_numpy(ids).to(dev).long()
    mask = torch.arange(ids.shape[1], device=dev)[None, :] < \
        torch.from_numpy(lens).to(dev)[:, None]
    model32 = Encoder.from_params(params, dataclasses.replace(
        cfg, compute_dtype=torch.float32), device="cuda")
    holds = {}
    for dtype, model in (("bf16", emb.model), ("f32", model32)):
        got, k1_tops = routed(lambda: encode(model, ids_d, mask))
        ref, ref_tops = routed(lambda: encode(model, ids_d, mask,
                                              attn_fn=attention_reference))
        cos = float(torch.nn.functional.cosine_similarity(
            got.double(), ref.double()).min())
        flips = sum(int(((a != b) & mask).sum())
                    for a, b in zip(k1_tops, ref_tops))
        holds[dtype] = (cos, flips, bool(torch.isfinite(got).all()))
    n_tok = int(mask.sum()) * cfg.layers
    print(f"[moe] {MOE_HELD} docs' embeddings, K1 vs attention_reference on "
          f"the card: bf16 min row cosine {holds['bf16'][0]:.6f} (required "
          f">= 0.99), {holds['bf16'][1]} of {n_tok} token-layers routed to "
          f"another expert; f32 min row cosine {holds['f32'][0]:.7f} "
          f"(required >= 0.9999), {holds['f32'][1]} routed elsewhere "
          f"[{card}]", flush=True)
    # top-1 routing turns bf16 rounding into a discrete change of expert
    # for near-tied tokens: the bf16 hold is looser than the dense
    # encoder's 0.999, the f32 one (rounding 2^16 times finer) is not
    if not (holds["bf16"][2] and holds["f32"][2]) \
            or holds["bf16"][0] < 0.99 or holds["f32"][0] < 0.9999:
        fail("MoE embeddings through K1 disagree with the plain attention")
    del model32

    # ragged: one chunk through path 2's graphed step, graphs captured in
    # a warm-up first
    remb = EncoderEmbedder(config=cfg, params=params, ragged=True,
                           device="cuda")
    rindex = DeviceEmbeddingKnnIndex(remb, BruteForceKnnIndex(
        cfg.hidden, reserved_space=MOE_DOCS + 64, dtype="int8",
        metric="cos", device="cuda"))
    warm = docs[:INGEST_BATCH]
    rindex.add_batch([Pointer(i) for i in range(len(warm))], warm)
    rindex.drain()
    step = rindex._fused.step
    # one full chunk: make_docs' documents are WORDS_PER_DOC + 2 tokens
    n_chunk = remb._ragged_max_seqs * (remb.max_len // (WORDS_PER_DOC + 2))
    window = docs[INGEST_BATCH:INGEST_BATCH + n_chunk]
    if len(remb.pack_ragged(window)) != 1:
        fail("the ragged window is not one chunk")
    captures, replays = step.captures, step.replays
    ATTENTION.launches = QUANTIZE_SCATTER.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rindex.add_batch([Pointer(INGEST_BATCH + i) for i in range(n_chunk)],
                     window)
    rindex.drain()
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    seg_launches, k4 = ATTENTION.launches, QUANTIZE_SCATTER.launches
    new_captures = step.captures - captures
    print(f"[moe] ragged: one chunk of {n_chunk} docs through path 2's "
          f"graphed step in {chunk_ms:.2f} ms (host, add_batch + drain): "
          f"{step.replays - replays} replay, {new_captures} graphs captured "
          f"in the window, K1 (segment ids) launches {seg_launches}, K4 "
          f"{k4} [{card}]", flush=True)
    if new_captures != 0 or step.replays - replays != 1:
        fail("the ragged MoE chunk did not run as one replay of a graph "
             "captured before the window")
    if seg_launches != N_LAYERS or k4 != 1:
        fail("the ragged MoE chunk did not launch K1 on every layer and K4")
    a = remb.embed_batch(docs[:16]).astype(np.float64)
    b = emb.embed_batch(docs[:16]).astype(np.float64)
    rcos = np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1))
    # bf16 on both sides, other attention kernels: the routing caveat of
    # the K1 hold above applies
    print(f"[moe] ragged vs padded embeddings of 16 docs: min row cosine "
          f"{rcos.min():.6f} (required >= 0.99) [{card}]", flush=True)
    if not np.all(np.isfinite(a)) or rcos.min() < 0.99:
        fail("ragged MoE embeddings disagree with padded ones")
    del index, rindex, emb, remb

    hold_train_step(cfg, params, "moe train", card)
    # the dense dispatch runs every expert on every token: E MLPs' work
    train_run(cfg, params, MOE_STEPS, "moe train", card,
              flops_cfg=dataclasses.replace(
                  cfg, intermediate=cfg.intermediate * MOE_EXPERTS))
    return launches, seg_launches


def phase_clip(seed: int, card: str) -> None:
    """The CLIP dual encoder at ClipConfig(): ClipEmbedder over seeded
    images (ndarrays) and texts, the f32 towers, loss and gradients on the
    card against the CPU, then Adam steps."""
    import dataclasses

    import torch

    from pathway_tpu_torch.models import clip
    from pathway_tpu_torch.xpacks.llm.embedders import ClipEmbedder

    cfg = clip.ClipConfig()
    size = cfg.image_size
    rng = np.random.default_rng(seed + 3)
    images = list(rng.random((CLIP_ITEMS, size, size, cfg.channels),
                             dtype=np.float32))
    texts = make_docs(CLIP_ITEMS, seed=seed + 3)
    emb = ClipEmbedder(config=cfg, seed=seed, device="cuda")
    rates = {}
    for kind, fn, items in (("images", emb.embed_image_batch, images),
                            ("texts", emb.embed_text_batch, texts)):
        fn(items)  # warm-up at the timed shape
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(items)
            walls.append(time.perf_counter() - t0)
        if out.shape != (CLIP_ITEMS, cfg.embed_dim) \
                or not np.all(np.isfinite(out)) \
                or np.abs(np.linalg.norm(out, axis=1) - 1).max() > 1e-3:
            fail(f"CLIP {kind}: not {CLIP_ITEMS} finite unit rows")
        rates[kind] = CLIP_ITEMS / float(np.median(walls))
    print(f"[clip] ClipEmbedder, {CLIP_ITEMS} images of {size}x{size} "
          f"({cfg.n_patches} patches): {rates['images']:.1f} images/s; "
          f"{CLIP_ITEMS} texts: {rates['texts']:.1f} texts/s (host wall, "
          f"median of 3, batch of {CLIP_ITEMS}) [{card}]", flush=True)
    del emb

    # f32 towers, loss and gradients: the card against the port's CPU path
    cfg32 = dataclasses.replace(
        cfg, compute_dtype=torch.float32,
        text=dataclasses.replace(cfg.text, compute_dtype=torch.float32))
    params = clip.init_clip_params(seed, cfg32)
    hb = clip_batch(cfg32, CLIP_HOLD_B, seed=13)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = clip.ClipModel.from_params(params, cfg32, device=dev,
                                           trainable=True)
        b = {k: torch.as_tensor(v).to(model.vision_proj.device)
             for k, v in hb.items()}
        b["ids"], b["mask"] = b["ids"].long(), b["mask"].bool()
        img = clip.encode_image(model, b["pixels"])
        txt = clip.encode_text(model, b["ids"], b["mask"])
        loss = clip.clip_loss(model, b)
        loss.backward()
        runs[dev] = (img.detach().cpu(), txt.detach().cpu(),
                     float(loss.detach()),
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})
        del model
    (gi, gt, gl, gg), (ci, ct, cl, cg) = runs["cuda"], runs["cpu"]
    err = max(float((gi - ci).abs().max()), float((gt - ct).abs().max()))
    rel = abs(gl - cl) / abs(cl)
    worst = hold_grads(gg, cg, "clip", 1e-3)
    print(f"[clip] f32 at B={CLIP_HOLD_B}, card vs the port's CPU path: "
          f"tower outputs max_abs_err {err:.2e} (tolerance 1e-4, unit "
          f"rows), clip_loss {gl:.7f} vs {cl:.7f} (rel {rel:.2e}, tolerance"
          f" 1e-4), {len(cg)} gradient tensors, worst max|err| / max|grad| "
          f"{worst:.2e} (tolerance 1e-3, floor 1e-5 x the largest |grad|) "
          f"[{card}]", flush=True)
    if not err <= 1e-4 or not rel <= 1e-4:
        fail("CLIP's f32 towers or loss on the card disagree with the CPU")

    # Adam steps at B=64 in bf16 on one fixed batch
    params = clip.init_clip_params(seed, cfg)
    model = clip.ClipModel.from_params(params, cfg, device="cuda",
                                       trainable=True)
    opt = clip.make_clip_optimizer(CLIP_LR)(model.parameters())
    batch = clip_batch(cfg, CLIP_TRAIN_B, seed=14)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    def step():
        return clip.clip_train_step(model, opt, batch)[2]

    losses, ms, wall_ms = timed_steps(step, 0, CLIP_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hold_losses(losses, "clip train")
    print(f"[clip] {CLIP_STEPS} bf16 clip_train_steps (Adam {CLIP_LR}) at "
          f"B={CLIP_TRAIN_B}: step p50 {np.percentile(ms, 50):.3f} ms "
          f"(CUDA events; the first step and the batch's upload included), "
          f"host wall {wall_ms:.3f} ms a step; loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} (chance, log B: {np.log(CLIP_TRAIN_B):.6f}), "
          f"all finite; peak device memory {peak_gb:.2f} GiB [{card}]",
          flush=True)
    profile_step(step, "clip train", card)


def clip_batch(cfg, B: int, seed: int) -> dict:
    """B image/text pairs from the seed, shaped like tests/test_clip.py's:
    image i is noise in [0, 0.15) with cell i of a square grid lit (+0.8)
    (uniform noise alone averages to the same patch mean in every image),
    text i a caption of 8 words of its own through the text tower's
    HashTokenizer."""
    from pathway_tpu_torch.models.tokenizer import HashTokenizer

    rng = np.random.default_rng(seed)
    size = cfg.image_size
    grid = int(np.ceil(np.sqrt(B)))
    cell = size // grid
    px = rng.uniform(0, 0.15, (B, size, size, cfg.channels)
                     ).astype(np.float32)
    for i in range(B):
        r, c = divmod(i, grid)
        px[i, r * cell:(r + 1) * cell, c * cell:(c + 1) * cell] += 0.8
    words = rng.permutation(4096)[:8 * B].reshape(B, 8)
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size,
                        max_len=cfg.text.max_len)
    ids, mask = tok.batch([" ".join(f"word{w}" for w in row)
                           for row in words])
    return {"pixels": px, "ids": ids, "mask": mask}


ML_DIM = 384             # BGE-small's width
KMEANS_N = 262_144       # points (402 MB of float32)
KMEANS_K = 1024          # centres, one a blob
KMEANS_ITERS = 25        # kmeans_labels' default
KMEANS_AGREE = 0.999     # labels shared with the float64 Lloyd run
LSH_N = 20_000           # clustering_via_lsh's vectors
LSH_BLOBS = 64           # ... drawn from 64 blobs, clustered into k = 64
LSH_QUERIES = 128        # the bucketed classifier's queries
LSH_L, LSH_M, LSH_A = 8, 3, 0.5  # bands, projections a band, bucket width
# the classifier's projections a band: at M = 3 a query's bands hold
# ~1,100 candidates (most from other blobs), at 4 ~300 (its host time
# is the candidate pairs)
CLASSIFY_M = 4
LSH_SPREAD = 0.1         # the LSH blobs' spread around their centres


def ml_blobs(n: int, k: int, spread: float, seed: int) -> tuple:
    """(points (n, 384) f32, weights 1-4 f32, blob ids): ``k`` centres
    from ``standard_normal``, each point a centre plus ``spread`` x noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, ML_DIM)).astype(np.float32)
    blob = rng.integers(0, k, n)
    pts = centers[blob]
    pts += spread * rng.standard_normal((n, ML_DIM), dtype=np.float32)
    return pts, rng.integers(1, 5, n).astype(np.float32), blob


def kmeans_f64(pts, w, init, iters: int):
    """A plain weighted Lloyd run in float64 on the card, from the same
    initial centres: argmin of ``|c|^2 - 2 P C^T`` (the row's |p|^2 does
    not move it), ``index_add_`` sums, empty clusters kept."""
    import torch

    p = pts.double()
    wd = w.double()
    c = p[init]
    k = c.shape[0]
    for step in range(iters + 1):
        assign = torch.argmin((c * c).sum(1)[None, :] - 2.0 * (p @ c.T),
                              dim=1)
        if step == iters:
            return assign
        wsum = torch.zeros_like(c).index_add_(0, assign, p * wd[:, None])
        wtot = torch.zeros(k, dtype=torch.float64,
                           device=p.device).index_add_(0, assign, wd)
        c = torch.where(wtot[:, None] > 0, wsum / wtot.clamp(min=1e-9)[:, None],
                        c)


def partition_scores(labels: np.ndarray, blob: np.ndarray) -> tuple:
    """(purity, normalized mutual information, blobs that are some
    cluster's majority) of a partition against the blobs."""
    lab = np.unique(labels, return_inverse=True)[1]
    bl = np.unique(blob, return_inverse=True)[1]
    table = np.zeros((lab.max() + 1, bl.max() + 1), np.int64)
    np.add.at(table, (lab, bl), 1)
    n = len(labels)
    purity = table.max(axis=1).sum() / n

    def entropy(counts):
        p = counts[counts > 0] / n
        return float(-(p * np.log(p)).sum())

    h_joint = entropy(table.ravel())
    mi = entropy(table.sum(1)) + entropy(table.sum(0)) - h_joint
    nmi = mi / np.sqrt(entropy(table.sum(1)) * entropy(table.sum(0)))
    return float(purity), float(nmi), len(set(table.argmax(axis=1)))


def plain_lsh_votes(bucketer, train, labels, queries, k: int) -> list:
    """The bucketed classifier's answer computed directly: a query's
    candidates are the training rows sharing one of its band codes; the
    k nearest by squared distance (float64; ties by label, as the
    classifier's sorted (distance, label) tuples), then the most frequent
    label (ties: the larger label string), None without candidates."""
    codes = np.stack([bucketer(v) for v in train])  # (n, L)
    index: dict = {}
    for i, row in enumerate(codes):
        for band, code in enumerate(row):
            index.setdefault((band, int(code)), []).append(i)
    out = []
    for q in queries:
        cand = sorted({i for band, code in enumerate(bucketer(q))
                       for i in index.get((band, int(code)), ())})
        if not cand:
            out.append(None)
            continue
        diff = train[cand].astype(np.float64) - q.astype(np.float64)
        ranked = sorted(zip((diff * diff).sum(1).tolist(),
                            [labels[i] for i in cand]))[:k]
        counts: dict = {}
        for _d, lbl in ranked:
            counts[lbl] = counts.get(lbl, 0) + 1
        out.append(max(counts.items(), key=lambda kv: (kv[1], str(kv[0])))[0])
    return out


def phase_ml(seed: int, card: str, kmeans_n: int = KMEANS_N,
             kmeans_k: int = KMEANS_K) -> None:
    """``pw.stdlib.ml`` on the card: ``kmeans_labels`` at ``kmeans_n`` x 384
    float32 points from ``kmeans_k`` seeded blobs (k = ``kmeans_k``, 25
    Lloyd steps, weights 1-4) held against a float64 Lloyd run from the
    same initial centres; ``clustering_via_lsh`` through the engine over
    20,000 x 384 vectors from 64 blobs (L = 8, M = 3, k = 64); the bucketed
    LSH classifier over the same vectors against a direct computation of
    its vote."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import device_sanitizer
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import run_tables
    from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from pathway_tpu_torch.stdlib.ml import classifiers
    from pathway_tpu_torch.stdlib.ml.classifiers import _clustering

    t_phase = time.perf_counter()
    dev = torch.device(card if card == "cpu" else "cuda")
    # -- k-means at BGE-small's width --------------------------------------
    pts, w, blob = ml_blobs(kmeans_n, kmeans_k, 0.25, seed + 11)
    for count in LAUNCH_COUNTS:
        count.launches = 0
    t0 = time.perf_counter()
    with device_sanitizer.count_syncs() as syncs:
        labels = np.asarray(classifiers.kmeans_labels(
            pts, w, kmeans_k, iters=KMEANS_ITERS, seed=seed, device=dev))
    wall = time.perf_counter() - t0
    if syncs.count:
        fail(f"[ml] kmeans_labels made {syncs.count} implicit host syncs")
    if any(c.launches for c in LAUNCH_COUNTS):
        fail("[ml] kmeans_labels launched a hand-written kernel")
    # the loop alone on the card, CUDA events, from the same initial centres
    n, k = len(pts), min(kmeans_k, len(pts))
    init = np.random.default_rng(seed).choice(
        n, size=k, replace=False, p=w / w.sum())
    pts_d = torch.from_numpy(pts).to(dev)
    w_d = torch.from_numpy(w).to(dev)
    init_d = torch.from_numpy(init.astype(np.int64)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        again = _clustering._kmeans_fn(pts_d, w_d, init_d, KMEANS_ITERS)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        loop_ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        again = _clustering._kmeans_fn(pts_d, w_d, init_d, KMEANS_ITERS)
        loop_ms = host_ms = (time.perf_counter() - t0) * 1e3
    same = float((again.cpu().numpy() == labels).mean())
    t0 = time.perf_counter()
    ref = kmeans_f64(pts_d, w_d, init_d, KMEANS_ITERS).cpu().numpy()
    ref_s = time.perf_counter() - t0
    agree = float((ref == labels).mean())
    purity, nmi, found = partition_scores(labels, blob)
    seeded = len(set(blob[init].tolist()))
    flops = (2 * KMEANS_ITERS + 1) * 2.0 * n * k * ML_DIM
    print(f"[ml] kmeans_labels {n} x {ML_DIM} f32, k={k}, "
          f"{KMEANS_ITERS} steps, {kmeans_k} blobs: wall {wall:.3f} s "
          f"(host packing, upload, loop, fetch); the loop {loop_ms:.2f} ms "
          f"of CUDA events ({flops / loop_ms / 1e9:.1f} TFLOP/s of f32 "
          f"products; host {host_ms:.2f} ms to queue it); "
          f"0 implicit syncs; {card}", flush=True)
    print(f"[ml] kmeans labels: {agree:.6f} equal to the float64 Lloyd run "
          f"on the card ({ref_s:.2f} s), {same:.6f} to a second run; "
          f"purity {purity:.4f}, NMI {nmi:.4f}, {found} of {kmeans_k} blobs "
          f"a cluster's majority ({seeded} held an initial centre)",
          flush=True)
    if agree < KMEANS_AGREE or same < KMEANS_AGREE:
        fail(f"[ml] kmeans labels agree with the float64 run on {agree:.6f} "
             f"of points and with a second run on {same:.6f} (< "
             f"{KMEANS_AGREE})")
    if nmi < 0.9 or found < 0.9 * seeded:
        fail(f"[ml] the partition does not recover the blobs: NMI {nmi:.4f} "
             f"(< 0.9), {found} blobs a majority of {seeded} seeded")
    del pts_d, w_d, init_d, again, pts
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- clustering_via_lsh through the engine -----------------------------
    vecs, _w, vblob = ml_blobs(LSH_N + LSH_QUERIES, LSH_BLOBS, LSH_SPREAD,
                               seed + 12)
    bucketer = classifiers.generate_euclidean_lsh_bucketer(
        ML_DIM, M=LSH_M, L=LSH_L, A=LSH_A, seed=seed)
    calls = []
    kmeans_fn = _clustering._kmeans_fn

    def counted(points, *args):
        calls.append((points.device.type, tuple(points.shape)))
        return kmeans_fn(points, *args)

    G.clear()
    data = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, idx=int),
        [(vecs[i], i) for i in range(LSH_N)])
    res = classifiers.clustering_via_lsh(data, bucketer, LSH_BLOBS,
                                         device=dev)
    out = res.select(res.label, idx=data.ix(res.id, context=res).idx)
    _clustering._kmeans_fn = counted
    try:
        t0 = time.perf_counter()
        [cap] = run_tables(out)
        cl_s = time.perf_counter() - t0
    finally:
        _clustering._kmeans_fn = kmeans_fn
    rows = list(cap.snapshot().values())
    idx = sorted(r[1] for r in rows)
    if idx != list(range(LSH_N)):
        fail(f"[ml] clustering_via_lsh labelled {len(rows)} rows, not each "
             f"of the {LSH_N} vectors once")
    if len(calls) != 1 or calls[0][0] != dev.type:
        fail(f"[ml] clustering_via_lsh's k-means ran as {calls}, not once "
             f"on {dev.type}")
    cl_labels = np.empty(LSH_N, np.int64)
    for lbl, i in rows:
        cl_labels[i] = lbl
    if cl_labels.min() < 0 or cl_labels.max() >= LSH_BLOBS:
        fail(f"[ml] clustering_via_lsh labels outside [0, {LSH_BLOBS})")
    c_purity, c_nmi, c_found = partition_scores(cl_labels, vblob[:LSH_N])
    print(f"[ml] clustering_via_lsh {LSH_N} x {ML_DIM} (L={LSH_L}, "
          f"M={LSH_M}, A={LSH_A}, k={LSH_BLOBS}, {LSH_BLOBS} blobs) under "
          f"run_tables: {cl_s:.2f} s, {LSH_N / cl_s:.1f} vectors/s; "
          f"{calls[0][1][0]} bucket representatives into k-means on "
          f"{calls[0][0]}; {len(set(cl_labels.tolist()))} clusters, purity "
          f"{c_purity:.4f}, NMI {c_nmi:.4f}, {c_found} blobs a majority",
          flush=True)
    if c_nmi < 0.8:
        fail(f"[ml] clustering_via_lsh's partition does not follow the "
             f"blobs: NMI {c_nmi:.4f} (< 0.8)")

    # -- the bucketed LSH classifier over the same vectors -----------------
    G.clear()
    names = [f"b{b}" for b in vblob]
    train = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, label=str),
        [(vecs[i], names[i]) for i in range(LSH_N)])
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, qi=int),
        [(vecs[LSH_N + j], j) for j in range(LSH_QUERIES)])
    classify = classifiers.knn_lsh_euclidean_classifier_train(
        train, d=ML_DIM, M=CLASSIFY_M, L=LSH_L, A=LSH_A)
    pred = classifiers.knn_lsh_classify(classify, queries, k=3)
    out = pred.select(pred.predicted_label,
                      qi=queries.ix(pred.id, context=pred).qi)
    t0 = time.perf_counter()
    [cap] = run_tables(out)
    cls_s = time.perf_counter() - t0
    got = [None] * LSH_QUERIES
    for lbl, qi in cap.snapshot().values():
        got[qi] = lbl
    # the classifier draws its own projections from the same seed
    plain = plain_lsh_votes(
        classifiers.generate_euclidean_lsh_bucketer(
            ML_DIM, M=CLASSIFY_M, L=LSH_L, A=LSH_A), vecs[:LSH_N], names,
        vecs[LSH_N:], 3)
    if got != plain:
        bad = sum(a != b for a, b in zip(got, plain))
        fail(f"[ml] the bucketed classifier's labels differ from the direct "
             f"vote on {bad} of {LSH_QUERIES} queries")
    acc = sum(g == names[LSH_N + j] for j, g in enumerate(got)) / LSH_QUERIES
    print(f"[ml] bucketed LSH classifier (d={ML_DIM}, M={CLASSIFY_M}, "
          f"L={LSH_L}, "
          f"A={LSH_A}, k=3) over the {LSH_N} vectors, {LSH_QUERIES} fresh "
          f"queries: {cls_s:.2f} s, accuracy {acc:.4f} against the blob "
          f"labels, every label equal to the direct vote", flush=True)
    if acc < 0.9:
        fail(f"[ml] the bucketed classifier's accuracy {acc:.4f} < 0.9")
    G.clear()
    print(f"[ml] phase {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)


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

    def done(what, graphs: bool = False):
        print(f"[time] {what} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        if graphs:  # the phase built Table graphs: the tier's counters
            autojit_line(what, reset=True)

    from pathway_tpu_torch.internals import autojit

    autojit.reset_stats()
    phase_etl(card)
    done("etl", graphs=True)
    phase_etl_windowed(card)
    done("etl windowed", graphs=True)
    phase_etl_sharded(card)
    done("etl sharded", graphs=True)

    k1 = phase_attention(card)
    k1_seg = phase_segments(card)
    k3, k4 = phase_knn_i8(card)
    k3_topk = phase_topk_i8(card)
    k2 = phase_topk_bf16(card)
    k2_score = phase_score_bf16(card)
    done("kernel phases")
    k1["launches_embed"], k2["launches_embed"] = phase_embed(card)
    done("embed")
    phase_warmup(args.seed, card)
    done("warmup")
    phase_loader(args.seed, card)
    done("loader")
    k1["launches"], k2["launches"], k2_score["launches"] = phase_slice(
        args.docs, args.seed, card)
    done("path 1")
    k1["launches_engine"], k1_seg["launches_engine"] = phase_engine(
        min(args.docs, FRAMEWORK_DOCS), args.seed, card)
    done("engine", graphs=True)
    fw = phase_framework(min(args.docs, FRAMEWORK_DOCS), args.seed, card)
    for rec, key in ((k1, (ATTENTION, False)), (k1_seg, (ATTENTION, True)),
                     (k2, TOPK_BF16), (k2_score, SCORE_BF16),
                     (k3_topk, TOPK_I8), (k3, SCORE_I8),
                     (k4, QUANTIZE_SCATTER)):
        rec["launches_framework"] = fw[key]
        rec["launches_profiler_live"] = fw.get(("profiled", key), 0)
    done("framework", graphs=True)
    sharded = phase_framework_sharded(args.docs, args.seed, card)
    k1["launches_sharded"], k2["launches_sharded"] = (sharded["k1"],
                                                      sharded["k2"])
    done("framework sharded", graphs=True)
    phase_autojit(card)
    done("autojit")
    c5 = phase_config5(args.seed, card)
    for rec, key in ((k1, ATTENTION), (k2, TOPK_BF16), (k2_score, SCORE_BF16),
                     (k3_topk, TOPK_I8)):
        rec["launches_config5"] = c5.get(key, 0)
    done("config 5", graphs=True)
    # graph B over SERVING_B_DOCS documents (cut from SERVING_N for the
    # script's clock: its statistics step is O(documents) a tick)
    served = [phase_serving_knn(card), phase_serving_rag(
        args.seed, card, n_docs=min(args.docs, SERVING_B_DOCS))]
    for rec, key in ((k1, ATTENTION), (k2, TOPK_BF16),
                     (k2_score, SCORE_BF16)):
        rec["launches_serving"] = sum(run[key] for run in served)
    done("serving", graphs=True)
    rag = phase_adaptive_rag(args.seed, card)
    k1["launches_adaptive_rag"], k2["launches_adaptive_rag"] = (
        rag[ATTENTION], rag[TOPK_BF16])
    k2_score["launches_adaptive_rag"] = rag[SCORE_BF16]  # filtered fetches
    done("adaptive rag", graphs=True)
    phase_knn_index(args.seed, card)
    gc.collect()  # graph B's and the RAG phase's indexes and encoders
    torch.cuda.empty_cache()
    done("knn index", graphs=True)
    rc = phase_result_cache(args.seed, card)
    for rec, key in ((k2, TOPK_BF16), (k3_topk, TOPK_I8),
                     (k4, QUANTIZE_SCATTER)):
        rec["launches_result_cache"] = rc.get(key, 0)
    done("result cache", graphs=True)
    paging = phase_paging(args.seed, card)
    for rec, key in ((k2, TOPK_BF16), (k3_topk, TOPK_I8),
                     (k4, QUANTIZE_SCATTER)):
        rec["launches_paging"] = paging.get(key, 0)
    gc.collect()
    torch.cuda.empty_cache()
    done("paging")
    phase_array_sum(args.seed, card)
    done("array_sum", graphs=True)
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
    sk = phase_sharded_knn(bf16_rows, card)
    for rec, key in ((k1, ATTENTION), (k2, TOPK_BF16), (k2_score, SCORE_BF16),
                     (k3_topk, TOPK_I8)):
        rec["launches_sharded_knn"] = sk["launches"][key]
    k2["sharded_knn"] = {k: v for k, v in sk.items() if k != "launches"}
    done("sharded knn")
    (k3_topk["launches"], _, _), k3_topk["probe_ms"], filt = phase_int8_10m(
        *bf16_rows, card)
    k3_topk["launches_path2"] = k3_topk_path2
    k3.update(filt)
    done("int8 10M index")
    phase_profile(card)
    gc.collect()  # the profiled embedders
    torch.cuda.empty_cache()
    train_p50 = phase_train(args.seed, card)
    done("train")
    phase_parallel(args.seed, card, train_p50)
    done("parallel")
    k1["launches_moe"], k1_seg["launches_moe"] = phase_moe(args.seed, card)
    done("moe")
    phase_clip(args.seed, card)
    done("clip")
    gc.collect()
    torch.cuda.empty_cache()
    phase_ml(args.seed, card)
    done("ml", graphs=True)
    # last: its 21 graphs leave ~200,000 memoized keys and twice the
    # objects the collector scans, which slowed the timed phases after it
    phase_temporal(card)
    done("temporal", graphs=True)
    print(json.dumps({"kernels": [k1, k1_seg, k2, k3_topk, k3, k4,
                                  k2_score]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
