"""Framework-neutral analytic cost model of pathway_tpu/engine/profiler.py:
(flops, bytes moved) per encoder forward and per KNN search, from shapes
alone, and the machine parameters they are read against
(``machine_params``: the card's peak rate and memory rate, shared by
bench-style MFU keys and ``chip_smoke.py``'s bounds). The live profiler
(sampling, dispatch records, gauges) is not ported yet (ROADMAP queue 1,
step 8).
"""

from __future__ import annotations

import os

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): dense bf16
# tensor-core rate without sparsity, and HBM3 bandwidth
H100_PEAK_TFLOPS = 989.0
H100_HBM_GBPS = 3350.0


def machine_params() -> dict:
    """{"peak_tflops", "hbm_gbps"} from the BENCH_PEAK_TFLOPS and
    BENCH_HBM_GBPS environment variables, defaulting to the H100 SXM's
    dense bf16 peak and HBM rate. Read on each call; an unparsable value
    falls back to the default."""
    try:
        peak = float(os.environ.get("BENCH_PEAK_TFLOPS",
                                    H100_PEAK_TFLOPS))
    except ValueError:
        peak = H100_PEAK_TFLOPS
    try:
        bw = float(os.environ.get("BENCH_HBM_GBPS", H100_HBM_GBPS))
    except ValueError:
        bw = H100_HBM_GBPS
    return {"peak_tflops": peak, "hbm_gbps": bw}


def machine_balance() -> float:
    """Machine balance in FLOP/byte: the arithmetic intensity at which the
    roofline's compute and bandwidth ceilings meet. A kernel whose
    intensity sits below it is bound by memory on this card."""
    mp = machine_params()
    return (mp["peak_tflops"] * 1e12) / (mp["hbm_gbps"] * 1e9)


def encoder_flops_per_token(hidden: int, intermediate: int, layers: int,
                            seq: int) -> float:
    """Forward FLOPs per token for the BERT-family encoder
    (models/encoder.py): 2*(non-embedding matmul params) per token —
    QKV + out-proj (4*h*h) and FFN up+down (2*h*f) per layer — plus the
    attention score/value term (4*S*h per token per layer; scores and
    weighted values are 2*S*h each). This is THE encoder FLOPs formula:
    bench.py's MFU and the profiler's cost model both call it."""
    per_layer = 2 * (4 * hidden * hidden + 2 * hidden * intermediate)
    attn = layers * 4 * seq * hidden
    return float(layers * per_layer + attn)


def encoder_cost(batch: int, seq: int, *, hidden: int, intermediate: int,
                 layers: int, vocab: int = 0,
                 param_bytes: int | None = None) -> tuple[float, float]:
    """(flops, bytes_moved) for one dense encoder forward of
    ``batch x seq`` tokens.

    Bytes: every non-embedding parameter is read once per dispatch
    (2 bytes, bf16 compute) plus the residual-stream activations
    traversing each layer boundary — ~4 reads + writes of the (B, S, H)
    bf16 stream per block (attention in/out, MLP in/out). The embedding
    gather reads one (H,) row per token. Deliberately first-order: the
    roofline verdict needs the right decade, not the exact coefficient.
    """
    flops = batch * seq * encoder_flops_per_token(hidden, intermediate,
                                                  layers, seq)
    if param_bytes is None:
        per_layer = 4 * hidden * hidden + 2 * hidden * intermediate
        param_bytes = 2 * layers * per_layer  # bf16 view of the matmul tree
    stream = 2 * batch * seq * hidden  # one bf16 (B, S, H) residual pass
    act_bytes = 8 * layers * stream    # ~4 in + 4 out stream touches/layer
    emb_bytes = 2 * batch * seq * hidden
    return flops, float(param_bytes + act_bytes + emb_bytes)


def knn_search_cost(queries: int, rows: int, dim: int,
                    itemsize: int = 4, extra_row_bytes: int = 0
                    ) -> tuple[float, float]:
    """(flops, bytes_moved) for one brute-force slab search
    (ops/knn.py): the (Q, D) x (D, N) score matmul is 2*Q*N*D FLOPs;
    bytes are dominated by the full slab scan — N*D*itemsize (int8=1,
    bf16=2, f32=4) plus per-row side columns (int8 carries f32
    scales+vsq: extra_row_bytes=8) plus the query upload. The slab term
    is why search latency tracks slab bytes, not FLOPs — AI = 2*Q/
    itemsize FLOP/byte is far below machine balance at serving Q."""
    flops = 2.0 * queries * rows * dim
    bytes_moved = (rows * (dim * itemsize + extra_row_bytes)
                   + queries * dim * 4.0)
    return flops, float(bytes_moved)


def attention_cost(batch: int, seq: int, heads: int, head_dim: int,
                   itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes_moved) for one encoder attention call
    (ops/attention.py flash_attention): QK^T and P·V are 2*S*S*D FLOPs
    each per (batch, head); bytes read q, k and v once and write the
    output once at ``itemsize``, plus the (B, S) one-byte key mask."""
    flops = 4.0 * batch * heads * seq * seq * head_dim
    bytes_moved = 4.0 * batch * seq * heads * head_dim * itemsize \
        + batch * seq
    return flops, float(bytes_moved)


def segment_attention_cost(batch: int, seq: int, *, hidden: int,
                           intermediate: int,
                           layers: int) -> tuple[float, float]:
    """(flops, bytes_moved) for one ragged-packed forward
    (models/encoder.py encode_ragged): the dense encoder's matmul tree —
    the block-diagonal segment mask changes which scores survive, not how
    many are computed — plus the (B, H_heads, S, S) score tensor the
    reference's segment-attention softmax materialises twice per layer
    (write + read). K1 keeps scores on chip, so for the port that term is
    an upper bound."""
    flops, base_bytes = encoder_cost(batch, seq, hidden=hidden,
                                     intermediate=intermediate,
                                     layers=layers)
    score_bytes = 2.0 * layers * 2 * batch * seq * seq  # bf16, write+read
    return flops, base_bytes + score_bytes


def ingest_scatter_cost(rows: int, dim: int,
                        itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes_moved) for one slab scatter / fused-ingest write
    (ops/knn.py _scatter): per row, read the incoming f32 vector and write
    the row at its storage width; ~2*D FLOPs a row (int8's max and
    divide), counted for every width."""
    flops = 2.0 * rows * dim
    bytes_moved = rows * dim * (4.0 + itemsize)
    return flops, float(bytes_moved)
