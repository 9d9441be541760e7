"""The KNN slabs' kernels — K2, the bf16 search (``topk_bf16``, score fused
with the top-k, and ``score_bf16``, the score alone; ops/csrc/knn_bf16.cu),
K3, the int8 search (``topk_i8``, score fused with the top-k, and
``score_i8``, the score alone), and K4, the quantizing scatter
(ops/csrc/knn_i8.cu) — with their plain PyTorch versions, and the 64-bit
keys (``score_keys``) in which the search ranks (score, row) pairs. Each
kernel family runs one mainloop with two epilogues (ops/csrc/knn_topk.cuh).

They replace three XLA functions of pathway_tpu/ops/knn.py:
``_shared_search_fn`` over a bf16 slab (K2: ``topk_bf16`` for k <=
``K_MAX``, its score block ``score_bf16`` for larger k),
``_shared_search_i8_fn`` (K3: ``topk_i8`` for k <= ``K_MAX``, its score
block ``score_i8`` for larger k) and ``_quantize_i8`` inside
``_shared_scatter_i8_fn`` and the int8 fused-ingest step (K4). On a CUDA
tensor each wrapper launches its kernel (or raises) and counts the call;
on a CPU tensor it runs the plain version, which is also the kernels'
oracle on the card (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pathway_tpu_torch.ops.cuda_build import CudaLibrary, LaunchCount

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KNN_I8 = CudaLibrary("knn_i8", {
    # (q, slab, scales, vsq, valid, out, B, N, D, metric, stream)
    "pt_knn_score_i8": (_I, [_P] * 6 + [_I, _L, _I, _I, _P]),
    # (B, N, D, k, &blocks)
    "pt_knn_topk_i8_blocks": (_I, [_I, _L, _I, _I,
                                   ctypes.POINTER(ctypes.c_int)]),
    # (q, slab, scales, vsq, valid, ws, G, out_s, out_row, B, N, D,
    #  metric, k, stream)
    "pt_knn_topk_i8": (_I, [_P] * 6 + [_I, _P, _P, _I, _L, _I, _I, _I,
                                       _P]),
    # (rows, ld, slots, valid_vals, n, D, R, slab, scales, vsq, valid,
    #  stream)
    "pt_knn_quantize_scatter": (_I, [_P, _L, _P, _P, _I, _I, _L]
                                + [_P] * 5),
    "pt_knn_error_string": (ctypes.c_char_p, [_I]),
})
KNN_BF16 = CudaLibrary("knn_bf16", {
    # (B, N, D, k, &blocks)
    "pt_knn_topk_bf16_blocks": (_I, [_I, _L, _I, _I,
                                     ctypes.POINTER(ctypes.c_int)]),
    # (q, slab, valid, ws, G, out_s, out_row, B, N, D, metric, k, stream)
    "pt_knn_topk_bf16": (_I, [_P] * 4 + [_I, _P, _P, _I, _L, _I, _I, _I,
                                         _P]),
    # (q, slab, valid, out, B, N, D, metric, stream)
    "pt_knn_score_bf16": (_I, [_P] * 4 + [_I, _L, _I, _I, _P]),
    "pt_knn_error_string": (ctypes.c_char_p, [_I]),
})
_METRICS = {"cos": 0, "l2sq": 1}


SCORE_I8 = LaunchCount("knn_score_i8")
TOPK_I8 = LaunchCount("knn_topk_i8")
TOPK_BF16 = LaunchCount("knn_topk_bf16")
SCORE_BF16 = LaunchCount("knn_score_bf16")
# the largest k that ``topk_i8`` and ``topk_bf16`` take: the default limit, bench_knn's k=10
# and the 4x over-fetch of a filtered query up to limit 16
K_MAX = 64
QUANTIZE_SCATTER = LaunchCount("knn_quantize_scatter")


def _raise_on(err: int, what: str, lib: CudaLibrary = KNN_I8) -> None:
    if err != 0:
        msg = lib.load().pt_knn_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _on_card(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (take the plain version), True for CUDA."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return True


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# the search's keys
# ---------------------------------------------------------------------------

_LOW32 = 0xFFFFFFFF


def score_keys(scores: torch.Tensor) -> torch.Tensor:
    """(B, N) float32 scores -> (B, N) int64 keys, one per (score, column),
    in the order of a stable descending sort: a higher key is a higher
    score, or an equal score at a lower column. The high word is the
    score's bits as an order-preserving int32 (sign and magnitude to two's
    complement, so -0 and +0 are one score; -inf ranks below every finite
    score, a NaN above +inf, as the sort puts it), the low word ``2^32 - 1
    - column`` for columns 0 .. N - 1. Keys are unique within a row, so
    ``torch.topk`` of them is exact. The score kernels write the same keys
    (ops/csrc/knn_topk.cuh ``score_key``)."""
    b = scores.contiguous().view(torch.int32)
    o = torch.where(b < 0, -(b & 0x7FFFFFFF), b).to(torch.int64)
    cols = torch.arange(scores.shape[-1], dtype=torch.int64,
                        device=scores.device)
    return o * (1 << 32) + (_LOW32 - cols)


def key_scores(keys: torch.Tensor) -> torch.Tensor:
    """The float32 scores of ``score_keys`` keys (-0 comes back +0)."""
    o = torch.div(keys, 1 << 32, rounding_mode="floor").to(torch.int32)
    return torch.where(o < 0, (-o) | -(1 << 31), o).view(torch.float32)


def key_rows(keys: torch.Tensor) -> torch.Tensor:
    """The int64 columns (rows) of ``score_keys`` keys."""
    return _LOW32 - (keys & _LOW32)


# ---------------------------------------------------------------------------
# K4: quantizing scatter
# ---------------------------------------------------------------------------

# 1/127 rounded to float32: the JAX package's ``m / 127.0`` as XLA
# compiles it (division by a constant becomes a multiply by its reciprocal)
INV_127 = 0.007874015718698502


def quantize_i8_reference(vals: torch.Tensor):
    """Per-row symmetric int8 quantization as the JAX package's index
    stores it (``_quantize_i8`` under jit, in its scatter and fused step):
    (q int8, scale f32, vsq f32) with scale = max(max|v| * f32(1/127),
    1e-30), q = clamp(round-half-even(v / scale), -127, 127) with a true
    division, and vsq the int-domain squared norm summed in int32.

    XLA turns ``m / 127.0`` into ``m * f32(1/127)``, so this is bit for bit
    what the JAX index holds; the eager ``_quantize_i8`` and numpy's
    ``_quantize_i8_np`` divide, and their scales differ from it by one ulp
    in ~5% of rows (codes in about one value per million)."""
    v = vals.float()
    m = v.abs().amax(dim=1)
    scale = torch.clamp_min(m * m.new_tensor(INV_127), 1e-30)
    q = torch.clamp(torch.round(v / scale[:, None]), -127, 127).to(
        torch.int8)
    qi = q.to(torch.int32)
    vsq = (qi * qi).sum(dim=1, dtype=torch.int32).float()
    return q, scale, vsq


def quantize_scatter_reference(rows, slots, valid_vals, slab, scales, vsq,
                               valid) -> None:
    """Plain version of ``quantize_scatter``: quantize ``rows`` and write
    codes, scale, vsq and validity at ``slots``, in place; slots outside
    the extent's rows are dropped."""
    keep = (slots >= 0) & (slots < slab.shape[0])
    loc = slots[keep]
    q, sc, vs = quantize_i8_reference(rows[keep])
    slab.index_copy_(0, loc, q)
    scales.index_copy_(0, loc, sc)
    vsq.index_copy_(0, loc, vs)
    if valid_vals is None:
        valid.index_fill_(0, loc, True)
    else:
        valid.index_copy_(0, loc, valid_vals[keep])


def quantize_scatter(rows, slots, valid_vals, slab, scales, vsq,
                     valid) -> None:
    """K4: rows (n, D) float32 -> int8 codes, scale, vsq and validity
    written in place into one extent's (R, D) int8 ``slab`` and (R,)
    ``scales``, ``vsq`` (f32) and ``valid`` (bool) at local ``slots``
    (n,) int64. ``valid_vals`` (n,) bool, or None for all valid. A slot
    outside [0, R) — a ragged padding row's sentinel — is a no-op.

    CUDA tensors launch the kernel on the current stream (counted in
    ``QUANTIZE_SCATTER.launches``); CPU tensors take
    ``quantize_scatter_reference``."""
    if not _on_card(rows, "quantize_scatter"):
        return quantize_scatter_reference(rows, slots, valid_vals, slab,
                                          scales, vsq, valid)
    n, D = rows.shape
    R = slab.shape[0]
    _need(rows.dtype == torch.float32 and rows.stride(1) == 1,
          "rows must be float32 with a contiguous last dim")
    _need(slots.shape == (n,) and slots.dtype == torch.int64
          and slots.is_contiguous(), "slots must be a contiguous (n,) int64")
    _need(valid_vals is None or (valid_vals.shape == (n,) and
                                 valid_vals.dtype == torch.bool and
                                 valid_vals.is_contiguous()),
          "valid_vals must be None or a contiguous (n,) bool")
    _need(slab.dtype == torch.int8 and slab.shape == (R, D)
          and slab.is_contiguous(), "slab must be a contiguous (R, D) int8")
    for name, t, dt in (("scales", scales, torch.float32),
                        ("vsq", vsq, torch.float32),
                        ("valid", valid, torch.bool)):
        _need(t.shape == (R,) and t.dtype == dt and t.is_contiguous(),
              f"{name} must be a contiguous ({R},) {dt}")
    for t in (slots, slab, scales, vsq, valid) + (
            () if valid_vals is None else (valid_vals,)):
        _need(t.device == rows.device, f"a tensor is on {t.device}, rows "
              f"on {rows.device}")
    if n == 0:
        return None
    lib = KNN_I8.load()
    with torch.cuda.device(rows.device):
        err = lib.pt_knn_quantize_scatter(
            rows.data_ptr(), rows.stride(0), slots.data_ptr(),
            None if valid_vals is None else valid_vals.data_ptr(), n, D, R,
            slab.data_ptr(), scales.data_ptr(), vsq.data_ptr(),
            valid.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(err, "quantize_scatter")
    QUANTIZE_SCATTER.launches += 1
    return None


# ---------------------------------------------------------------------------
# K3: int8 score
# ---------------------------------------------------------------------------

def _check_metric(metric: str) -> None:
    if metric not in _METRICS:
        raise ValueError(f"metric must be 'cos' or 'l2sq'; got {metric!r}")


def _check_i8_operands(q, slab, scales, vsq, valid) -> tuple[int, int, int]:
    """(B, N, D) of K3's operands on the card, after checking what the
    kernels take."""
    _need(q.dim() == 2 and q.dtype == torch.bfloat16 and q.is_contiguous(),
          "q must be a contiguous (B, D) bfloat16")
    B, D = q.shape
    N = slab.shape[0]
    _need(slab.dtype == torch.int8 and slab.shape == (N, D)
          and slab.is_contiguous(), f"slab must be a contiguous (N, {D}) "
          "int8")
    for name, t, dt in (("scales", scales, torch.float32),
                        ("vsq", vsq, torch.float32),
                        ("valid", valid, torch.bool)):
        _need(t.shape == (N,) and t.dtype == dt and t.is_contiguous(),
              f"{name} must be a contiguous ({N},) {dt}")
    for t in (slab, scales, vsq, valid):
        _need(t.device == q.device, f"a tensor is on {t.device}, q on "
              f"{q.device}")
    _need(B <= 65535 * 64, f"B = {B} queries exceed the kernel's grid")
    return B, N, D


# the plain scores multiply queries in blocks of _QUERY_BLOCK rows (the last
# padded with zeros) against the rows in tiles of _ROW_TILE (the last tile
# ending at the last row, overlapping its neighbour; fewer rows than a tile
# padded with zeros), so every product has one shape and a query's score of
# a row is the same bits whatever else its batch holds and however long the
# extent is: the semantic result cache takes its hits out of a batch, and
# the paged store's extents are shorter than the slab, yet cache-on and
# cache-off, paged and slab answers must be byte-identical (cuBLAS picks its
# algorithm, and so its order of summation, by the product's shape)
_QUERY_BLOCK = 8
_ROW_TILE = 8192


def _dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 products of the queries q (B, D) f32 with the rows (N, D)
    f32, each product of ``_QUERY_BLOCK`` queries by ``_ROW_TILE`` rows."""
    B, N = q.shape[0], rows.shape[0]
    pad = -B % _QUERY_BLOCK
    if pad:
        q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    if N < _ROW_TILE:
        rows = torch.cat([rows, rows.new_zeros((_ROW_TILE - N,
                                                rows.shape[1]))])
    starts = list(range(0, max(N - _ROW_TILE, 0), _ROW_TILE))
    starts.append(max(N - _ROW_TILE, 0))
    out = q.new_empty((q.shape[0], max(N, _ROW_TILE)))
    for s in starts:
        tile = rows[s:s + _ROW_TILE].T
        for b in range(0, q.shape[0], _QUERY_BLOCK):
            out[b:b + _QUERY_BLOCK, s:s + _ROW_TILE] = \
                q[b:b + _QUERY_BLOCK] @ tile
    return out[:B, :N]


def score_i8_reference(q, slab, scales, vsq, valid, metric: str):
    """The scores whose keys ``score_i8`` writes: the int8 rows widened to
    float32 (exact), one f32 product with the bf16 queries (exact products,
    f32 sums; ``_dots``), then the score block of the JAX package's
    ``_shared_search_i8_fn``."""
    dots = _dots(q.float(), slab.float())
    if metric == "cos":
        scores = dots * torch.rsqrt(vsq + 1e-12)[None, :]
    else:
        scores = (2.0 * dots * scales[None, :]
                  - vsq[None, :] * (scales * scales)[None, :])
    return scores.masked_fill(~valid[None, :], -math.inf)


def score_i8(q, slab, scales, vsq, valid, metric: str,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """K3 score: queries q (B, D) bfloat16 (normalised for cos, then cast),
    an int8 chunk ``slab`` (N, D) with its (N,) ``scales``, ``vsq`` (f32)
    and ``valid`` (bool) -> the (B, N) int64 ``score_keys`` of the scores
    ``dots * rsqrt(vsq + 1e-12)`` for cos, ``2 dots scale - vsq scale^2``
    for l2sq, -inf on invalid rows (``key_scores`` gives them back).
    Written into ``out`` (contiguous, of that shape and dtype) if given.

    CUDA tensors launch the kernel on the current stream (counted in
    ``SCORE_I8.launches``); CPU tensors take the keys of
    ``score_i8_reference``."""
    _check_metric(metric)
    if not _on_card(q, "score_i8"):
        return _plain_keys(
            score_i8_reference(q, slab, scales, vsq, valid, metric), out)
    B, N, D = _check_i8_operands(q, slab, scales, vsq, valid)
    return _launch_score(KNN_I8, "score_i8", SCORE_I8, q, N, out,
                         lambda lib, out, stream: lib.pt_knn_score_i8(
                             q.data_ptr(), slab.data_ptr(), scales.data_ptr(),
                             vsq.data_ptr(), valid.data_ptr(), out, B, N, D,
                             _METRICS[metric], stream))


def _plain_keys(scores: torch.Tensor,
                out: torch.Tensor | None) -> torch.Tensor:
    keys = score_keys(scores)
    return keys if out is None else out.copy_(keys)


def _launch_score(lib: CudaLibrary, what: str, count: LaunchCount, q,
                  N: int, out: torch.Tensor | None, launch):
    """A score kernel's launch (``pt_knn_<what>``) for queries q (B, D) on
    the card into ``out``, or a new (B, N) int64 output of keys: calls
    ``launch(lib, out, stream)`` with pointers, raises on a refused launch
    and counts one."""
    _need(N < 2**31, f"N = {N} rows exceed the kernel's 31-bit rows")
    B = q.shape[0]
    if out is None:
        out = torch.empty((B, N), dtype=torch.int64, device=q.device)
    _need(out.shape == (B, N) and out.dtype == torch.int64
          and out.is_contiguous() and out.device == q.device,
          f"out must be a contiguous ({B}, {N}) int64 on {q.device}")
    if B == 0 or N == 0:
        return out
    so = lib.load()
    with torch.cuda.device(q.device):
        err = launch(so, out.data_ptr(),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, what, lib)
    count.launches += 1
    return out


def topk_i8_reference(q, slab, scales, vsq, valid, metric: str, k: int):
    """Plain version of ``topk_i8``: ``score_i8_reference``, a stable
    descending sort, the first k columns."""
    scores = score_i8_reference(q, slab, scales, vsq, valid, metric)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def topk_i8(q, slab, scales, vsq, valid, metric: str, k: int):
    """K3 top-k: the ``k`` best rows of one int8 extent for each query, as
    ``score_i8`` scores them — (B, k) float32 scores and (B, k) int64 rows,
    best first, equal scores lowest row first, invalid rows (-inf) ranked
    like any other (a stable descending sort's order, ``lax.top_k``'s).
    Operands as ``score_i8``'s, over a whole extent of any length;
    1 <= k <= ``K_MAX`` and k <= N.

    CUDA tensors launch the fused kernel and its merge on the current
    stream (counted once a call in ``TOPK_I8.launches``); CPU tensors take
    ``topk_i8_reference``."""
    _check_metric(metric)
    N = slab.shape[0]
    _need(1 <= k <= min(K_MAX, N), f"k = {k} must be in [1, min({K_MAX}, "
          f"N = {N})]")
    if not _on_card(q, "topk_i8"):
        return topk_i8_reference(q, slab, scales, vsq, valid, metric, k)
    B, N, D = _check_i8_operands(q, slab, scales, vsq, valid)
    return _launch_topk(KNN_I8, "topk_i8", TOPK_I8, q, N, k,
                        lambda lib, ws, G, out_s, out_row, stream:
                        lib.pt_knn_topk_i8(
                            q.data_ptr(), slab.data_ptr(), scales.data_ptr(),
                            vsq.data_ptr(), valid.data_ptr(), ws, G, out_s,
                            out_row, B, N, D, _METRICS[metric], k, stream))


def _launch_topk(lib: CudaLibrary, what: str, count: LaunchCount, q, N: int,
                 k: int, launch):
    """A fused top-k's two launches (``pt_knn_<what>``, with the grid from
    ``pt_knn_<what>_blocks``) for queries q (B, D) on the card: allocates
    the (B, k) outputs and the (grid, B, k) workspace, then calls
    ``launch(lib, ws, grid, out_s, out_row, stream)`` with pointers;
    raises on a refused launch and counts one."""
    _need(N < 2**31, f"N = {N} rows exceed the kernel's 31-bit rows")
    B, D = q.shape
    scores = torch.empty((B, k), dtype=torch.float32, device=q.device)
    rows = torch.empty((B, k), dtype=torch.int64, device=q.device)
    if B == 0:
        return scores, rows
    so = lib.load()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        _raise_on(getattr(so, f"pt_knn_{what}_blocks")(
            B, N, D, k, ctypes.byref(blocks)), what, lib)
        ws = torch.empty((blocks.value, B, k), dtype=torch.int64,
                         device=q.device)
        err = launch(so, ws.data_ptr(), blocks.value, scores.data_ptr(),
                     rows.data_ptr(),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, what, lib)
    count.launches += 1
    return scores, rows


# ---------------------------------------------------------------------------
# K2: bf16 score fused with the top-k
# ---------------------------------------------------------------------------

def score_float_reference(q, vectors, valid, metric: str):
    """The score block of the JAX package's ``_shared_search_fn``, plainly:
    q (B, D) f32 already in the slab's precision, vectors (N, D) float32 or
    bfloat16 -> (B, N) f32 scores, ``dots * rsqrt(||v||^2 + 1e-12)`` for
    cos, ``2 dots - ||v||^2`` for l2sq, -inf on invalid rows. The product
    is ``_dots``'s, a query's scores the same in any batch."""
    vf = vectors.float()
    dots = _dots(q, vf)
    vn_sq = (vf * vf).sum(dim=1)
    if metric == "cos":
        scores = dots * torch.rsqrt(vn_sq + 1e-12)[None, :]
    else:
        # -||q - v||^2 = 2 q·v - ||v||^2 - ||q||^2 ; drop ||q||^2
        # (constant per query row, does not change ranking)
        scores = 2.0 * dots - vn_sq[None, :]
    return scores.masked_fill(~valid[None, :], -math.inf)


def topk_bf16_reference(q, slab, valid, metric: str, k: int):
    """Plain version of ``topk_bf16``: ``score_float_reference`` of the
    bf16 queries, a stable descending sort, the first k columns."""
    scores = score_float_reference(q.float(), slab, valid, metric)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def _check_bf16_operands(q, slab, valid) -> tuple[int, int, int]:
    """(B, N, D) of K2's operands on the card, after checking what the
    kernels take."""
    _need(q.dim() == 2 and q.dtype == torch.bfloat16 and q.is_contiguous(),
          "q must be a contiguous (B, D) bfloat16")
    B, D = q.shape
    N = slab.shape[0]
    _need(slab.dtype == torch.bfloat16 and slab.shape == (N, D)
          and slab.is_contiguous(), f"slab must be a contiguous (N, {D}) "
          "bfloat16")
    _need(valid.shape == (N,) and valid.dtype == torch.bool
          and valid.is_contiguous(), f"valid must be a contiguous ({N},) "
          "bool")
    for t in (slab, valid):
        _need(t.device == q.device, f"a tensor is on {t.device}, q on "
              f"{q.device}")
    _need(B <= 65535 * 64, f"B = {B} queries exceed the kernel's grid")
    return B, N, D


def topk_bf16(q, slab, valid, metric: str, k: int):
    """K2: the ``k`` best rows of one bf16 extent for each query, as
    ``score_float_reference`` scores them — (B, k) float32 scores and
    (B, k) int64 rows, best first, equal scores lowest row first, invalid
    rows (-inf) ranked like any other (a stable descending sort's order,
    ``lax.top_k``'s). q (B, D) bfloat16, normalised for cos then cast;
    ``slab`` (N, D) bfloat16 and ``valid`` (N,) bool over a whole extent
    of any length; 1 <= k <= ``K_MAX`` and k <= N.

    CUDA tensors launch the fused kernel and its merge on the current
    stream (counted once a call in ``TOPK_BF16.launches``); CPU tensors
    take ``topk_bf16_reference``."""
    _check_metric(metric)
    N = slab.shape[0]
    _need(1 <= k <= min(K_MAX, N), f"k = {k} must be in [1, min({K_MAX}, "
          f"N = {N})]")
    if not _on_card(q, "topk_bf16"):
        return topk_bf16_reference(q, slab, valid, metric, k)
    B, N, D = _check_bf16_operands(q, slab, valid)
    return _launch_topk(KNN_BF16, "topk_bf16", TOPK_BF16, q, N, k,
                        lambda lib, ws, G, out_s, out_row, stream:
                        lib.pt_knn_topk_bf16(
                            q.data_ptr(), slab.data_ptr(), valid.data_ptr(),
                            ws, G, out_s, out_row, B, N, D, _METRICS[metric],
                            k, stream))


def score_bf16_reference(q, slab, valid, metric: str):
    """The scores whose keys ``score_bf16`` writes:
    ``score_float_reference`` of the bf16 queries in float32."""
    return score_float_reference(q.float(), slab, valid, metric)


def score_bf16(q, slab, valid, metric: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K2's score twin: queries q (B, D) bfloat16 (normalised for cos, then
    cast), a bf16 chunk ``slab`` (N, D) with its (N,) bool ``valid`` -> the
    (B, N) int64 ``score_keys`` of the scores ``dots * rsqrt(||v||^2 +
    1e-12)`` for cos, ``2 dots - ||v||^2`` for l2sq, -inf on invalid rows
    (f32 sums of bf16 products; ``key_scores`` gives them back). Written
    into ``out`` (contiguous, of that shape and dtype) if given.

    CUDA tensors launch the kernel on the current stream (counted in
    ``SCORE_BF16.launches``); CPU tensors take the keys of
    ``score_bf16_reference``."""
    _check_metric(metric)
    if not _on_card(q, "score_bf16"):
        return _plain_keys(score_bf16_reference(q, slab, valid, metric), out)
    B, N, D = _check_bf16_operands(q, slab, valid)
    return _launch_score(KNN_BF16, "score_bf16", SCORE_BF16, q, N, out,
                         lambda lib, out, stream: lib.pt_knn_score_bf16(
                             q.data_ptr(), slab.data_ptr(), valid.data_ptr(),
                             out, B, N, D, _METRICS[metric], stream))
