"""Continuous profiling plane — port of pathway_tpu/engine/profiler.py:
host flamegraphs + device cost attribution.

1. **Which host frames got slower?** A sampling profiler thread walks
   ``sys._current_frames()`` every ``PATHWAY_PROFILER_SAMPLE_MS`` (25 ms)
   for the engine thread inventory (every engine thread is named
   ``pathway-tpu-<role>``, engine/threads.py), folds stacks per thread
   role, and tags each sample with the flight recorder's in-flight
   operator (``device-bridge;...;[device:knn_search]``). It keeps rolling
   self-overhead accounting against the < 2% contract of
   tests/profiling_canary.py (:meth:`Profiler.overhead_ratio`).

2. **Which kernels, and are they compute- or bandwidth-bound?** An
   analytic cost model (FLOPs + bytes moved) per kernel family —
   ``knn_search`` (K2 / K3 and the f32 product), ``ingest_scatter`` (the
   slab write, K4 for int8), ``encoder_forward`` and ``segment_attention``
   (the encoder, K1 inside) — is fed at each dispatch site
   (:meth:`Profiler.record_dispatch`). A dispatch on a CUDA tensor
   returns in microseconds, so its call-site wall says nothing; the
   device bridge (and sync mode's per-device-node leg in engine/graph.py)
   wraps each device leg in :meth:`Profiler.begin_leg` /
   :meth:`Profiler.end_leg`, which record a ``torch.cuda.Event`` pair on
   the leg's stream. The leg's records are held until its end event has
   completed — checked with ``query()`` at the next ``end_leg``, at
   :meth:`Profiler.stats` and the other read methods, and at
   :meth:`Profiler.stop` / :meth:`Profiler.flush`, where the one wait goes
   through ``device_sanitizer.explicit_sync`` — and then committed,
   scaled pro rata to the events' ``elapsed_time``: by their call-site
   walls when those hold more than 5% of the leg, else by analytic bytes
   (the JAX package's rule). So the profiler adds no implicit host sync
   to the main path. On the CPU, and for a record outside any leg, the
   call-site wall stands, as in the JAX package. Per family: totals, a
   rolling window, MFU, HBM use and the roofline class (arithmetic
   intensity against the machine balance).

3. **A deep dive:** :meth:`Profiler.start_device_capture` /
   :meth:`Profiler.stop_device_capture` run ``torch.profiler`` (CPU, and
   CUDA on a card) and write a Chrome trace into the capture directory.

Cost model: **disabled costs one module-global load + None check per
hook** (``current_profiler()`` returns None and every call site
short-circuits); outputs are byte-identical with profiling on or off —
the profiler only observes shapes and clocks. ``PATHWAY_PROFILER=1``
turns it on for ``pw.run`` (engine/streaming.py); the port has no HTTP
server or dashboard yet, so nothing turns it on by itself.

Machine parameters (``machine_params``: the card's peak rate and memory
rate, shared by bench-style MFU keys and ``chip_smoke.py``'s bounds)
default to the H100 SXM's and are overridable with ``BENCH_PEAK_TFLOPS``
/ ``BENCH_HBM_GBPS``. ``diff_profiles`` names the dominant kernel and
frame delta between two :meth:`Profiler.profile_epoch` snapshots.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine import device_sanitizer

__all__ = [
    "Profiler", "current_profiler", "install_profiler", "live_profiler_stats",
    "machine_params", "machine_balance",
    "encoder_flops_per_token", "encoder_cost", "segment_attention_cost",
    "knn_search_cost", "ingest_scatter_cost", "attention_cost",
    "diff_profiles",
]

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


# ---------------------------------------------------------------------------
# the profiler singleton
# ---------------------------------------------------------------------------

_PROFILER = None  # module global: current_profiler() is one load + check

_DEFAULT_SAMPLE_MS = 25.0
_DEFAULT_WINDOW_S = 60.0
_MAX_DISTINCT_STACKS = 512
_MAX_STACK_DEPTH = 48
_ROLLING_EVENTS = 4096


def current_profiler():
    """The installed profiler, or None (the hooks' zero-overhead-off
    branch: one module-global load + None check per call site)."""
    return _PROFILER


def install_profiler(profiler) -> None:
    """Install/clear the process-wide profiler (None clears). The
    streaming runtime owns the lifecycle; tests install directly."""
    global _PROFILER
    _PROFILER = profiler


def live_profiler_stats() -> dict | None:
    """Snapshot of the installed profiler (None when no profiler is
    live)."""
    prof = _PROFILER
    if prof is None:
        return None
    return prof.stats()


class _FamilyStats:
    """Per-kernel-family aggregate + rolling window of dispatches."""

    __slots__ = ("dispatches", "flops_total", "bytes_total",
                 "device_ms_total", "attributed", "attributed_ms", "window")

    def __init__(self):
        self.dispatches = 0
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.device_ms_total = 0.0
        self.attributed = 0  # dispatches re-timed by a measured leg
        self.attributed_ms = 0.0  # their share of the legs' time
        # (monotonic, flops, bytes, device_ms)
        self.window: collections.deque = collections.deque(
            maxlen=_ROLLING_EVENTS)


class _LegBuffer:
    """Thread-local buffer of dispatches recorded inside one device leg,
    with the leg's CUDA event pair when its time comes from the card."""

    __slots__ = ("tick", "records", "start", "end")

    def __init__(self, tick: int):
        self.tick = tick
        self.records: list[list] = []  # [family, flops, bytes, wall_ms]
        self.start = None
        self.end = None


class Profiler:
    """Two-sided profiling plane (see module doc). One per process,
    installed via :func:`install_profiler`; every hook goes through
    :func:`current_profiler` so the uninstalled state costs a branch.

    ``device`` is where the legs' work runs ("cuda" unless the caller asks
    for the CPU): on a CUDA device a leg's time is its CUDA events', on
    the CPU the bridge's host wall."""

    def __init__(self, sample_interval_ms: float | None = None,
                 window_s: float | None = None,
                 device: str | torch.device = "cuda"):
        from pathway_tpu_torch.engine.locking import create_lock
        from pathway_tpu_torch.internals.config import _env_float

        if sample_interval_ms is None:
            sample_interval_ms = _env_float("PATHWAY_PROFILER_SAMPLE_MS",
                                            _DEFAULT_SAMPLE_MS)
        self.sample_interval_s = max(0.001, sample_interval_ms / 1e3)
        if window_s is None:
            window_s = _env_float("PATHWAY_PROFILER_WINDOW_S",
                                  _DEFAULT_WINDOW_S)
        self.window_s = max(1.0, window_s)
        self.device = resolve_device(device)
        self._lock = create_lock("Profiler._lock")
        # -- device side ---------------------------------------------------
        self._families: dict[str, _FamilyStats] = {}
        self._leg_local = threading.local()  # .buf: _LegBuffer | None
        # legs whose end event the card has not reached yet, oldest first
        self._pending: collections.deque = collections.deque()
        self.legs_committed = 0    # legs whose records were re-timed
        self.legs_timed = 0        # ... of them by CUDA events
        self.leg_ms_total = 0.0    # their measured time
        # -- host sampler --------------------------------------------------
        # (role, folded-stack tuple) -> count; bounded, overflow -> (other)
        self._stacks: dict[tuple, int] = {}
        self.samples_total = 0
        self.device_attributed_samples = 0
        self._sample_cost_s = 0.0   # time spent inside the sample pass
        self._sampler_started = None  # monotonic of sampler start
        self._stop = threading.Event()
        self._thread = None
        # -- on-demand torch.profiler capture -----------------------------
        self._capture = None
        self._capture_dir: str | None = None
        self.captures_total = 0

    # -- construction ------------------------------------------------------
    @classmethod
    def from_env(cls, auto_on: bool = False) -> "Profiler | None":
        """The run-level profiler, or None when profiling is off.

        Mirrors FlightRecorder.from_env: ``PATHWAY_PROFILER=0``
        force-disables, ``=1`` force-enables, otherwise on iff the
        caller's surface makes the data observable (``auto_on``). Its
        device is ``PATHWAY_PROFILER_DEVICE``, else "cuda"."""
        flag = os.environ.get("PATHWAY_PROFILER", "").strip().lower()
        if flag in ("0", "false", "off", "no"):
            return None
        forced = flag in ("1", "true", "on", "yes")
        if not forced and not auto_on:
            return None
        return cls(
            device=os.environ.get("PATHWAY_PROFILER_DEVICE") or "cuda")

    # -- host sampling profiler --------------------------------------------
    def start(self) -> None:
        """Start the sampling thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._sampler_started = time.monotonic()
        from pathway_tpu_torch.engine.threads import spawn

        self._thread = spawn(self._sample_loop, name="profiler-sampler")

    def stop(self) -> None:
        """Stop the sampler and any running capture, and commit every
        leg still waiting for the card (:meth:`flush`)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(2.0)
            self._thread = None
        if self._capture is not None:
            try:
                self.stop_device_capture()
            except Exception:
                pass
        self.flush()

    def _sample_loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.sample_interval_s):
            t0 = time.perf_counter()
            try:
                self._sample_once(me)
            except Exception:
                # sampling must never take the run down; one bad pass is
                # a lost sample, not a crash
                pass
            self._sample_cost_s += time.perf_counter() - t0

    def _sample_once(self, self_ident: int) -> None:
        from pathway_tpu_torch.engine import flight_recorder
        from pathway_tpu_torch.engine.threads import thread_role

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        try:
            inflight = flight_recorder.live_inflight_by_thread()
        except Exception:
            inflight = {}
        new: list[tuple[tuple, bool]] = []
        for ident, frame in frames.items():
            if ident == self_ident:
                continue  # never profile the profiler into the profile
            name = names.get(ident)
            if name is None:
                continue
            role = thread_role(name)
            if role is None:
                continue  # non-engine threads are out of contract
            stack = []
            f = frame
            while f is not None and len(stack) < _MAX_STACK_DEPTH:
                code = f.f_code
                stack.append(
                    f"{code.co_name} "
                    f"({os.path.basename(code.co_filename)}:"
                    f"{f.f_lineno})")
                f = f.f_back
            stack.reverse()  # outermost first: collapsed-stack order
            device_leg = False
            op = inflight.get(ident)
            if op is not None:
                leg, op_name = op
                device_leg = leg == "device"
                stack.append(f"[{leg}:{op_name}]")
            new.append(((role, tuple(stack)), device_leg))
        if not new:
            return
        with self._lock:
            for key, device_leg in new:
                self.samples_total += 1
                if device_leg:
                    self.device_attributed_samples += 1
                if key in self._stacks:
                    self._stacks[key] += 1
                elif len(self._stacks) < _MAX_DISTINCT_STACKS:
                    self._stacks[key] = 1
                else:
                    # bounded memory: the long tail folds into one bucket
                    other = (key[0], ("(other)",))
                    self._stacks[other] = self._stacks.get(other, 0) + 1

    def stack_counts(self) -> dict[tuple, int]:
        """Snapshot of the folded-stack counters (for windowed diffs)."""
        with self._lock:
            return dict(self._stacks)

    def collapsed(self, baseline: dict | None = None) -> str:
        """Collapsed-flamegraph text: ``role;frame;frame count`` per
        line, descending count — feed straight to flamegraph.pl /
        speedscope. ``baseline`` (a prior :meth:`stack_counts` snapshot)
        restricts output to samples taken since it."""
        counts = self.stack_counts()
        rows = []
        for (role, stack), n in counts.items():
            if baseline is not None:
                n -= baseline.get((role, stack), 0)
            if n <= 0:
                continue
            rows.append((";".join((role,) + stack), n))
        rows.sort(key=lambda r: (-r[1], r[0]))
        return "\n".join(f"{stack} {n}" for stack, n in rows) + (
            "\n" if rows else "")

    def top_host_frame(self) -> str | None:
        """The leaf frame with the most samples (dashboard one-liner)."""
        leaf: dict[str, int] = {}
        with self._lock:
            for (_role, stack), n in self._stacks.items():
                if stack:
                    leaf[stack[-1]] = leaf.get(stack[-1], 0) + n
        if not leaf:
            return None
        return max(leaf.items(), key=lambda kv: kv[1])[0]

    def overhead_ratio(self) -> float:
        """Rolling self-overhead: seconds spent inside sample passes over
        sampler wall time. The contract is < 0.02 (2%)."""
        if self._sampler_started is None:
            return 0.0
        wall = time.monotonic() - self._sampler_started
        if wall <= 0.0:
            return 0.0
        return self._sample_cost_s / wall

    # -- device-side dispatch recording ------------------------------------
    def record_dispatch(self, family: str, flops: float, bytes_moved: float,
                        wall_ms: float) -> None:
        """Record one kernel dispatch: analytic (flops, bytes) from the
        cost model + call-site wall ms. Inside a leg (begin_leg/end_leg on
        this thread) the record is buffered and re-timed to the leg's
        measured time; outside a leg the call-site wall stands."""
        buf = getattr(self._leg_local, "buf", None)
        if buf is not None:
            buf.records.append([family, flops, bytes_moved, wall_ms])
            return
        self._commit(family, flops, bytes_moved, wall_ms, attributed=False)

    def begin_leg(self, tick: int) -> None:
        """Device-leg runner: start buffering this thread's dispatches; on
        a CUDA device, record the leg's start event on the current
        stream."""
        buf = _LegBuffer(tick)
        if self.device.type == "cuda":
            buf.start = torch.cuda.Event(enable_timing=True)
            buf.start.record(torch.cuda.current_stream(self.device))
        self._leg_local.buf = buf

    def end_leg(self, exec_ms: float | None) -> None:
        """Device-leg runner: the leg finished after ``exec_ms`` host ms
        (None = the leg failed; its records keep their call-site walls,
        unattributed). On a CUDA device the end event is recorded and the
        records wait, with the legs before them, until the card has
        reached it; they are then scaled to the events' elapsed time. On
        the CPU they are scaled to ``exec_ms`` now. Either way per-family
        device time sums exactly to the legs' measured time."""
        buf = getattr(self._leg_local, "buf", None)
        self._leg_local.buf = None
        if buf is None or not buf.records:
            self._settle(block=False)
            return
        if exec_ms is None:
            for family, flops, nbytes, wall_ms in buf.records:
                self._commit(family, flops, nbytes, wall_ms,
                             attributed=False)
            return
        if buf.start is None:
            self._attribute(buf.records, exec_ms, timed=False)
            return
        buf.end = torch.cuda.Event(enable_timing=True)
        buf.end.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._pending.append(buf)
        self._settle(block=False)

    def flush(self) -> None:
        """Wait for the card to reach every pending leg's end event (one
        explicit sync) and commit their records."""
        self._settle(block=True)

    def _settle(self, block: bool) -> None:
        """Commit the pending legs whose end event has completed, oldest
        first; with ``block``, wait for each one instead of stopping at
        the first the card has not reached."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                buf = self._pending[0]
                done = buf.end.query()
                if not (done or block):
                    return
                self._pending.popleft()
            if not done:
                with device_sanitizer.explicit_sync("profiler leg timing"):
                    buf.end.synchronize()
            self._attribute(buf.records, buf.start.elapsed_time(buf.end),
                            timed=True)

    def _attribute(self, records: list, exec_ms: float, timed: bool) -> None:
        """Scale one leg's records to its measured ``exec_ms``: by their
        own wall share when it is meaningful, by analytic bytes otherwise
        (asynchronous dispatches all return in ~0 host ms)."""
        wall_sum = sum(r[3] for r in records)
        if wall_sum > exec_ms * 0.05:
            weights = [r[3] / wall_sum for r in records]
        else:
            cost_sum = sum(r[2] for r in records) or float(len(records))
            weights = [(r[2] / cost_sum if cost_sum else 1.0 / len(records))
                       for r in records]
        for (family, flops, nbytes, _wall), w in zip(records, weights):
            self._commit(family, flops, nbytes, exec_ms * w,
                         attributed=True)
        with self._lock:
            self.legs_committed += 1
            self.legs_timed += int(timed)
            self.leg_ms_total += exec_ms

    def _commit(self, family: str, flops: float, bytes_moved: float,
                device_ms: float, attributed: bool) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._families.get(family)
            if st is None:
                st = self._families[family] = _FamilyStats()
            st.dispatches += 1
            st.flops_total += flops
            st.bytes_total += bytes_moved
            st.device_ms_total += device_ms
            if attributed:
                st.attributed += 1
                st.attributed_ms += device_ms
            st.window.append((now, flops, bytes_moved, device_ms))

    # -- device-side read side ---------------------------------------------
    def _rolling(self, st: _FamilyStats, now: float) -> tuple:
        cutoff = now - self.window_s
        flops = nbytes = ms = 0.0
        n = 0
        for t, f, b, m in st.window:
            if t >= cutoff:
                flops += f
                nbytes += b
                ms += m
                n += 1
        return flops, nbytes, ms, n

    def family_stats(self) -> dict[str, dict]:
        """Per-family totals + rolling window + roofline classification
        (legs the card has finished are committed first)."""
        self._settle(block=False)
        mp = machine_params()
        peak_fps = mp["peak_tflops"] * 1e12
        peak_bps = mp["hbm_gbps"] * 1e9
        balance = peak_fps / peak_bps
        now = time.monotonic()
        out: dict[str, dict] = {}
        with self._lock:
            items = list(self._families.items())
        for family, st in items:
            r_flops, r_bytes, r_ms, r_n = self._rolling(st, now)
            ai = (st.flops_total / st.bytes_total
                  if st.bytes_total > 0 else 0.0)
            dev_s = st.device_ms_total / 1e3
            out[family] = {
                "dispatches": st.dispatches,
                "attributed_dispatches": st.attributed,
                "flops_total": st.flops_total,
                "bytes_total": st.bytes_total,
                "device_ms_total": round(st.device_ms_total, 3),
                "attributed_device_ms_total": st.attributed_ms,
                "rolling": {
                    "dispatches": r_n,
                    "device_ms": round(r_ms, 3),
                    "mfu": round(r_flops / (r_ms / 1e3) / peak_fps, 6)
                    if r_ms > 0 else 0.0,
                    "hbm_bw_util": round(
                        r_bytes / (r_ms / 1e3) / peak_bps, 6)
                    if r_ms > 0 else 0.0,
                },
                "mfu": round(st.flops_total / dev_s / peak_fps, 6)
                if dev_s > 0 else 0.0,
                "hbm_bw_util": round(st.bytes_total / dev_s / peak_bps, 6)
                if dev_s > 0 else 0.0,
                "roofline": {
                    "arithmetic_intensity": round(ai, 4),
                    "machine_balance": round(balance, 4),
                    "bound_by": ("compute" if ai >= balance
                                 else "bandwidth"),
                    # attainable fraction of peak at this AI — the
                    # roofline ceiling the family could reach at best
                    "attainable_mfu": round(
                        min(1.0, ai / balance), 6),
                },
            }
        return out

    def _rolling_totals(self) -> tuple[float, float, float]:
        self._settle(block=False)
        now = time.monotonic()
        flops = nbytes = ms = 0.0
        with self._lock:
            fams = list(self._families.values())
        for st in fams:
            f, b, m, _n = self._rolling(st, now)
            flops += f
            nbytes += b
            ms += m
        return flops, nbytes, ms

    def rolling_mfu(self) -> float:
        """Rolling model-FLOPs utilization across every family: window
        FLOPs over window device-seconds, against peak."""
        flops, _b, ms = self._rolling_totals()
        if ms <= 0.0:
            return 0.0
        return flops / (ms / 1e3) / (machine_params()["peak_tflops"] * 1e12)

    def rolling_hbm_bw_util(self) -> float:
        """Rolling HBM bandwidth utilization across every family."""
        _f, nbytes, ms = self._rolling_totals()
        if ms <= 0.0:
            return 0.0
        return nbytes / (ms / 1e3) / (machine_params()["hbm_gbps"] * 1e9)

    def leg_stats(self) -> dict:
        """The legs whose records were re-timed: how many, how many by
        CUDA events, their measured ms, and legs still pending."""
        self._settle(block=False)
        with self._lock:
            return {"committed": self.legs_committed,
                    "timed": self.legs_timed,
                    "ms_total": self.leg_ms_total,
                    "pending": len(self._pending)}

    # -- on-demand torch.profiler capture ----------------------------------
    def start_device_capture(self, out_dir: str | None = None) -> str:
        """Start a ``torch.profiler`` capture (CPU activity, plus CUDA on
        a card) for a Chrome trace into ``out_dir`` (default: a fresh
        ``pathway-profile-<pid>-<n>`` under PATHWAY_PROFILE_DIR or the
        tmpdir). Returns the directory. One capture at a time."""
        if self._capture is not None:
            raise RuntimeError(
                f"device capture already running -> {self._capture_dir}")
        if out_dir is None:
            import tempfile

            base = os.environ.get("PATHWAY_PROFILE_DIR",
                                  tempfile.gettempdir())
            out_dir = os.path.join(
                base, f"pathway-profile-{os.getpid()}"
                      f"-{self.captures_total}")
        os.makedirs(out_dir, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        capture = profile(activities=activities)
        capture.start()
        self._capture, self._capture_dir = capture, out_dir
        return out_dir

    def stop_device_capture(self) -> str:
        """Stop the running capture and export its Chrome trace
        (``trace-<pid>-<n>.json``) into the capture directory; returns
        the directory."""
        if self._capture is None:
            raise RuntimeError("no device capture running")
        capture, out_dir = self._capture, self._capture_dir
        self._capture = self._capture_dir = None
        # the profiler waits for the card to flush its activity records
        with device_sanitizer.explicit_sync("device capture stop"):
            capture.stop()
        capture.export_chrome_trace(os.path.join(
            out_dir, f"trace-{os.getpid()}-{self.captures_total}.json"))
        self.captures_total += 1
        return out_dir

    # -- snapshots ----------------------------------------------------------
    def stats(self) -> dict:
        """The profiler's status section (the dashboard panel feed, once
        the port has one)."""
        families = self.family_stats()
        with self._lock:
            distinct = len(self._stacks)
        return {
            "host": {
                "sampling": self._thread is not None
                and self._thread.is_alive(),
                "sample_interval_ms": round(
                    self.sample_interval_s * 1e3, 3),
                "samples_total": self.samples_total,
                "device_attributed_samples":
                    self.device_attributed_samples,
                "distinct_stacks": distinct,
                "overhead_ratio": round(self.overhead_ratio(), 6),
                "top_frame": self.top_host_frame(),
            },
            "machine": {**machine_params(),
                        "balance_flop_per_byte": round(machine_balance(),
                                                       4)},
            "device": str(self.device),
            "legs": self.leg_stats(),
            "mfu_rolling": round(self.rolling_mfu(), 6),
            "hbm_bw_util": round(self.rolling_hbm_bw_util(), 6),
            "families": families,
            "capture": {
                "running": self._capture is not None,
                "dir": self._capture_dir,
                "captures_total": self.captures_total,
            },
        }

    def profile_epoch(self) -> dict:
        """One embeddable profile snapshot (``diff_profiles`` compares
        two)."""
        counts = self.stack_counts()
        frames: dict[str, int] = {}
        for (_role, stack), n in counts.items():
            for fr in stack:
                frames[fr] = frames.get(fr, 0) + n
        top = sorted(frames.items(), key=lambda kv: -kv[1])[:40]
        return {
            "at": time.time(),
            "machine": machine_params(),
            "mfu_rolling": round(self.rolling_mfu(), 6),
            "hbm_bw_util": round(self.rolling_hbm_bw_util(), 6),
            "families": self.family_stats(),
            "host": {
                "samples_total": self.samples_total,
                "overhead_ratio": round(self.overhead_ratio(), 6),
                "top_frames": [{"frame": f, "samples": n} for f, n in top],
            },
        }


# ---------------------------------------------------------------------------
# profdiff: name the dominant frame/kernel delta between two profiles
# ---------------------------------------------------------------------------

def _profile_of(doc: dict) -> dict | None:
    """Accept a bare profile epoch, a {"profile": [...]} bench artifact
    (last epoch wins — it saw the most work), or None."""
    if not isinstance(doc, dict):
        return None
    if "families" in doc or "host" in doc:
        return doc
    epochs = doc.get("profile")
    if isinstance(epochs, list) and epochs:
        return epochs[-1]
    if isinstance(epochs, dict):
        return epochs
    return None


def diff_profiles(a: dict, b: dict) -> dict:
    """Compare two profile snapshots (A = baseline, B = flagged run):
    per-kernel-family device-ms deltas and per-host-frame sample-share
    deltas, each naming its dominant regressor. Pure function over
    :meth:`Profiler.profile_epoch` JSON (or a bench artifact embedding a
    list of them under "profile")."""
    pa, pb = _profile_of(a), _profile_of(b)
    if pa is None or pb is None:
        raise ValueError(
            "no profile data found — run bench.py --profile so "
            "BENCH_*.json embeds profile epochs")
    out: dict = {"kernel_deltas": [], "frame_deltas": []}
    fams = set(pa.get("families", {})) | set(pb.get("families", {}))
    for fam in sorted(fams):
        fa = pa.get("families", {}).get(fam, {})
        fb = pb.get("families", {}).get(fam, {})
        ma = float(fa.get("device_ms_total", 0.0))
        mb = float(fb.get("device_ms_total", 0.0))
        da = max(1, int(fa.get("dispatches", 0) or 0))
        db = max(1, int(fb.get("dispatches", 0) or 0))
        per_a, per_b = ma / da, mb / db
        out["kernel_deltas"].append({
            "family": fam,
            "device_ms_per_dispatch_a": round(per_a, 4),
            "device_ms_per_dispatch_b": round(per_b, 4),
            "delta_ms_per_dispatch": round(per_b - per_a, 4),
            "ratio": round(per_b / per_a, 4) if per_a > 0 else None,
            "bound_by": fb.get("roofline", {}).get("bound_by")
            or fa.get("roofline", {}).get("bound_by"),
        })
    out["kernel_deltas"].sort(key=lambda d: -abs(d["delta_ms_per_dispatch"]))

    def shares(p: dict) -> dict[str, float]:
        host = p.get("host", {})
        total = max(1, int(host.get("samples_total", 0) or 0))
        return {e["frame"]: e["samples"] / total
                for e in host.get("top_frames", [])}

    sa, sb = shares(pa), shares(pb)
    for frame in sorted(set(sa) | set(sb)):
        d = sb.get(frame, 0.0) - sa.get(frame, 0.0)
        out["frame_deltas"].append({
            "frame": frame,
            "share_a": round(sa.get(frame, 0.0), 4),
            "share_b": round(sb.get(frame, 0.0), 4),
            "delta_share": round(d, 4),
        })
    out["frame_deltas"].sort(key=lambda d: -abs(d["delta_share"]))
    out["dominant_kernel"] = (out["kernel_deltas"][0]
                              if out["kernel_deltas"] else None)
    out["dominant_frame"] = (out["frame_deltas"][0]
                             if out["frame_deltas"] else None)
    mfu_a = pa.get("mfu_rolling")
    mfu_b = pb.get("mfu_rolling")
    if mfu_a is not None and mfu_b is not None:
        out["mfu_rolling_delta"] = round(float(mfu_b) - float(mfu_a), 6)
    return out
