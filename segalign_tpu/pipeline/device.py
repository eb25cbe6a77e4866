"""Per-chunk device pipeline: seeds -> hits -> extension -> candidates.

This is the JAX replacement for SeedAndFilter
(/root/reference/src/seed_filter.cu:682-828). Differences by design:

  - No device checkout pool: each DeviceAligner owns one JAX device and
    receives whole chunks; parallelism comes from batching.
  - The sequence blocks, seed tables, and seeds stay resident on device;
    only scalars and compacted candidate HSPs cross the host boundary.
  - Hit batching: the reference dedups per iteration batch of at most
    MAX_HITS hits (memory-bound on GPU). We keep the same LOGICAL batch
    boundaries for output parity (config.max_hits), but process each batch
    in fixed HBUF-sized device buffers independent of that setting.
  - Entropy finalization and dedup run on host (float64 + thrust-exact
    chains); see ops/finalize.py and ops/dedup.py.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.seed_table import build_seed_table
from ..ops.extend import extend_hits, pad_sequence, pad_sequence_2d
from ..ops.seeding import chunk_seeds
from ..ops.hits import expand_hits, compact_mask
from ..ops.finalize import finalize_candidates
from ..ops.dedup import dedup_pairwise, dedup_rm
from ..ops.scan_utils import robust_call

# Iteration-batch size: the reference's MAX_HITS_PER_GB (4194304) times a
# fixed 16 GB. It decides the dedup batch boundaries, hence the output; it
# is not read from the card's memory.
DEFAULT_MAX_HITS = 4194304 * 16

# SEGALIGN_DEVICE_SEEDING=1 forces the on-device seeding/expansion path
# (kept for tests and as a fallback); default is the host-native seeder
# (native/seeder.cpp).
_FORCE_DEVICE_SEEDING = os.environ.get("SEGALIGN_DEVICE_SEEDING", "") == "1"

# SEGALIGN_TIMING=1 prints per-stage device timings to stderr
_TIMING = os.environ.get("SEGALIGN_TIMING", "") == "1"


def _sync_on() -> bool:
    # SEGALIGN_SYNC=1 synchronizes after every device program (debugging
    # + serial stage-time measurement; read dynamically so bench.py's
    # breakdown pass can flip it mid-process)
    return os.environ.get("SEGALIGN_SYNC", "") == "1"


def _dbg_sync(tag, x):
    if _sync_on():
        try:
            jax.block_until_ready(x)
        except Exception as e:
            raise RuntimeError(f"device program failed at stage "
                               f"'{tag}': {e}") from e


# Cumulative per-stage host time across all chunks in this process
# (seconds). Host-thread attribution: under async dispatch, "extend"
# is dispatch time and the device wait surfaces in finish's "d2h".
# bench.py reads this for the wall-time breakdown artifact; reset with
# reset_stage_totals().
STAGE_TOTALS: dict = {}


def reset_stage_totals():
    STAGE_TOTALS.clear()


class _StageTimer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.t = {}

    def add(self, name, dt):
        if self.enabled:
            self.t[name] = self.t.get(name, 0.0) + dt
        STAGE_TOTALS[name] = STAGE_TOTALS.get(name, 0.0) + dt

    def dump(self, prefix):
        if self.enabled and self.t:
            import sys
            parts = " ".join(f"{k}={v*1000:.1f}ms"
                             for k, v in sorted(self.t.items()))
            print(f"[timing] {prefix}: {parts}", file=sys.stderr, flush=True)


@functools.partial(
    jax.jit, static_argnames=("HBUF", "rm_window"))
def _expand_and_mask(cum, starts, qpos, pos_table, g0, g1, seed_size,
                     win_lo, win_hi, *, HBUF: int, rm_window: bool):
    """Program 1 per hit subrange: expand hits (+ RM window mask).

    Kept as its own program rather than fused with the extension
    windows (the device-seeding path steps its windows from the host)."""
    ref_loc, query_loc, valid = expand_hits(
        cum, starts, qpos, pos_table, g0, g1, seed_size, HBUF=HBUF)
    if rm_window:
        valid = valid & (ref_loc >= win_lo) & (ref_loc <= win_hi)
    return ref_loc, query_loc, valid


def _process_hit_range(ref_pad, query_pad, pos_table, cum, starts, qpos,
                       sub_flat, g0, g1, ref_len, query_len, xdrop,
                       hspthresh, seed_size, win_lo, win_hi, *,
                       HBUF: int, B: int, W: int, pad: int, rm_window: bool,
                       twophase: bool):
    """Expand hits [g0, g1), extend, compact candidates.

    Fast path: two device programs + two packed syncs. Hits whose extension
    outruns the first 512-wide window (rare) take extra window-step calls.
    `twophase=False` selects the lax.while_loop engine (test path)."""
    if not twophase:
        ref_loc, query_loc, valid = expand_hits(
            cum, starts, qpos, pos_table, g0, g1, seed_size, HBUF=HBUF)
        if rm_window:
            valid = valid & (ref_loc >= win_lo) & (ref_loc <= win_hi)
        res = extend_hits(ref_pad, query_pad, ref_loc, query_loc, valid,
                          sub_flat, xdrop, hspthresh, ref_len, query_len,
                          pad=pad, W=W)
        return compact_mask(res["candidate"], res["rs"], res["qs"],
                            res["length"], res["total"], res["counts"])

    from ..ops.extend3 import extend_hits_windowed
    ref_loc, query_loc, valid = robust_call(
        _expand_and_mask,
        cum, starts, qpos, pos_table, g0, g1, seed_size, win_lo, win_hi,
        HBUF=HBUF, rm_window=rm_window)
    _dbg_sync("expand", valid)
    res = extend_hits_windowed(
        ref_pad, query_pad, ref_loc, query_loc, valid, sub_flat, xdrop,
        hspthresh, ref_len, query_len, pad=pad, W=pad)
    _dbg_sync("extend", res["total"])
    return robust_call(compact_mask, res["candidate"], res["rs"],
                       res["qs"], res["length"], res["total"],
                       res["counts"])


@jax.jit
def _lower_bound_step(cum, limit):
    """One lower_bound of the iteration-batching chain
    (seed_filter.cu:732-738): returns (pos, cum[pos])."""
    pos = jnp.searchsorted(cum, limit, side="left").astype(jnp.int32) - 1
    val = jnp.where(pos >= 0, jnp.take(cum, jnp.maximum(pos, 0)), 0)
    return pos, val


def _plan_limits(cum, num_hits: int, max_hits: int, num_iter: int):
    """Host-driven iteration-batching chain (seed_filter.cu:718-741).
    num_iter is small (num_hits // max_hits + 2), so a host loop with one
    tiny device call per step beats a scanned program."""
    poss = []
    vals = []
    limit = min(num_hits, max_hits)
    for _ in range(num_iter - 1):
        pos, val = robust_call(_lower_bound_step, cum, limit)
        pos, val = int(pos), int(val)
        poss.append(pos)
        vals.append(val)
        limit = min(val + max_hits, num_hits)
    return poss, vals


@dataclass
class ChunkResult:
    hsps: np.ndarray       # (n, 4) int64: ref_start, query_start, len, score
    num_hits: int
    num_seeds: int


@dataclass
class PendingChunk:
    """In-flight device work for one chunk (native path).

    Device programs are dispatched but NOT synced; finish_chunk() collects
    them. This is the unit of software pipelining: while the device chews
    on chunk k's programs, the host seeds chunk k+1 and finalizes chunk
    k-1 (the TBB reader/seeder/printer overlap of the reference,
    /root/reference/src/main.cpp:553-573, re-expressed as async dispatch).
    """
    chunk_start: int
    chunk_end: int
    rev: bool
    num_seeds: int
    num_hits: int
    # per-program raw finalize fields (device arrays), kept until finish
    # so a TBUF escalation only re-runs the cheap compaction program
    fins: list
    # global compaction results: total (device int32 scalar) and
    # out (TBUF, 5) int32 with all candidates stably packed at the front.
    # finish fetches total, then ONE bucketed slice of out — candidate
    # D2H volume is proportional to the true candidate count, not to
    # programs x buffer width, and a chunk costs two device_gets
    total: Optional[object]
    out: Optional[object]
    # logical-batch boundaries (reference max_hits iteration batching)
    # as end offsets into the filtered row stream
    seg_ends: np.ndarray
    # filtered hit stream kept on host for the rare CBUF-overflow re-run
    ref_loc: Optional[np.ndarray] = None
    query_loc: Optional[np.ndarray] = None
    # whether _pack_compact ran with exact-duplicate removal; the
    # escalated recompact must match (d_seg: the committed device
    # seg_ends array it used)
    dedup_exact: bool = False
    d_seg: Optional[object] = None


# sentinel "orig" value for invalid rows: above any real hit index (hits
# per chunk-strand are far below 2^30)
ORIG_INVALID = 1 << 30


def _pow2_rows(host2d: np.ndarray) -> np.ndarray:
    """Round a (rows, 128) padded sequence up to a power-of-two row
    count (fill 6 = '&' wall, same as the other pads).

    Sequence buffers are the only genome-sized arrays that appear in
    executable signatures; without bucketing, EVERY distinct block
    length recompiles the whole executable set (a 16 Mbp CLI run spent
    ~20 min in fresh remote compiles). With pow2 buckets, genomes within
    a factor of two share every executable — at most 2x HBM on the
    sequence buffers, which are small next to the extension state.
    Correctness is unaffected: window starts are clamped to the buffer
    and the in-bounds masks use the TRACED ref_len/query_len scalars."""
    r = host2d.shape[0]
    r2 = 1 << (r - 1).bit_length()
    if r2 == r:
        return host2d
    return np.vstack([host2d,
                      np.full((r2 - r, 128), 6, np.uint8)])


# Serializes FIRST-time compiles across host threads: concurrent cold
# compiles from N threads crashed XLA's compiler in an earlier
# environment (see MultiDeviceAligner.map_chunks); not re-checked on
# GPUs. Worker dispatch threads take it for their first chunk;
# finish-side lazy compiles (the rare escalated recompact — its pow2 width
# class may be new) take it here so a finisher thread can't race another
# thread's cold compile.
import threading
COMPILE_LOCK = threading.Lock()


@functools.partial(jax.jit, static_argnames=("TBUF", "dedup_exact"))
def _pack_compact(fins, seg_ends=None, *, TBUF: int,
                  dedup_exact: bool = False):
    """Compact the candidates of ALL per-program extension results into
    one (TBUF, 5) int32 block: orig_hit_idx, rs, qs, length, total.
    Row-engine fins arrive with MONOTONE orig (each program's orig is
    g0 + arange, programs stacked ascending, dummies — orig
    ORIG_INVALID — are never candidates), so cumsum-selection in row
    order already yields candidates in original hit order; no argsort
    needed (a stable sort at P x B rows was the expensive part of this
    program). The host's logical-batch split stays exact.

    dedup_exact: drop candidates whose (rs, qs, length) extent exactly
    equals another candidate's in the SAME logical batch (seg_ends: the
    reference dedups per max_hits batch; rows are bucketed by
    searchsorted over their orig exactly like the host split).
    Bit-exact: identical extents have identical totals and entropy
    counts, hence identical entropy scores and acceptance, and
    thrust::unique_copy's
    compare-against-last-KEPT chain is invariant under removing elements
    it would drop — for exact duplicates, whatever drops/keeps the first
    occurrence forces the same decision on the rest (the last-kept
    element at the later occurrence has the same rs or a >= end).
    Tandem-repeat diagonals produce thousands of hits that all extend to
    the SAME maximal segment: one bench chunk had 779k candidates with
    2.3k unique extents, costing a 28 MB fetch + 3 s host dedup + an
    escalated recompact — this one device sort removes all of it.

    The on-device analog of compress_output + the D2H copy
    (/root/reference/src/seed_filter.cu:654-680,788), done once per
    chunk-strand instead of once per program."""
    from ..ops.extend_fused import _alive_prefix
    cand = jnp.concatenate([f["candidate"] for f in fins])
    orig = jnp.concatenate([f["orig"] for f in fins])
    n = cand.shape[0]
    if dedup_exact:
        # TWO int32 sort keys: (non-candidate bit << 30 | rs, qs) — block
        # coords stay < 2^30 (blocks are <= 500 MB). length and the
        # logical-batch id ride as PAYLOAD: a duplicate is only dropped
        # when its sorted neighbor matches on all of (rs, qs, length,
        # seg), so rows from different batches never dedup against each
        # other, and identical triples separated by a different-length
        # row within an equal (rs, qs) run are MISSED — harmless, the
        # host chain still removes them; any surviving representative is
        # equivalent because outputs carry extent values, not hit
        # identity.
        flat = lambda k: jnp.concatenate([f[k].reshape(-1) for f in fins])
        rs_f, qs_f, ln_f = flat("rs"), flat("qs"), flat("length")
        seg = jnp.searchsorted(seg_ends, orig,
                               side="right").astype(jnp.int32)
        idx = jnp.arange(n, dtype=jnp.int32)
        nc = jnp.logical_not(cand)
        k1 = jnp.where(nc, jnp.int32(1) << 30, 0) + rs_f
        s_k1, s_qs, s_ln, s_seg, s_idx = jax.lax.sort(
            (k1, qs_f, ln_f, seg, idx), num_keys=2)
        live = s_k1 < (1 << 30)
        dup = ((s_k1[1:] == s_k1[:-1]) & (s_qs[1:] == s_qs[:-1])
               & (s_ln[1:] == s_ln[:-1]) & (s_seg[1:] == s_seg[:-1])
               & live[1:])
        keep_sorted = live & jnp.concatenate(
            [jnp.ones(1, bool), jnp.logical_not(dup)])
        cand = jnp.zeros(n, bool).at[s_idx].set(keep_sorted)
    total = jnp.sum(cand.astype(jnp.int32))
    sel, _ = _alive_prefix(jnp.logical_not(cand), min(TBUF, n))
    sel = sel.astype(jnp.int32)
    out = jnp.stack([
        jnp.take(jnp.concatenate([f[k] for f in fins]), sel)
        for k in ("orig", "rs", "qs", "length", "total")], axis=1)
    return total, out


# committed per-device cache of in-order orig index arrays, keyed by
# (device, g0, B). MUST be committed with device_put: an uncommitted jit
# output flips the argument-commitment pattern seen by _pack_compact,
# and jax caches executables per commitment pattern — each new pattern
# recompiled the (expensive, ~11 s) compaction program mid-run.
_ORIG_CACHE: dict = {}


def _orig_range(device, g0: int, B: int):
    key = (id(device), g0, B)
    if key not in _ORIG_CACHE:
        _ORIG_CACHE[key] = jax.device_put(
            np.arange(g0, g0 + B, dtype=np.int32), device)
    return _ORIG_CACHE[key]


@functools.partial(jax.jit, static_argnames=("k",))
def _slice_rows(a, *, k: int):
    """Front-slice for the bucketed candidate fetch (one cached
    executable per bucket size)."""
    return a[:k]


# Fetch-bucket ladder: SMALL (covers typical chunk-strands cheaply) or the
# full compaction width. Kept to two sizes on purpose: every distinct
# static shape is a separate executable, and a finer ladder would compile
# mid-run on each first use. Both sizes are prewarmed in set_ref. The
# ladder is untuned on the H100.
_BUCKET_SMALL = 2048


def _bucket_for(total: int, cap: int) -> int:
    """Fetch bucket >= total, clamped to cap."""
    return min(_BUCKET_SMALL if total <= _BUCKET_SMALL else cap, cap)


class DeviceAligner:
    """Holds device-resident state for one (ref block, query block) pair and
    runs per-chunk seed-filter-extend calls."""

    def __init__(self, *, shape_pos, seed_size, transition, step, sub_mat,
                 xdrop, hspthresh, noentropy, chunk_size,
                 max_hits: int = DEFAULT_MAX_HITS, HBUF: int = 1 << 17,
                 B: int = 1 << 14, W: int = 128, rm_mode: bool = False,
                 twophase: bool = True, window: int = 512, device=None,
                 CBUF: int = 0):
        self.shape_pos = tuple(shape_pos)
        self.seed_size = seed_size
        self.kmer_size = len(shape_pos)
        self.transition = transition
        self.step = step
        self.xdrop = xdrop
        self.hspthresh = hspthresh
        self.noentropy = noentropy
        self.chunk_size = chunk_size
        self.max_hits = max_hits
        # Extension schedule. The defaults below are untuned on the H100;
        # every one is scheduling only (results are exact for any value).
        # HBUF: max rows per extension program; actual program size is
        # pow2-bucketed to the strand's hit count (dispatch_chunk).
        self.HBUF = int(os.environ.get("SEGALIGN_HBUF", "0")) or HBUF
        # CONT: live-row capacity of one continuation round
        # (extend_fused._run_tail)
        self.CONT = int(os.environ.get("SEGALIGN_CONT", "0")) or 16384
        # CBUF: global candidate-compaction width per chunk-strand: all
        # programs' candidates are packed into one (CBUF, 5) device block
        # before D2H (_pack_compact); the fetch is bucketed by the true
        # candidate count. Overflow -> one re-compaction at escalated
        # width, no re-extension (finish_chunk).
        self.CBUF = (CBUF or int(os.environ.get("SEGALIGN_CBUF", "0"))
                     or 16384)
        self.B = B
        self.W = W
        self.twophase = twophase
        # W_CONT: continuation window width (rows surviving the first
        # window are long extensions); UNROLL: continuation window steps
        # per while_loop iteration
        self.W_CONT = int(os.environ.get("SEGALIGN_WCONT", "0")) or 2048
        self.UNROLL = int(os.environ.get("SEGALIGN_UNROLL", "0")) or 2
        # the extender reads up to max(window, W_CONT) positions either
        # side of each anchor, and XLA's dynamic_slice clamps an
        # out-of-range start silently, so each side is padded by at least
        # the widest window
        self.pad = (max(W, window, self.W_CONT, 512)
                    if twophase else W)
        # ext_window: first-window width (SEGALIGN_WINDOW overrides; any
        # width is exact, oracle/scan_spec.py)
        self.ext_window = (int(os.environ.get("SEGALIGN_WINDOW", "0"))
                           or window)
        # sequence-padding row geometry (pad_sequence_2d)
        self.TROWS = 768
        self.TQROWS = self.TROWS
        self.rm_mode = rm_mode
        if device is None:
            platform = os.environ.get("SEGALIGN_DEVICES") or None
            device = jax.devices(platform)[0]
        self.device = device
        self.sub_flat = jax.device_put(
            jnp.asarray(np.asarray(sub_mat).reshape(-1), dtype=jnp.int32),
            self.device)
        self.ref_pad = None
        self.ref_len = 0
        self.index_table = None
        self.pos_table = None
        self.q_fw = None
        self.q_rc = None
        self.q_len = 0
        self._native_seeder = None
        if not _FORCE_DEVICE_SEEDING:
            from ..native import ChunkSeeder, get_lib
            if get_lib() is not None:
                self._native_seeder = ChunkSeeder(
                    chunk_size, self.kmer_size, transition)
        self._host_tables = None  # (index_table, pos_table) numpy
        self._q_fw_host = None
        self._q_rc_host = None
        self._dummy_fin_cache = None
        from collections import OrderedDict
        self._seg_cache: "OrderedDict" = OrderedDict()

    def _dummy_fin(self, size: int):
        """All-invalid extension-result fields used to pad the program
        list of _pack_compact to a power-of-two size class."""
        if self._dummy_fin_cache is None:
            self._dummy_fin_cache = {}
        if size not in self._dummy_fin_cache:
            z = jnp.zeros((size,), jnp.int32)
            self._dummy_fin_cache[size] = {
                k: jax.device_put(v, self.device)
                for k, v in dict(
                    candidate=jnp.zeros((size,), bool),
                    rs=z, qs=z, length=z, total=z,
                    orig=jnp.full((size,), ORIG_INVALID,
                                  jnp.int32)).items()}
        return self._dummy_fin_cache[size]

    def _warm_fetch_paths(self):
        """Compile the candidate-fetch slice executables up front, so no
        chunk stalls on a first-use compile."""
        dummy = jax.device_put(jnp.zeros((self.CBUF, 5), jnp.int32),
                               self.device)
        for k in (_BUCKET_SMALL, self.CBUF):
            if k <= self.CBUF:
                _slice_rows(dummy, k=k)

    # -- block management (analog of SendRefWriteRequest / SendQuery...) ----

    def set_ref(self, ref_codes: np.ndarray, tables=None):
        """tables: optional precomputed (index_table, pos_table) so a shared
        host build can be replicated across devices (the reference uploads
        one host-built table to every GPU, seed_pos_table.cu:33-47)."""
        self.ref_len = len(ref_codes)
        self._ref_host = np.ascontiguousarray(ref_codes, np.uint8)
        self._warm_fetch_paths()
        if self._native_seeder is not None:
            # 2-D padded host layout, flattened for the extension programs
            host2d = _pow2_rows(pad_sequence_2d(
                ref_codes, self.pad, self.TROWS, 512, extra_right=self.pad))
            self.ref_pad = jax.device_put(host2d.reshape(-1), self.device)
        else:
            self.ref_pad = jax.device_put(
                pad_sequence(ref_codes, self.pad), self.device)
        if tables is None:
            tables = build_seed_table(
                ref_codes, self.step, self.shape_pos, self.seed_size,
                self.kmer_size)
        index_table, pos_table = tables
        self._host_tables = (np.ascontiguousarray(index_table, np.int32),
                             np.ascontiguousarray(pos_table, np.int32))
        if self._native_seeder is not None:
            # host seeding: the (large) tables never leave host memory
            self.index_table = None
            self.pos_table = None
            return
        self.index_table = jax.device_put(index_table, self.device)
        if len(pos_table) == 0:
            pos_table = np.zeros(1, np.int32)
        self.pos_table = jax.device_put(pos_table, self.device)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        self.q_len = len(fw_codes)
        rp = max(self.pad, self.chunk_size + self.seed_size + 1)
        if self._native_seeder is not None:
            def mk(c):
                h2d = _pow2_rows(pad_sequence_2d(
                    c, self.pad, self.TQROWS, 512, extra_right=rp))
                return jax.device_put(h2d.reshape(-1), self.device)

            self.q_fw = mk(fw_codes)
            self.q_rc = mk(rc_codes)
        else:
            self.q_fw = jax.device_put(pad_sequence(fw_codes, self.pad, rp),
                                       self.device)
            self.q_rc = jax.device_put(pad_sequence(rc_codes, self.pad, rp),
                                       self.device)
        self._q_fw_host = np.ascontiguousarray(fw_codes, np.uint8)
        self._q_rc_host = np.ascontiguousarray(rc_codes, np.uint8)

    def map_chunks(self, work, depth: int = 4, on_result=None):
        """Pipelined chunk processing (MultiDeviceAligner-compatible).

        Keeps up to `depth` chunks in flight: host seeding of chunk k+1 and
        host finalize/dedup of chunk k-depth overlap the device programs of
        chunks k-depth+1..k (JAX async dispatch). finish_chunk runs on a
        dedicated finisher thread (SEGALIGN_OVERLAP=0 restores the serial
        form): the dispatch thread's native seeding/planning (ctypes, GIL
        released) then overlaps the finisher's blocking candidate fetches
        and numpy finalize/dedup — the reference gets the same overlap from
        separate TBB seeder/printer nodes (src/main.cpp:553-573).

        on_result(index, ChunkResult), when given, fires as each chunk
        finishes (in work order) so a downstream stage can consume HSPs
        while the device still chews on later chunks — the hook the
        reference's driver gets for free by eval-ing lastz commands as
        segalign prints them (scripts/run_segalign:112-117)."""
        def emit(i, r):
            if on_result is not None:
                on_result(i, r)
            return r

        if self._native_seeder is None:
            return [emit(i, self.seed_and_filter(
                w.chunk_start, w.chunk_end, w.rev, window=w.window))
                for i, w in enumerate(work)]
        from collections import deque
        pend: "deque" = deque()
        if os.environ.get("SEGALIGN_OVERLAP", "") == "0" or len(work) <= 1:
            results = []
            for i, w in enumerate(work):
                pend.append((i, self.dispatch_chunk(
                    w.chunk_start, w.chunk_end, w.rev, window=w.window)))
                if len(pend) > depth:
                    j, pd = pend.popleft()
                    results.append(emit(j, self.finish_chunk(pd)))
            while pend:
                j, pd = pend.popleft()
                results.append(emit(j, self.finish_chunk(pd)))
            return results
        from concurrent.futures import ThreadPoolExecutor
        results = []
        futs: "deque" = deque()
        with ThreadPoolExecutor(1) as ex:
            for i, w in enumerate(work):
                pend.append((i, self.dispatch_chunk(
                    w.chunk_start, w.chunk_end, w.rev, window=w.window)))
                if len(pend) > depth:
                    j, pd = pend.popleft()
                    futs.append((j, ex.submit(self.finish_chunk, pd)))
                # bound unfetched results: device candidate buffers stay
                # alive until their finish runs
                while len(futs) > depth + 2:
                    j, f = futs.popleft()
                    results.append(emit(j, f.result()))
            while pend:
                j, pd = pend.popleft()
                futs.append((j, ex.submit(self.finish_chunk, pd)))
            while futs:
                j, f = futs.popleft()
                results.append(emit(j, f.result()))
        return results

    # -- per-chunk call (analog of SeedAndFilter) ---------------------------

    def seed_and_filter(self, chunk_start: int, chunk_end: int, rev: bool,
                        window: Optional[Tuple[int, int]] = None
                        ) -> ChunkResult:
        if self._native_seeder is not None:
            return self._seed_and_filter_native(chunk_start, chunk_end, rev,
                                                window)
        return self._seed_and_filter_device(chunk_start, chunk_end, rev,
                                            window)

    def _finalize_batch(self, rs, qs, ln, total, rev: bool):
        """Host entropy finalize + dedup of one logical hit batch.
        Returns an (n, 4) int64 array or None.

        The extension programs keep no entropy match counts; they are
        recomputed here from the final extents, entropy-band rows only
        (out-of-band rows have entropy == 1 and never read counts;
        oracle/scan_spec.py: counts are a pure function of the extents).
        """
        counts = np.zeros((len(rs), 4), np.int64)
        if not self.noentropy:
            from ..native import entropy_counts_host
            band = (total >= self.hspthresh) & (total <= 3 * self.hspthresh)
            if band.any():
                q = self._q_rc_host if rev else self._q_fw_host
                counts[band] = entropy_counts_host(
                    self._ref_host, q, rs[band], qs[band], ln[band])
        accepted, scores = finalize_candidates(
            rs, qs, ln, total, counts, self.hspthresh, self.noentropy)
        if not accepted.any():
            return None
        rs, qs, ln, sc = (rs[accepted], qs[accepted], ln[accepted],
                          scores[accepted])
        if self.rm_mode and rev:
            # minus-strand remap (repeat_masker_src/seed_filter.cu:705-709)
            qs = self.ref_len - 1 - (qs + ln)
        if self.rm_mode:
            rs, qs, ln, sc = dedup_rm(rs, qs, ln, sc)
        else:
            rs, qs, ln, sc = dedup_pairwise(rs, qs, ln, sc)
        return np.stack([rs, qs, ln, sc], axis=1)

    def _seed_and_filter_native(self, chunk_start: int, chunk_end: int,
                                rev: bool,
                                window: Optional[Tuple[int, int]]
                                ) -> ChunkResult:
        return self.finish_chunk(
            self.dispatch_chunk(chunk_start, chunk_end, rev, window))

    def dispatch_chunk(self, chunk_start: int, chunk_end: int, rev: bool,
                       window: Optional[Tuple[int, int]] = None
                       ) -> PendingChunk:
        """Host-native seeding/expansion + async device extension dispatch.

        Seeding, hit expansion and batch planning run in native/seeder.cpp
        (reference-exact); the x-drop extension + candidate compaction run
        on the device as ONE program per HBUF subrange (ops/extend_fused).
        Nothing here blocks on the device."""
        tm = _StageTimer(_TIMING)
        t0 = time.time()
        q_host = self._q_rc_host if rev else self._q_fw_host
        index_table, pos_table = self._host_tables
        ref_loc, query_loc, limit_pos, hit_bound, num_seeds, num_hits = (
            self._native_seeder.seed(
                q_host, chunk_start, chunk_end - chunk_start, index_table,
                pos_table, self.shape_pos, self.seed_size, self.max_hits))
        tm.add("seeds", time.time() - t0)
        empty = PendingChunk(chunk_start, chunk_end, rev, num_seeds,
                             num_hits, [], None, None, np.zeros(0, np.int64))
        if num_seeds == 0 or num_hits == 0:
            return empty

        # RM window restriction + logical-batch boundary remap
        t0 = time.time()
        if window is not None:
            keep = ((ref_loc >= window[0]) & (ref_loc <= window[1]))
            kept_cum = np.cumsum(keep, dtype=np.int64)
            seg_ends = np.array(
                [int(kept_cum[b - 1]) if b > 0 else 0 for b in hit_bound],
                np.int64)
            ref_loc = ref_loc[keep]
            query_loc = query_loc[keep]
        else:
            seg_ends = np.asarray(hit_bound, np.int64)
        n = len(ref_loc)
        tm.add("mask", time.time() - t0)
        if n == 0:
            return empty

        q_pad = self.q_rc if rev else self.q_fw
        fins = self._dispatch_rows(ref_loc, query_loc, q_pad, n, tm)
        t0 = time.time()
        # pad the program list to a power of two with all-invalid dummies:
        # _pack_compact then has one executable per size CLASS instead of
        # one per exact program count
        P = len(fins)
        p_pad = 1 << (P - 1).bit_length()
        dummy_size = fins[-1]["candidate"].shape[0]
        fins_padded = fins + [self._dummy_fin(dummy_size)] * (p_pad - P)
        d_seg = self._seg_ends_dev(seg_ends)
        total, out = _pack_compact(
            fins_padded, d_seg, TBUF=self.CBUF,
            dedup_exact=d_seg is not None)
        _dbg_sync("pack", total)
        tm.add("pack", time.time() - t0)
        tm.dump(f"dispatch {chunk_start}:{chunk_end} rev={rev} "
                f"hits={num_hits}")
        return PendingChunk(chunk_start, chunk_end, rev, num_seeds,
                            num_hits, fins_padded, total, out, seg_ends,
                            ref_loc, query_loc,
                            dedup_exact=d_seg is not None, d_seg=d_seg)

    def _seg_ends_dev(self, seg_ends) -> Optional[object]:
        """Logical-batch end offsets as a committed pow2-padded device
        array for _pack_compact's in-batch exact dedup (None when the
        device dedup is disabled). Padding value 2^30 sorts above every
        real orig, so pad slots never claim rows.

        Small LRU keyed by content: identical seg_ends repeat across
        strands/chunks (e.g. equal hit counts in the common single-batch
        case), and a cached array saves a host-to-device copy."""
        if os.environ.get("SEGALIGN_DEDUP_DEVICE", "") == "0":
            return None
        nb = max(1, len(seg_ends))
        cap = 1 << (nb - 1).bit_length()
        buf = np.full(cap, 1 << 30, np.int32)
        buf[:len(seg_ends)] = np.asarray(seg_ends, np.int64)
        key = (id(self.device), buf.tobytes())
        cached = self._seg_cache.get(key)
        if cached is None:
            cached = jax.device_put(buf, self.device)
            self._seg_cache[key] = cached
            if len(self._seg_cache) > 64:
                self._seg_cache.pop(next(iter(self._seg_cache)))
        else:
            self._seg_cache.move_to_end(key)
        return cached

    def _dispatch_rows(self, ref_loc, query_loc, q_pad, n, tm):
        """Row-order extension programs: one fused device program per
        pow2-bucketed subrange of the hit stream."""
        from ..ops.extend_fused import extend_fields_program
        # pow2-bucketed program sizes: one executable per size CLASS; big
        # strands use HBUF-row programs and the REMAINDER runs at a snug
        # pow2 class (padding rows are scanned like live ones)
        spans = []
        g0 = 0
        while g0 < n:
            rem = n - g0
            B_prog = min(self.HBUF,
                         1 << max(12, (rem - 1).bit_length()))
            spans.append((g0, min(g0 + B_prog, n), B_prog))
            g0 += B_prog
        fins = []
        for g0, g1, B_prog in spans:
            t0 = time.time()
            m = g1 - g0
            buf_r = np.zeros(B_prog, np.int32)
            buf_q = np.zeros(B_prog, np.int32)
            buf_r[:m] = ref_loc[g0:g1]
            buf_q[:m] = query_loc[g0:g1]
            d_r = jax.device_put(buf_r, self.device)
            d_q = jax.device_put(buf_q, self.device)
            tm.add("h2d", time.time() - t0)
            t0 = time.time()
            fin = extend_fields_program(
                self.ref_pad, q_pad, d_r, d_q, m, self.sub_flat,
                self.xdrop, self.hspthresh, self.ref_len, self.q_len,
                pad=self.pad, W=self.ext_window, CONT=self.CONT,
                W_CONT=self.W_CONT, UNROLL=self.UNROLL)
            fin = dict(fin, orig=_orig_range(self.device, g0, B_prog))
            _dbg_sync("extend", fin["candidate"])
            fins.append(fin)
            tm.add("extend", time.time() - t0)
        return fins

    def finish_chunk(self, p: PendingChunk) -> ChunkResult:
        """Collect a dispatched chunk: D2H of compacted candidates, logical
        -batch split, host entropy finalize + dedup."""
        if not p.fins:
            return ChunkResult(np.zeros((0, 4), np.int64), p.num_hits,
                               p.num_seeds)
        tm = _StageTimer(_TIMING)
        t0 = time.time()
        total = int(jax.device_get(p.total))
        out = p.out
        if total > out.shape[0]:
            # rare: more candidates than the compaction buffer — re-run
            # only the (cheap) compaction over the retained extension
            # results at a snug pow2-escalated width (NOT the full
            # P x B_prog width: the escalated fetch below is sized by
            # out.shape[0]); no re-extension
            cap = sum(f["candidate"].shape[0] for f in p.fins)
            with COMPILE_LOCK:
                # may compile a new escalated width class; serialized so a
                # finisher thread never cold-compiles concurrently with a
                # dispatch thread
                _, out = _pack_compact(
                    p.fins, p.d_seg,
                    TBUF=min(1 << (total - 1).bit_length(), cap),
                    dedup_exact=p.dedup_exact)
            tm.add("recompact", time.time() - t0)
        if total == 0:
            tm.dump(f"finish {p.chunk_start}:{p.chunk_end} rev={p.rev}")
            return ChunkResult(np.zeros((0, 4), np.int64), p.num_hits,
                               p.num_seeds)
        k = _bucket_for(total, out.shape[0])
        allrows = np.asarray(
            jax.device_get(_slice_rows(out, k=k))[:total], np.int64)
        tm.add("d2h", time.time() - t0)

        t0 = time.time()
        hsps = self._split_and_finalize(allrows, p)
        tm.add("host_dedup", time.time() - t0)
        tm.dump(f"finish {p.chunk_start}:{p.chunk_end} rev={p.rev} "
                f"cand={len(allrows)}")
        return ChunkResult(hsps, p.num_hits, p.num_seeds)

    def _split_and_finalize(self, allrows: np.ndarray,
                            p: PendingChunk) -> np.ndarray:
        """Logical-batch split (reference max_hits boundaries) + host
        entropy finalize + dedup over fetched candidate rows."""
        seg = np.searchsorted(p.seg_ends, allrows[:, 0], side="right")
        all_out: List[np.ndarray] = []
        for s in np.unique(seg):
            r = allrows[seg == s]
            out_arr = self._finalize_batch(
                r[:, 1], r[:, 2], r[:, 3], r[:, 4], p.rev)
            if out_arr is not None:
                all_out.append(out_arr)
        return (np.concatenate(all_out, axis=0) if all_out
                else np.zeros((0, 4), np.int64))

    def _seed_and_filter_device(self, chunk_start: int, chunk_end: int,
                                rev: bool,
                                window: Optional[Tuple[int, int]] = None
                                ) -> ChunkResult:
        CHUNK = self.chunk_size
        tm = _StageTimer(_TIMING)
        t0 = time.time()
        q = self.q_rc if rev else self.q_fw
        kmers, qpos, valid, starts, cum, stats = robust_call(
            chunk_seeds,
            q, self.index_table, chunk_start, chunk_end - chunk_start,
            CHUNK=CHUNK, seed_size=self.seed_size, shape_pos=self.shape_pos,
            transition=self.transition, pad=self.pad)
        stats = np.asarray(stats)
        num_seeds, num_hits = int(stats[0]), int(stats[1])
        if num_seeds == 0:
            return ChunkResult(np.zeros((0, 4), np.int64), 0, 0)
        tm.add("seeds", time.time() - t0)
        if num_hits == 0:
            return ChunkResult(np.zeros((0, 4), np.int64), 0, num_seeds)

        # logical batch boundaries (reference-exact)
        t0 = time.time()
        if num_hits < self.max_hits:
            num_iter = 2
        else:
            num_iter = num_hits // self.max_hits + 2
        poss, vals = _plan_limits(cum, num_hits, self.max_hits,
                                  num_iter=num_iter)
        tm.add("plan", time.time() - t0)
        poss = np.asarray(poss)
        vals = np.asarray(vals)
        S = int(cum.shape[0])
        limit_pos = list(poss) + [S - 1]
        hit_bound = list(vals) + [num_hits]
        if num_iter >= 2 and limit_pos[-1] == limit_pos[-2]:
            limit_pos.pop()
            hit_bound.pop()

        all_out: List[np.ndarray] = []
        h0 = 0
        for bi in range(len(limit_pos)):
            h1 = int(hit_bound[bi])
            if h1 <= h0:
                continue
            parts = []
            for g0 in range(h0, h1, self.HBUF):
                g1 = min(g0 + self.HBUF, h1)
                win_lo, win_hi = window if window else (0, 0)
                t0 = time.time()
                n, rs, qs, ln, total, counts = _process_hit_range(
                    self.ref_pad, q, self.pos_table, cum, starts, qpos,
                    self.sub_flat, g0, g1, self.ref_len, self.q_len,
                    self.xdrop, self.hspthresh, self.seed_size,
                    win_lo, win_hi, HBUF=self.HBUF, B=self.B, W=self.W,
                    pad=self.pad, rm_window=window is not None,
                    twophase=self.twophase)
                tm.add("extend", time.time() - t0)
                tm.add("nrange", 1e-3)
                t0 = time.time()
                # bulk transfer (slicing device arrays by a dynamic n would
                # compile a new program per distinct n)
                n, rs, qs, ln, total, counts = jax.device_get(
                    (n, rs, qs, ln, total, counts))
                n = int(n)
                if n:
                    parts.append((rs[:n], qs[:n], ln[:n], total[:n],
                                  counts[:n]))
                tm.add("d2h", time.time() - t0)
            h0 = h1
            if not parts:
                continue
            t0 = time.time()
            rs = np.concatenate([p[0] for p in parts]).astype(np.int64)
            qs = np.concatenate([p[1] for p in parts]).astype(np.int64)
            ln = np.concatenate([p[2] for p in parts]).astype(np.int64)
            total = np.concatenate([p[3] for p in parts]).astype(np.int64)
            counts = np.concatenate([p[4] for p in parts]).astype(np.int64)

            accepted, scores = finalize_candidates(
                rs, qs, ln, total, counts, self.hspthresh, self.noentropy)
            if not accepted.any():
                continue
            rs, qs, ln, sc = (rs[accepted], qs[accepted], ln[accepted],
                              scores[accepted])
            if self.rm_mode and rev:
                # minus-strand remap (repeat_masker_src/seed_filter.cu:705-709)
                qs = self.ref_len - 1 - (qs + ln)
            if self.rm_mode:
                rs, qs, ln, sc = dedup_rm(rs, qs, ln, sc)
            else:
                rs, qs, ln, sc = dedup_pairwise(rs, qs, ln, sc)
            all_out.append(np.stack([rs, qs, ln, sc], axis=1))
            tm.add("host_dedup", time.time() - t0)

        hsps = (np.concatenate(all_out, axis=0) if all_out
                else np.zeros((0, 4), np.int64))
        tm.dump(f"chunk {chunk_start}:{chunk_end} rev={rev} "
                f"hits={num_hits}")
        return ChunkResult(hsps, num_hits, num_seeds)
