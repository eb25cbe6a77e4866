"""Single-program x-drop extension: first window + continuation while_loops.

One jitted program extends a whole hit batch to completion (both
directions), replacing the host-stepped window loop of ops/extend3, which
syncs with the host after every window. Extents and totals are identical:
the per-window step is ops/extend3._extension_window_step_jit, or on CUDA
GPUs the Triton kernel ops/window_kernel with bit-identical results
(_step); its tile-width independence is property-tested against the
reference tile-32 algorithm (oracle/scan_spec.py; the reference's CUDA
source, src/seed_filter.cu:232-652). The program keeps no entropy
match counts: they are a pure function of the final extents, and the
host recomputes them for the candidates that need them
(pipeline/device.DeviceAligner._finalize_batch).

Program structure per direction:
  1. one dense window step over the full (HBUF,) batch at width W
  2. lax.while_loop of full-batch steps while more than CONT rows live
     (rare: only repeat-dense batches)
  3. stable-argsort compaction of the <= CONT live rows, then a
     lax.while_loop of (CONT, W)-shaped steps until all rows terminate
  4. merge compacted state back (gather-only, as extend3._scatter_rows)
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from . import window_kernel
from .extend3 import _extension_window_step_jit, _finalize

_STATE = ("done", "cum", "maxv", "maxp")


# SEGALIGN_JOINT_TAIL=0 restores the serial per-direction continuation
_USE_JOINT_TAIL = os.environ.get("SEGALIGN_JOINT_TAIL", "") != "0"


def _xla_step(seq_r, seq_q, loc_r, loc_q, tile, done, cum, maxv, maxp,
              sub_flat, xdrop, ref_len, query_len, *, pad, W, left):
    z = jnp.zeros((loc_r.shape[0], 4), jnp.int32)
    out = _extension_window_step_jit.__wrapped__(
        seq_r, seq_q, loc_r, loc_q, tile, done, cum, maxv, maxp, z, z,
        sub_flat, xdrop, ref_len, query_len, pad=pad, W=W, left=left,
        with_counts=False)
    return {k: out[k] for k in _STATE}, out["n_alive"]


def _kernel_step(*args, pad, W, left):
    o_done, o_cum, o_maxv, o_maxp = window_kernel.window_step_kernel(
        *args, pad=pad, W=W, left=left)
    out = dict(done=o_done, cum=o_cum, maxv=o_maxv, maxp=o_maxp)
    return out, jnp.sum(jnp.logical_not(o_done).astype(jnp.int32))


def _step(seq_r, seq_q, loc_r, loc_q, tile, st, sub_flat, xdrop, ref_len,
          query_len, *, pad, W, left):
    """One window step. The platform picks the implementation when the
    program is lowered: the Triton kernel (ops/window_kernel) on CUDA
    GPUs, the XLA step elsewhere."""
    args = (seq_r, seq_q, loc_r, loc_q, jnp.asarray(tile, jnp.int32),
            st["done"], st["cum"], st["maxv"], st["maxp"], sub_flat, xdrop,
            ref_len, query_len)
    kw = dict(pad=pad, W=W, left=left)
    return jax.lax.platform_dependent(
        *args, cuda=functools.partial(_kernel_step, **kw),
        default=functools.partial(_xla_step, **kw))


def _alive_prefix(done, K: int):
    """Indices of the first K alive rows (in row order) plus each row's
    inclusive alive-rank cumsum — WITHOUT a full argsort.

    The previous compaction spent two stable B-row argsorts per cohort
    round (the dominant cost of the continuation at B = 2^18 when only
    ~1% of rows survive the first window); a blocked cumsum plus a
    K-query searchsorted does the same selection in O(B) adds. For
    j >= n_alive the index clamps to B-1 (a duplicate row): harmless —
    duplicate rows are either done (step no-ops) or merged back by rank,
    which picks each alive row's single true slot."""
    from .scan_utils import blocked_cumsum
    B = done.shape[0]
    cum = blocked_cumsum(jnp.logical_not(done).astype(jnp.int32))
    tgt = jnp.searchsorted(
        cum, jnp.arange(1, K + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    return jnp.minimum(tgt, B - 1), cum


def _merge_back(cst, st, cum, K: int):
    """Sort/scatter-free merge: alive rows of `st` with rank < K take the
    cohort result, everything else keeps its old state. `cum` is the
    alive-rank cumsum of st['done'] that selected the cohort."""
    rank = jnp.clip(cum - 1, 0, K - 1)
    sel = jnp.logical_not(st["done"]) & (cum <= K)
    out = {}
    for kk in _STATE:
        out[kk] = jnp.where(sel, jnp.take(cst[kk], rank, axis=0), st[kk])
    return out


def _cont_loop(seq_r, seq_q, c_lr, c_lq, cst, tile0, n_alive, sub_flat,
               xdrop, ref_len, query_len, *, pad, Wc, UNROLL, left,
               stop=0):
    """Continuation while_loop: UNROLL window steps of width Wc per
    iteration. The data-dependent loop condition is read back every
    iteration (its cost on the H100 is not measured), so each iteration
    advances several windows; overshooting a finished batch is exact
    (steps are no-ops for done rows).

    Runs while more than `stop` rows are alive; returns (tile, state,
    n_alive) so a caller can recompact the survivors into a smaller batch
    (_cont_cascade)."""
    def cond(c):
        return c[2] > stop

    def body(c):
        tile, s, na = c
        for _ in range(UNROLL):
            s, na = _step(seq_r, seq_q, c_lr, c_lq, tile, s, sub_flat,
                          xdrop, ref_len, query_len, pad=pad, W=Wc,
                          left=left)
            tile = tile + Wc
        return tile, s, na

    return jax.lax.while_loop(cond, body, (tile0, cst, n_alive))


def _cont_cascade(seq_r, seq_q, c_lr, c_lq, cst, tile0, n_alive, sub_flat,
                  xdrop, ref_len, query_len, *, pad, Wc, UNROLL, left,
                  sizes):
    """Run a cohort to completion through a cascade of shrinking batches.

    Window steps cost batch-linear work whether rows are alive or done;
    long extensions (tens of kb) keep only a handful of rows alive after
    the first few windows. So: step the full cohort while more than
    sizes[0] rows live, compact the survivors into a sizes[0]-row batch
    (they all sit at the same tile), recurse. Scheduling only — each
    row's extension is independent, so results are bit-identical. The
    deep tail of an extension then runs at sizes[-1]-row cost instead of
    the full cohort's."""
    if not sizes:
        _, cst, _ = _cont_loop(seq_r, seq_q, c_lr, c_lq, cst, tile0,
                               n_alive, sub_flat, xdrop, ref_len,
                               query_len, pad=pad, Wc=Wc, UNROLL=UNROLL,
                               left=left)
        return cst
    nxt = sizes[0]
    tile, cst, na = _cont_loop(seq_r, seq_q, c_lr, c_lq, cst, tile0,
                               n_alive, sub_flat, xdrop, ref_len,
                               query_len, pad=pad, Wc=Wc, UNROLL=UNROLL,
                               left=left, stop=nxt)
    tgt, cum = _alive_prefix(cst["done"], nxt)
    take = lambda a: jnp.take(a, tgt, axis=0)
    sst = {kk: take(cst[kk]) for kk in _STATE}
    s_na = jnp.minimum(na, nxt)
    sst = _cont_cascade(seq_r, seq_q, take(c_lr), take(c_lq), sst, tile,
                        s_na, sub_flat, xdrop, ref_len, query_len,
                        pad=pad, Wc=Wc, UNROLL=UNROLL, left=left,
                        sizes=sizes[1:])
    return _merge_back(sst, cst, cum, nxt)


_CASCADE_ENV = os.environ.get("SEGALIGN_CASCADE", "")


def _cascade_sizes(CONT):
    """Shrinking cohort sizes: ONE stage at CONT/4 (floor 128). Each
    stage is its own data-dependent while_loop, so the ladder stays
    short. Untuned on the H100. SEGALIGN_CASCADE="2048,512" overrides for
    re-tuning; SEGALIGN_CASCADE=none disables."""
    if _CASCADE_ENV == "none":
        return ()
    if _CASCADE_ENV:
        sizes = tuple(int(x) for x in _CASCADE_ENV.split(",")
                      if 0 < int(x) < CONT)
        assert all(s & (s - 1) == 0 for s in sizes), sizes  # pow2 only
        return sizes
    return tuple(s for s in (CONT // 4,) if s >= 128)


def _cont_loop_joint(seq_r, seq_q, R, L, tile0, na_r, na_l, sub_flat,
                     xdrop, ref_len, query_len, *, pad, Wc, UNROLL,
                     stop=0):
    """Both directions' continuation loops fused into ONE while_loop.

    R/L are (loc_r, loc_q, state) for the right/left cohorts (selected
    independently — different rows survive each direction). Each
    iteration advances BOTH cohorts UNROLL windows; the loop runs while
    EITHER side has more than `stop` rows alive. Scheduling-only: a
    finished cohort's steps are no-ops. Halves the number of
    data-dependent while iterations vs running the directions serially —
    each iteration stalls the device pipeline, so iteration count is the
    continuation's fixed cost."""
    (lr_r, lq_r, st_r), (lr_l, lq_l, st_l) = R, L

    def cond(c):
        return jnp.maximum(c[2], c[4]) > stop

    def body(c):
        tile, sr, nr, sl, nl = c
        for _ in range(UNROLL):
            sr, nr = _step(seq_r, seq_q, lr_r, lq_r, tile, sr, sub_flat,
                           xdrop, ref_len, query_len, pad=pad, W=Wc,
                           left=False)
            sl, nl = _step(seq_r, seq_q, lr_l, lq_l, tile, sl, sub_flat,
                           xdrop, ref_len, query_len, pad=pad, W=Wc,
                           left=True)
            tile = tile + Wc
        return tile, sr, nr, sl, nl

    return jax.lax.while_loop(
        cond, body, (tile0, st_r, na_r, st_l, na_l))


def _cont_cascade_joint(seq_r, seq_q, R, L, tile0, na_r, na_l, sub_flat,
                        xdrop, ref_len, query_len, *, pad, Wc, UNROLL,
                        sizes):
    """Joint-direction analog of _cont_cascade: shrink both cohorts
    through the same size ladder, selecting each direction's survivors
    independently at every stage. Returns (st_right, st_left)."""
    tile, sr, nr, sl, nl = _cont_loop_joint(
        seq_r, seq_q, R, L, tile0, na_r, na_l, sub_flat, xdrop, ref_len,
        query_len, pad=pad, Wc=Wc, UNROLL=UNROLL,
        stop=sizes[0] if sizes else 0)
    if not sizes:
        return sr, sl
    nxt = sizes[0]

    def shrink(lr, lq, st):
        tgt, cum = _alive_prefix(st["done"], nxt)
        take = lambda a: jnp.take(a, tgt, axis=0)
        return (take(lr), take(lq), {kk: take(st[kk]) for kk in _STATE},
                cum)

    (lr_r, lq_r, _), (lr_l, lq_l, _) = R, L
    r_lr, r_lq, r_st, cum_r = shrink(lr_r, lq_r, sr)
    l_lr, l_lq, l_st, cum_l = shrink(lr_l, lq_l, sl)
    sub_r, sub_l = _cont_cascade_joint(
        seq_r, seq_q, (r_lr, r_lq, r_st), (l_lr, l_lq, l_st), tile,
        jnp.minimum(nr, nxt), jnp.minimum(nl, nxt), sub_flat, xdrop,
        ref_len, query_len, pad=pad, Wc=Wc, UNROLL=UNROLL, sizes=sizes[1:])
    return (_merge_back(sub_r, sr, cum_r, nxt),
            _merge_back(sub_l, sl, cum_l, nxt))


def _run_tails_joint(seq_r, seq_q, loc_r, loc_q, st_r, na_r, st_l, na_l,
                     sub_flat, xdrop, ref_len, query_len, *, pad, W, CONT,
                     W_CONT=0, UNROLL=4):
    """Continue BOTH directions after their first windows with shared
    while_loops (see _cont_loop_joint). Same contract as two _run_tail
    calls; bit-identical results, ~half the loop iterations."""
    Wc = W_CONT or W
    B = loc_r.shape[0]
    kw = dict(pad=pad, Wc=Wc, UNROLL=UNROLL)
    if B <= CONT:
        return _cont_cascade_joint(
            seq_r, seq_q, (loc_r, loc_q, st_r), (loc_r, loc_q, st_l),
            jnp.int32(W), na_r, na_l, sub_flat, xdrop, ref_len, query_len,
            sizes=_cascade_sizes(B), **kw)

    def round_cond(c):
        return jnp.maximum(c[1], c[3]) > 0

    def round_body(c):
        st_r, na_r, st_l, na_l = c

        def pick(st):
            tgt, cum = _alive_prefix(st["done"], CONT)
            take = lambda a: jnp.take(a, tgt, axis=0)
            return (take(loc_r), take(loc_q),
                    {kk: take(st[kk]) for kk in _STATE}, cum)

        r_lr, r_lq, r_st, cum_r = pick(st_r)
        l_lr, l_lq, l_st, cum_l = pick(st_l)
        sub_r, sub_l = _cont_cascade_joint(
            seq_r, seq_q, (r_lr, r_lq, r_st), (l_lr, l_lq, l_st),
            jnp.int32(W), jnp.minimum(na_r, CONT),
            jnp.minimum(na_l, CONT), sub_flat, xdrop, ref_len, query_len,
            sizes=_cascade_sizes(CONT), **kw)
        return (_merge_back(sub_r, st_r, cum_r, CONT),
                na_r - jnp.minimum(na_r, CONT),
                _merge_back(sub_l, st_l, cum_l, CONT),
                na_l - jnp.minimum(na_l, CONT))

    st_r, _, st_l, _ = jax.lax.while_loop(
        round_cond, round_body, (st_r, na_r, st_l, na_l))
    return st_r, st_l


def _run_tail(seq_r, seq_q, loc_r, loc_q, st, n_alive, sub_flat, xdrop,
              ref_len, query_len, *, pad, W, CONT, left,
              W_CONT=0, UNROLL=4):
    """Continue one direction after its first window: full-batch stepping
    while > CONT rows live, then a compacted continuation at width W_CONT
    (defaults to W).

    Wider continuation windows amortize the per-iteration cost of the
    data-dependent while_loop: rows that survive the first window are
    long homologous extensions (thousands of bases). Requires
    pad >= W_CONT (left-gather lower bound)."""
    Wc = W_CONT or W
    B = loc_r.shape[0]
    if B <= CONT:
        # batch already fits the continuation width: no initial compaction
        return _cont_cascade(seq_r, seq_q, loc_r, loc_q, st, jnp.int32(W),
                             n_alive, sub_flat, xdrop, ref_len, query_len,
                             pad=pad, Wc=Wc, UNROLL=UNROLL, left=left,
                             sizes=_cascade_sizes(B))

    # graduated rounds: while any rows live, compact the first CONT of
    # them to the front, run them to completion at width Wc, merge back.
    # Cost is alive-linear per round (the previous full-batch "phase 2"
    # stepping was B-linear PER WINDOW, which at B >= 2^18 made candidate
    # -dense chunks quadratically expensive). Scheduling only — each row's
    # extension is independent, so results are bit-identical.
    def round_cond(c):
        return c[1] > 0

    def round_body(c):
        st, na = c
        tgt, cum = _alive_prefix(st["done"], CONT)
        take = lambda a: jnp.take(a, tgt, axis=0)
        c_lr, c_lq = take(loc_r), take(loc_q)
        cst = {kk: take(st[kk]) for kk in _STATE}
        cohort = jnp.minimum(na, CONT)
        cst = _cont_cascade(seq_r, seq_q, c_lr, c_lq, cst, jnp.int32(W),
                            cohort, sub_flat, xdrop, ref_len, query_len,
                            pad=pad, Wc=Wc, UNROLL=UNROLL, left=left,
                            sizes=_cascade_sizes(CONT))
        return (_merge_back(cst, st, cum, CONT), na - cohort)

    st, _ = jax.lax.while_loop(round_cond, round_body, (st, n_alive))
    return st


def _extend_core(ref_pad, query_pad, ref_loc, query_loc, valid, sub_flat,
                 xdrop, hspthresh, ref_len, query_len, *, pad, W, CONT,
                 W_CONT=0, UNROLL=4):
    loc_r = jnp.where(valid, jnp.asarray(ref_loc, jnp.int32), 0)
    loc_q = jnp.where(valid, jnp.asarray(query_loc, jnp.int32), 0)
    B = loc_r.shape[0]

    def init_st(init_maxp):
        z = jnp.zeros((B,), jnp.int32)
        return dict(done=jnp.logical_not(valid), cum=z, maxv=z,
                    maxp=jnp.full((B,), init_maxp, jnp.int32))

    st_r0, na_r = _step(ref_pad, query_pad, loc_r, loc_q, 0, init_st(-1),
                        sub_flat, xdrop, ref_len, query_len, pad=pad, W=W,
                        left=False)
    st_l0, na_l = _step(ref_pad, query_pad, loc_r, loc_q, 0, init_st(0),
                        sub_flat, xdrop, ref_len, query_len, pad=pad, W=W,
                        left=True)
    kw = dict(pad=pad, W=W, CONT=CONT, W_CONT=W_CONT, UNROLL=UNROLL)
    if _USE_JOINT_TAIL:
        st_r, st_l = _run_tails_joint(
            ref_pad, query_pad, loc_r, loc_q, st_r0, na_r, st_l0, na_l,
            sub_flat, xdrop, ref_len, query_len, **kw)
    else:
        st_r = _run_tail(ref_pad, query_pad, loc_r, loc_q, st_r0, na_r,
                         sub_flat, xdrop, ref_len, query_len, left=False,
                         **kw)
        st_l = _run_tail(ref_pad, query_pad, loc_r, loc_q, st_l0, na_l,
                         sub_flat, xdrop, ref_len, query_len, left=True,
                         **kw)
    return _finalize.__wrapped__(valid, loc_r, loc_q, st_r["maxv"],
                                 st_r["maxp"], st_l["maxv"], st_l["maxp"],
                                 None, hspthresh)


@functools.partial(jax.jit,
                   static_argnames=("pad", "W", "CONT", "W_CONT", "UNROLL"))
def extend_fields_program(ref_pad, query_pad, ref_loc, query_loc, m,
                          sub_flat, xdrop, hspthresh, ref_len, query_len,
                          *, pad: int, W: int = 256, CONT: int = 4096,
                          W_CONT: int = 0, UNROLL: int = 4):
    """Extend rows [0, m) of an HBUF-sized hit batch to completion in one
    device program; return the raw finalize fields dict(candidate, rs, qs,
    length, total) as device arrays (the extents and totals of
    ops/extend3.extend_hits_windowed). Candidate compaction happens once per chunk-strand across ALL
    programs (pipeline/device._pack_compact), not per program: one global
    argsort replaces P per-program ones and removes the per-program
    overflow case entirely."""
    B = ref_loc.shape[0]
    valid = jnp.arange(B, dtype=jnp.int32) < m
    return _extend_core(ref_pad, query_pad, ref_loc, query_loc, valid,
                        sub_flat, xdrop, hspthresh, ref_len, query_len,
                        pad=pad, W=W, CONT=CONT, W_CONT=W_CONT,
                        UNROLL=UNROLL)
