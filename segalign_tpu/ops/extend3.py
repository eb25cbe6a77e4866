"""The XLA window step, and host-stepped windowed x-drop extension.

_extension_window_step_jit is the plain reference window step: one jitted
step processes W positions for every live hit. The production program
(ops/extend_fused) runs it on the CPU; on CUDA GPUs the Triton kernel
(ops/window_kernel) takes its place with identical results.

extend_hits_windowed advances those steps from the HOST until every hit
has terminated; the device-seeding path (SEGALIGN_DEVICE_SEEDING=1) uses
it. Semantics are identical to ops/extend.py (tile-width independence,
oracle/scan_spec.py); entropy bookkeeping follows the reference's
fold-on-new-max rule per window.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = jnp.int32(-(2**31) + 1)


from .scan_utils import robust_call as _robust_call


@functools.partial(jax.jit,
                   static_argnames=("pad", "W", "left", "with_counts"))
def _extension_window_step_jit(seq_r_pad, seq_q_pad, loc_r, loc_q, tile,
                               done, cum, maxv, maxp, counts, cdel,
                               sub_flat, xdrop, ref_len, query_len, *,
                               pad: int, W: int, left: bool,
                               with_counts: bool = True):
    """Process the window covering positions [tile, tile+W) from the anchor
    for every live hit. Returns updated state + number of still-live hits.
    (`tile` is an explicit offset so continuation phases can use a wider
    window than the first one; results are window-width independent, see
    oracle/scan_spec.py.)"""
    B = loc_r.shape[0]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    alive = jnp.logical_not(done)

    def one(s):
        return jax.lax.dynamic_slice(seq_r_pad, (s,), (W,))

    if left:
        p = tile + 1 + lanes
        r_start = pad + loc_r - tile - W
        q_start = pad + loc_q - tile - W
        r = jax.vmap(lambda s: jax.lax.dynamic_slice(seq_r_pad, (s,), (W,))
                     )(r_start).astype(jnp.int32)[:, ::-1]
        q = jax.vmap(lambda s: jax.lax.dynamic_slice(seq_q_pad, (s,), (W,))
                     )(q_start).astype(jnp.int32)[:, ::-1]
        inb = (loc_r[:, None] >= p) & (loc_q[:, None] >= p)
        edge = (loc_r < tile + W) | (loc_q < tile + W)
    else:
        p = tile + lanes
        r = jax.vmap(lambda s: jax.lax.dynamic_slice(seq_r_pad, (s,), (W,))
                     )(pad + loc_r + tile).astype(jnp.int32)
        q = jax.vmap(lambda s: jax.lax.dynamic_slice(seq_q_pad, (s,), (W,))
                     )(pad + loc_q + tile).astype(jnp.int32)
        inb = ((loc_r[:, None] + p) < ref_len) & \
              ((loc_q[:, None] + p) < query_len)
        edge = (loc_r + tile + (W - 1) >= ref_len) | \
               (loc_q + tile + (W - 1) >= query_len)

    sc = jnp.where(inb, jnp.take(sub_flat, r * 8 + q), 0)
    cum_tile = jnp.cumsum(sc, axis=1, dtype=jnp.int32) + cum[:, None]
    run_max = jax.lax.cummax(cum_tile, axis=1)
    m = jnp.maximum(maxv[:, None], run_max)
    dropm = (m - cum_tile) > xdrop
    anydrop = jnp.any(dropm, axis=1)
    d = jnp.where(anydrop, jnp.argmax(dropm, axis=1).astype(jnp.int32), W)
    before = lanes < d[:, None]

    best_in_tile = jnp.max(jnp.where(before, cum_tile, NEG), axis=1)
    Mv = jnp.maximum(maxv, best_in_tile)
    is_new = Mv > maxv
    j = jnp.argmax((cum_tile == Mv[:, None]) & before, axis=1
                   ).astype(jnp.int32)
    if left:
        Mp = jnp.where(is_new, tile + 1 + j, maxp)
    else:
        Mp = jnp.where(is_new, tile + j, maxp)

    finish = anydrop | edge

    if with_counts:
        new_max_found = Mp > maxp
        counts_f = jnp.where(new_max_found[:, None], counts + cdel, counts)
        cdel_f = jnp.where(new_max_found[:, None], 0, cdel)
        match = inb & (r == q) & (r < 4)
        in_ext = p <= Mp[:, None]
        onehot = r[:, :, None] == \
            jnp.arange(4, dtype=jnp.int32)[None, None, :]
        counts_f = counts_f + jnp.sum(
            (match & in_ext)[:, :, None] & onehot, axis=1, dtype=jnp.int32)
        cdel_f = cdel_f + jnp.sum(
            (match & ~in_ext)[:, :, None] & onehot, axis=1, dtype=jnp.int32)
    else:
        # lazy-entropy mode: counts are recomputed on host from the final
        # extents for entropy-band candidates only (oracle/scan_spec.py:
        # counts are a pure function of the extents), so the device skips
        # the entropy bookkeeping entirely
        counts_f, cdel_f = counts, cdel

    al2 = alive[:, None]
    out = dict(
        done=done | (alive & finish),
        cum=jnp.where(alive, cum_tile[:, -1], cum),
        maxv=jnp.where(alive, Mv, maxv),
        maxp=jnp.where(alive, Mp, maxp),
        counts=jnp.where(al2, counts_f, counts),
        cdel=jnp.where(al2, cdel_f, cdel))
    out["n_alive"] = jnp.sum(jnp.logical_not(out["done"]).astype(jnp.int32))
    return out


def extension_window_step(*args, **kw):
    """Dispatch one window step (see scan_utils.robust_call)."""
    return _robust_call(_extension_window_step_jit, *args, **kw)


@functools.partial(jax.jit, static_argnames=())
def _finalize(valid, loc_r, loc_q, r_maxv, r_maxp, l_maxv, l_maxp, counts,
              hspthresh):
    """Extents and totals of a hit batch; counts=None leaves out the
    entropy counts (the host recomputes them from the extents)."""
    total = r_maxv + l_maxv
    out = dict(
        candidate=valid & (total >= hspthresh),
        rs=jnp.where(valid, loc_r - l_maxp, 0),
        qs=jnp.where(valid, loc_q - l_maxp, 0),
        length=jnp.where(valid, r_maxp + l_maxp, -1),
        total=jnp.where(valid, total, 0))
    if counts is not None:
        out["counts"] = jnp.where(valid[:, None], counts, 0)
    return out


# continuation buffer size: once the live-row count drops below this,
# window stepping continues on a compacted batch instead of full width
CONT = 4096

_STATE_KEYS = ("done", "cum", "maxv", "maxp", "counts", "cdel")


@jax.jit
def _alive_order(done):
    """Stable permutation putting live rows first, plus its inverse."""
    order = jnp.argsort(done, stable=True)
    inv = jnp.argsort(order, stable=True)
    return order, inv


@jax.jit
def _gather_rows(order_prefix, loc_r, loc_q, done, cum, maxv, maxp, counts,
                 cdel):
    take = lambda a: jnp.take(a, order_prefix, axis=0)
    return (take(loc_r), take(loc_q), take(done), take(cum), take(maxv),
            take(maxp), take(counts), take(cdel))


@jax.jit
def _scatter_rows(order, inv, c_done, c_cum, c_maxv, c_maxp, c_counts,
                  c_cdel, done, cum, maxv, maxp, counts, cdel):
    """Merge compacted-row results back (gather-only: sorted-space concat
    then unsort)."""
    def merge(c, full):
        rest = jnp.take(full, order[c.shape[0]:], axis=0)
        return jnp.take(jnp.concatenate([c, rest], axis=0), inv, axis=0)
    return (merge(c_done, done), merge(c_cum, cum), merge(c_maxv, maxv),
            merge(c_maxp, maxp), merge(c_counts, counts),
            merge(c_cdel, cdel))


def extend_hits_windowed(ref_pad, query_pad, ref_loc, query_loc, valid,
                         sub_flat, xdrop, hspthresh, ref_len, query_len, *,
                         pad: int, W: int = 512, max_windows: int = 1 << 20):
    """Host-driven extension over a hit batch. Same contract as
    ops.extend.extend_hits. NOT jittable as a whole (host loop inside).

    Continuation windows (rare long extensions) run on a CONT-row compacted
    batch: repeat-dense regions otherwise pay full batch width for a
    handful of live rows on every extra window."""
    B = ref_loc.shape[0]
    ref_loc = jnp.asarray(ref_loc, jnp.int32)
    query_loc = jnp.asarray(query_loc, jnp.int32)
    loc_r = jnp.where(valid, ref_loc, 0)
    loc_q = jnp.where(valid, query_loc, 0)
    z = jnp.zeros((B,), jnp.int32)
    zc = jnp.zeros((B, 4), jnp.int32)
    not_valid = jnp.logical_not(valid)

    def step(lr, lq, st, k, left, w):
        st2 = extension_window_step(
            ref_pad, query_pad, lr, lq, k * w, st["done"], st["cum"],
            st["maxv"], st["maxp"], st["counts"], st["cdel"], sub_flat,
            xdrop, ref_len, query_len, pad=pad, W=w, left=left)
        return st2, int(st2["n_alive"])

    def run_dir(left, init_maxp, counts):
        st = dict(done=not_valid, cum=z, maxv=z,
                  maxp=jnp.full((B,), init_maxp, jnp.int32),
                  counts=counts, cdel=zc)
        st, n_alive = step(loc_r, loc_q, st, 0, left, W)
        k = 1
        while n_alive > 0 and k < max_windows and (
                B <= CONT or n_alive > CONT):
            st, n_alive = step(loc_r, loc_q, st, k, left, W)
            k += 1
        if n_alive > 0 and B > CONT:
            order, inv = _robust_call(_alive_order, st["done"])
            prefix = order[:CONT]
            (c_lr, c_lq, c_done, c_cum, c_maxv, c_maxp, c_counts,
             c_cdel) = _robust_call(
                _gather_rows, prefix, loc_r, loc_q, st["done"], st["cum"],
                st["maxv"], st["maxp"], st["counts"], st["cdel"])
            cst = dict(done=c_done, cum=c_cum, maxv=c_maxv, maxp=c_maxp,
                       counts=c_counts, cdel=c_cdel)
            while n_alive > 0 and k < max_windows:
                cst, n_alive = step(c_lr, c_lq, cst, k, left, W)
                k += 1
            merged = _robust_call(
                _scatter_rows, order, inv, cst["done"], cst["cum"],
                cst["maxv"], cst["maxp"], cst["counts"], cst["cdel"],
                st["done"], st["cum"], st["maxv"], st["maxp"],
                st["counts"], st["cdel"])
            st = dict(zip(_STATE_KEYS, merged))
        return st

    st_r = run_dir(False, -1, zc)
    st_l = run_dir(True, 0, st_r["counts"])
    return _robust_call(
        _finalize, valid, loc_r, loc_q, st_r["maxv"], st_r["maxp"],
        st_l["maxv"], st_l["maxp"], st_l["counts"], hspthresh)
