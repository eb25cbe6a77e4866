"""Batched ungapped x-drop extension (XLA path).

JAX re-design of find_hsps (the reference's src/seed_filter.cu:232-652).
The reference runs one CUDA warp per hit with 32-wide tiles; here a batch of B
hits advances together through W-wide tiles under a lax.while_loop. The
sequential-scan equivalence (segalign_tpu/oracle/scan_spec.py) makes the
result independent of tile width, so wide windows (W=128 and up) work while
reproducing the reference's tile-32 output exactly.

Score arithmetic is int32 throughout, matching the CUDA kernel's `int` (and
its overflow behaviour).

Device arrays are padded with PAD sentinel bytes on BOTH sides by `pad`
elements so windows never need clamping: index (pad + position).

The entropy adjustment is NOT applied here: the kernel returns raw totals and
the A/C/G/T match counts; the host applies the double-precision entropy rule
(the reference uses double `log`) to the few
candidates in the [hspthresh, 3*hspthresh] band. Candidates are exactly the
hits with total >= hspthresh, a superset of the accepted set since the
entropy factor is always in [0, 1].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PAD_CODE = 6  # X_NT; scores at padded lanes are masked anyway


def _gather_windows(seq_pad, starts, W):
    """(B,) starts -> (B, W) int32 windows from a padded sequence.

    starts are in UNPADDED coordinates and may range over [-pad, len];
    seq_pad has `pad` sentinel bytes on each side.
    """
    def one(s):
        return jax.lax.dynamic_slice(seq_pad, (s,), (W,))
    return jax.vmap(one)(starts).astype(jnp.int32)


def _direction_loop(seq_r_pad, seq_q_pad, ref_loc, query_loc, sub_flat,
                    xdrop, ref_len, query_len, pad, W, left: bool,
                    init_maxp, counts, count_del, done0):
    """One extension direction for a batch. Returns
    (max_v, max_p, counts, count_del)."""
    B = ref_loc.shape[0]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]

    def cond(state):
        done = state[0]
        return jnp.logical_not(jnp.all(done))

    def body(state):
        done, tile, cum, maxv, maxp, counts, count_del = state
        alive = jnp.logical_not(done)

        if left:
            # positions p = tile+1 .. tile+W map to (loc - p)
            p = tile[:, None] + 1 + lanes
            inb = (ref_loc[:, None] >= p) & (query_loc[:, None] >= p)
            # window [loc - tile - W, loc - tile), reversed so lane j is p=tile+1+j
            r_start = pad + ref_loc - tile - W
            q_start = pad + query_loc - tile - W
            r = _gather_windows(seq_r_pad, r_start, W)[:, ::-1]
            q = _gather_windows(seq_q_pad, q_start, W)[:, ::-1]
            edge = (ref_loc < tile + W) | (query_loc < tile + W)
        else:
            # positions p = tile .. tile+W-1 map to (loc + p)
            p = tile[:, None] + lanes
            rpos = ref_loc[:, None] + p
            qpos = query_loc[:, None] + p
            inb = (rpos < ref_len) & (qpos < query_len)
            r = _gather_windows(seq_r_pad, pad + ref_loc + tile, W)
            q = _gather_windows(seq_q_pad, pad + query_loc + tile, W)
            edge = (ref_loc + tile + (W - 1) >= ref_len) | \
                   (query_loc + tile + (W - 1) >= query_len)

        sc = jnp.where(inb, jnp.take(sub_flat, r * 8 + q), 0)
        cum_tile = jnp.cumsum(sc, axis=1, dtype=jnp.int32) + cum[:, None]
        run_max = jax.lax.cummax(cum_tile, axis=1)
        m = jnp.maximum(maxv[:, None], run_max)
        dropm = (m - cum_tile) > xdrop
        anydrop = jnp.any(dropm, axis=1)
        d = jnp.where(anydrop, jnp.argmax(dropm, axis=1), W)
        before = lanes < d[:, None]

        NEG = jnp.int32(-(2**31) + 1)
        best_in_tile = jnp.max(jnp.where(before, cum_tile, NEG), axis=1)
        Mv = jnp.maximum(maxv, best_in_tile)
        is_new = Mv > maxv
        # earliest lane achieving the strictly-improved max
        hitj = (cum_tile == Mv[:, None]) & before
        j = jnp.argmax(hitj, axis=1).astype(jnp.int32)
        if left:
            Mp = jnp.where(is_new, tile + 1 + j, maxp)
        else:
            Mp = jnp.where(is_new, tile + j, maxp)

        finish = anydrop | edge

        # entropy bookkeeping (fold pending, then classify this tile)
        new_max_found = Mp > maxp
        counts_f = jnp.where(new_max_found[:, None], counts + count_del, counts)
        cdel_f = jnp.where(new_max_found[:, None], 0, count_del)
        match = inb & (r == q) & (r < 4)
        in_ext = p <= Mp[:, None]
        onehot = (r[:, :, None] == jnp.arange(4, dtype=jnp.int32)[None, None, :])
        add_in = jnp.sum((match & in_ext)[:, :, None] & onehot, axis=1,
                         dtype=jnp.int32)
        add_out = jnp.sum((match & ~in_ext)[:, :, None] & onehot, axis=1,
                          dtype=jnp.int32)
        counts_f = counts_f + add_in
        cdel_f = cdel_f + add_out

        # commit state only for alive rows
        alive2 = alive[:, None]
        return (done | (alive & finish),
                jnp.where(alive, tile + W, tile),
                jnp.where(alive, cum_tile[:, -1], cum),
                jnp.where(alive, Mv, maxv),
                jnp.where(alive, Mp, maxp),
                jnp.where(alive2, counts_f, counts),
                jnp.where(alive2, cdel_f, count_del))

    z = jnp.zeros((B,), jnp.int32)
    init = (done0, z, z, z,
            jnp.full((B,), init_maxp, jnp.int32), counts, count_del)
    done, tile, cum, maxv, maxp, counts, count_del = jax.lax.while_loop(
        cond, body, init)
    return maxv, maxp, counts, count_del


@functools.partial(jax.jit, static_argnames=("pad", "W"))
def extend_hits(ref_pad, query_pad, ref_loc, query_loc, valid, sub_flat,
                xdrop, hspthresh, ref_len, query_len, *, pad: int,
                W: int = 128):
    """Extend a batch of hits. Invalid rows are skipped (marked done with
    zero scores).

    Returns dict with per-hit: candidate (total>=hspthresh & valid), rs, qs,
    length, total (raw score), counts (B,4).
    """
    ref_loc = ref_loc.astype(jnp.int32)
    query_loc = query_loc.astype(jnp.int32)
    B = ref_loc.shape[0]

    # Invalid rows: point them at position 0 with immediate edge; they are
    # masked out at the end.
    safe_rl = jnp.where(valid, ref_loc, 0)
    safe_ql = jnp.where(valid, query_loc, 0)

    counts0 = jnp.zeros((B, 4), jnp.int32)
    cdel0 = jnp.zeros((B, 4), jnp.int32)

    not_valid = jnp.logical_not(valid)
    r_maxv, r_maxp, counts, cdel = _direction_loop(
        ref_pad, query_pad, safe_rl, safe_ql, sub_flat, xdrop, ref_len,
        query_len, pad, W, left=False, init_maxp=-1, counts=counts0,
        count_del=cdel0, done0=not_valid)

    l_maxv, l_maxp, counts, cdel = _direction_loop(
        ref_pad, query_pad, safe_rl, safe_ql, sub_flat, xdrop, ref_len,
        query_len, pad, W, left=True, init_maxp=0, counts=counts,
        count_del=jnp.zeros((B, 4), jnp.int32), done0=not_valid)

    total = r_maxv + l_maxv
    extent = r_maxp + l_maxp
    rs = safe_rl - l_maxp
    qs = safe_ql - l_maxp
    candidate = valid & (total >= hspthresh)
    return dict(candidate=candidate, rs=rs, qs=qs, length=extent,
                total=total, counts=counts)


def pad_sequence(codes, pad: int, right_pad: int | None = None):
    """Host helper: surround a uint8 code array with sentinel bytes.

    Device code always indexes at (pad + position); the right padding may be
    larger (the seeding kernel slices CHUNK-wide windows starting anywhere in
    the block, so query arrays need right_pad >= CHUNK + seed_size)."""
    import numpy as np
    if right_pad is None:
        right_pad = pad
    return np.concatenate([
        np.full(pad, PAD_CODE, dtype=np.uint8), np.asarray(codes),
        np.full(right_pad, PAD_CODE, dtype=np.uint8)])


def pad_sequence_2d(codes: np.ndarray, pad: int, trows: int, W: int,
                    extra_right: int = 0, fill: int = 6) -> np.ndarray:
    """Pad like ops/extend.pad_sequence but return a (rows, 128) uint8
    view whose right padding covers any group tile: trows*128 extra bytes
    beyond the last window end (plus any extra_right the other engines
    need). reshape(-1) of the device array is the 1-D padded sequence
    (same memory layout), so the continuation path's row gathers read the
    same buffer."""
    n = len(codes)
    total = pad + n + max(pad, extra_right) + 2 * W + trows * 128
    total = -(-total // 1024) * 1024
    out = np.full(total, fill, np.uint8)
    out[pad:pad + n] = codes
    return out.reshape(-1, 128)
