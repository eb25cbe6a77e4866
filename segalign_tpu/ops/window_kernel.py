"""X-drop window step as one Pallas kernel for NVIDIA GPUs (Triton route).

Semantics are exactly those of ops/extend3._extension_window_step_jit with
with_counts=False: each row extends W positions from `tile` in one
direction, and only the carried state (done, cum, maxv, maxp) is written
back. The XLA step materialises several (B, W) int32 arrays per window
(gathered bytes, scores, prefix sums, running maxima, drop masks); here a
program of BR rows streams its window in TW-lane tiles held in registers,
so device memory sees the 2*W sequence bytes per row and the state.

Per tile: gather the r and q bytes at the rows' offsets (masked to the
sequences, so no padding is read), look each pair up in the 8x8
substitution table, take the lane prefix sum and running maximum, find the
first x-drop lane and the first position of the best score before it. The
tile loop carries the running score, the running maximum, whether a drop
was seen, and the best value/position found so far.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -(2**31) + 1

# Rows per program, lanes per tile and warps per program: the fastest of
# seven block shapes swept on an H100 SXM (scripts/bench_window_step.py;
# PERF.md), at both the first-window and the continuation width.
BLOCK_ROWS = 64
TILE_LANES = 32
NUM_WARPS = 4


def _register_cummax_lowering():
    """Triton lowers cumsum through tt.scan (jax/_src/pallas/triton/
    lowering.py, _cumsum_lowering_rule) but has no rule for cummax. The
    same scan with a max combiner is the running maximum."""
    from jax._src.pallas.triton import lowering as tl
    if jax.lax.cummax_p in tl.triton_lowering_rules:
        return

    def rule(ctx, x, *, axis, reverse):
        if reverse:
            raise NotImplementedError("reverse cummax")
        return tl._associative_scan_lowering(jnp.maximum, ctx, x, (axis,))[0]

    tl.triton_lowering_rules[jax.lax.cummax_p] = rule


_register_cummax_lowering()


def _kernel(params_ref, loc_r_ref, loc_q_ref, done_ref, cum_ref, maxv_ref,
            maxp_ref, sub_ref, seq_r_ref, seq_q_ref, o_done_ref, o_cum_ref,
            o_maxv_ref, o_maxp_ref, *, pad, W, TW, left):
    tile = params_ref[0]
    xdrop = params_ref[1]
    ref_len = params_ref[2]
    query_len = params_ref[3]
    loc_r = loc_r_ref[...]
    loc_q = loc_q_ref[...]
    done = done_ref[...] != 0
    cum0 = cum_ref[...]
    maxv = maxv_ref[...]
    maxp = maxp_ref[...]
    alive = jnp.logical_not(done)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, TW), 1)
    BR = loc_r.shape[0]

    def body(t, carry):
        c, m, dropped, best, bpos = carry
        j = t * TW + lanes                       # lane within the window
        if left:
            p = tile + 1 + j
            inb = (loc_r[:, None] >= p) & (loc_q[:, None] >= p)
            r_idx = pad + loc_r[:, None] - p
            q_idx = pad + loc_q[:, None] - p
        else:
            p = tile + j
            inb = ((loc_r[:, None] + p) < ref_len) & \
                  ((loc_q[:, None] + p) < query_len)
            r_idx = pad + loc_r[:, None] + p
            q_idx = pad + loc_q[:, None] + p
        inb = inb & alive[:, None]
        r = plgpu.load(seq_r_ref.at[jnp.where(inb, r_idx, 0)], mask=inb,
                       other=0).astype(jnp.int32)
        q = plgpu.load(seq_q_ref.at[jnp.where(inb, q_idx, 0)], mask=inb,
                       other=0).astype(jnp.int32)
        sc = jnp.where(inb, sub_ref[r * 8 + q], 0)
        cs = jnp.cumsum(sc, axis=1) + c[:, None]
        rm = jnp.maximum(jax.lax.cummax(cs, axis=1), m[:, None])
        dropm = (rm - cs) > xdrop
        jd = jnp.min(jnp.where(dropm, j, W), axis=1)   # first drop lane
        before = (j < jd[:, None]) & jnp.logical_not(dropped)[:, None]
        tb = jnp.max(jnp.where(before, cs, NEG), axis=1)
        tpos = jnp.min(jnp.where(before & (cs == tb[:, None]), j, W), axis=1)
        upd = tb > best
        return (c + jnp.sum(sc, axis=1),
                jnp.maximum(m, jnp.max(cs, axis=1)),
                dropped | (jd < W),
                jnp.where(upd, tb, best),
                jnp.where(upd, tpos, bpos))

    z = jnp.zeros((BR,), jnp.int32)
    c, _, dropped, best, bpos = jax.lax.fori_loop(
        0, W // TW, body,
        (cum0, maxv, z != 0, jnp.full((BR,), NEG, jnp.int32), z))

    if left:
        edge = (loc_r < tile + W) | (loc_q < tile + W)
        base = tile + 1
    else:
        edge = (loc_r + tile + (W - 1) >= ref_len) | \
               (loc_q + tile + (W - 1) >= query_len)
        base = tile
    mv = jnp.maximum(maxv, best)
    mp = jnp.where(mv > maxv, base + bpos, maxp)
    o_done_ref[...] = (done | (alive & (dropped | edge))).astype(jnp.int32)
    o_cum_ref[...] = jnp.where(alive, c, cum0)
    o_maxv_ref[...] = jnp.where(alive, mv, maxv)
    o_maxp_ref[...] = jnp.where(alive, mp, maxp)


def window_step_kernel(seq_r_pad, seq_q_pad, loc_r, loc_q, tile, done, cum,
                       maxv, maxp, sub_flat, xdrop, ref_len, query_len, *,
                       pad: int, W: int, left: bool, interpret: bool = False,
                       block_rows: int = BLOCK_ROWS,
                       tile_lanes: int = TILE_LANES,
                       num_warps: int = NUM_WARPS):
    """One window step for every row; returns (done, cum, maxv, maxp).

    Rows are padded to a multiple of the block height with done rows; the
    tile width is the largest power of two, at most tile_lanes, that
    divides W."""
    B = loc_r.shape[0]
    BR = min(block_rows, 1 << (B - 1).bit_length())
    TW = min(tile_lanes, W & -W)
    Bp = -(-B // BR) * BR

    def rows(a, fill):
        a = jnp.asarray(a, jnp.int32)
        return a if Bp == B else jnp.pad(a, (0, Bp - B),
                                         constant_values=fill)

    params = jnp.stack([jnp.asarray(v, jnp.int32).reshape(())
                        for v in (tile, xdrop, ref_len, query_len)])
    row_spec = pl.BlockSpec((BR,), lambda i: (i,))
    whole = pl.no_block_spec
    out_shape = [jax.ShapeDtypeStruct((Bp,), jnp.int32)] * 4
    outs = pl.pallas_call(
        functools.partial(_kernel, pad=pad, W=W, TW=TW, left=left),
        out_shape=out_shape,
        grid=(Bp // BR,),
        in_specs=[whole, row_spec, row_spec, row_spec, row_spec, row_spec,
                  row_spec, whole, whole, whole],
        out_specs=[row_spec] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name=f"xdrop_window_{'left' if left else 'right'}",
    )(params, rows(loc_r, 0), rows(loc_q, 0), rows(done, 1), rows(cum, 0),
      rows(maxv, 0), rows(maxp, 0), jnp.asarray(sub_flat, jnp.int32),
      seq_r_pad, seq_q_pad)
    o_done, o_cum, o_maxv, o_maxp = (o[:B] for o in outs)
    return o_done != 0, o_cum, o_maxv, o_maxp
