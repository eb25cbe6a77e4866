"""Hit expansion: seed-hit index ranges -> (ref_loc, query_loc) pairs.

JAX equivalent of find_num_hits/find_hits
(/root/reference/src/seed_filter.cu:157-230). Hits are addressed by a flat
global hit index g; a vectorized binary search over the seed cumsum recovers
the owning seed, then the bucket offset indexes pos_table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp



@functools.partial(jax.jit, static_argnames=("HBUF",))
def expand_hits(cum, starts, qpos, pos_table, g0, g1, seed_size,
                *, HBUF: int):
    """Materialize hits [g0, g1) (at most HBUF).

    Returns (ref_loc[HBUF], query_loc[HBUF], valid[HBUF]); locations already
    include the +seed_size offset applied by find_hits
    (seed_filter.cu:204,220)."""
    g = g0 + jnp.arange(HBUF, dtype=jnp.int32)
    valid = g < g1
    gs = jnp.where(valid, g, 0)
    sidx = jnp.searchsorted(cum, gs, side="right").astype(jnp.int32)
    sidx = jnp.minimum(sidx, cum.shape[0] - 1)
    prev = jnp.where(sidx > 0, jnp.take(cum, sidx - 1), 0)
    off = gs - prev
    bucket_pos = jnp.take(starts, sidx) + off
    bucket_pos = jnp.clip(bucket_pos, 0, pos_table.shape[0] - 1)
    ref_loc = jnp.take(pos_table, bucket_pos) + seed_size
    query_loc = jnp.take(qpos, sidx) + seed_size
    return ref_loc, query_loc, valid


@jax.jit
def compact_mask(mask, *arrays):
    """Stream compaction: pack rows where mask is True to the front of
    same-shaped buffers (equivalent of compress_output,
    seed_filter.cu:654-680). Returns (n, packed_arrays...).

    Implemented as a stable argsort + gathers."""
    n = jnp.sum(mask.astype(jnp.int32))
    perm = jnp.argsort(jnp.logical_not(mask), stable=True)
    outs = [jnp.take(a, perm, axis=0) for a in arrays]
    return (n, *outs)
