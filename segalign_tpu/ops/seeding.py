"""Device-side query seeding: spaced-seed k-mers + transition expansion.

JAX equivalent of the seeder stage (the reference's src/seeder.cpp:47-121
+ GetKmerIndexAtPos, common/ntcoding.cpp:43-61). The query block lives on
device; one jitted call produces every seed of a wga chunk, so nothing but
scalars crosses the host boundary per chunk.

Seed slot order matches the reference enumeration exactly (position-major,
then base k-mer followed by transition variants t = 0..k-1), because the
downstream hit-batching boundaries depend on it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import TRANSITION_MASK
from .scan_utils import blocked_cumsum


@functools.partial(
    jax.jit,
    static_argnames=("CHUNK", "seed_size", "shape_pos", "transition", "pad"))
def chunk_seeds(query_pad, index_table, chunk_start, chunk_len, *,
                CHUNK: int, seed_size: int, shape_pos: tuple,
                transition: bool, pad: int):
    """Compute the seeds of one chunk [chunk_start, chunk_start+chunk_len).

    query_pad: padded uint8 code array (device).
    Returns (kmers[S], qpos[S], valid[S], starts[S], cum[S]) with
    S = CHUNK * (1 + kmer_size if transition else 1); cum is the inclusive
    int32 cumsum of per-seed hit counts; invalid slots count 0.
    """
    k = len(shape_pos)
    nvar = 1 + k if transition else 1

    # window columns via shifted slices of the padded query
    cols = []
    for i in range(seed_size):
        cols.append(jax.lax.dynamic_slice(
            query_pad, (pad + chunk_start + i,), (CHUNK,)).astype(jnp.int32))
    valid_pos = jnp.ones((CHUNK,), dtype=bool)
    for c in cols:
        valid_pos &= c < 4
    j = jnp.arange(CHUNK, dtype=jnp.int32)
    valid_pos &= j < chunk_len

    kmer = jnp.zeros((CHUNK,), dtype=jnp.int32)
    for i, sp in enumerate(shape_pos):
        kmer = kmer | ((cols[sp] & 3) << (2 * (k - 1 - i)))

    if transition:
        xors = jnp.array(
            [0] + [TRANSITION_MASK << (2 * t) for t in range(k)],
            dtype=jnp.int32)
        kmers = (kmer[:, None] ^ xors[None, :]).reshape(-1)
    else:
        kmers = kmer
    qpos = jnp.repeat(chunk_start + j, nvar, total_repeat_length=CHUNK * nvar)
    valid = jnp.repeat(valid_pos, nvar, total_repeat_length=CHUNK * nvar)

    ends = jnp.take(index_table, kmers)
    starts = jnp.where(kmers > 0, jnp.take(index_table, kmers - 1), 0)
    hit_counts = jnp.where(valid, ends - starts, 0)
    cum = blocked_cumsum(hit_counts.astype(jnp.int32))
    # packed stats: one D2H sync for (num_seeds, num_hits)
    from .scan_utils import sum1d
    stats = jnp.stack([sum1d(valid), cum[-1]])
    return (kmers, qpos.astype(jnp.int32), valid, starts.astype(jnp.int32),
            cum, stats)
