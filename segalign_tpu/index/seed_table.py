"""Seed position table build (host, vectorized numpy).

JAX-pipeline equivalent of GenerateSeedPosTable
(/root/reference/common/seed_pos_table.cu:49-109). The reference builds the
table on CPU with TBB atomics (nondeterministic bucket order); we build it
with a radix argsort (deterministic ascending-position buckets, output
equivalent — see oracle/reference.py deviation 1).

Returns int32 arrays sized for direct device upload:
  index_table[4**k]  — inclusive cumulative bucket counts
  pos_table[n]       — block-relative positions, bucket-major
"""

from __future__ import annotations

import numpy as np


def build_seed_table(ref_codes: np.ndarray, step: int, shape_pos,
                     seed_size: int, kmer_size: int,
                     use_native: bool = True):
    assert 3 < kmer_size <= 15
    if use_native:
        from ..native import build_seed_table_fast
        r = build_seed_table_fast(ref_codes, step, shape_pos, seed_size,
                                  kmer_size)
        if r is not None:
            return r
    ref_len = len(ref_codes)
    offset = (seed_size + 1) % step
    start_offset = step - offset
    num_steps = (ref_len - seed_size + offset) // step
    if num_steps <= 0:
        return (np.zeros(4 ** kmer_size, np.int32), np.zeros(0, np.int32))

    codes = ref_codes.astype(np.int32)
    # validity: no code >= 4 anywhere in the seed_size window
    bad = (codes >= 4).astype(np.int32)
    cbad = np.cumsum(bad)
    pos0 = start_offset
    pos_last = start_offset + (num_steps - 1) * step
    # windows [p, p+seed_size): bad count = cbad[p+ss-1] - cbad[p-1]
    hi = cbad[pos0 + seed_size - 1: pos_last + seed_size: step]
    lo = cbad[pos0 - 1: pos_last: step] if pos0 > 0 else np.concatenate(
        [[0], cbad[pos0 + step - 1: pos_last: step]])
    valid = (hi - lo) == 0

    kmer = np.zeros(num_steps, dtype=np.int64)
    for i, sp in enumerate(shape_pos):
        shift = 2 * (kmer_size - 1 - i)
        col = codes[pos0 + sp: pos_last + sp + 1: step]
        kmer |= (col.astype(np.int64) & 3) << shift

    positions = (pos0 + step * np.arange(num_steps, dtype=np.int64))[valid]
    kmer = kmer[valid]

    counts = np.bincount(kmer, minlength=4 ** kmer_size)
    # int32 accumulation halves the table's fresh-page footprint (positions
    # per block are < 2^31 by construction: blocks cap at 500 MB)
    index_table = np.cumsum(counts, dtype=np.int32)
    order = np.argsort(kmer, kind="stable")
    pos_table = positions[order].astype(np.int32)
    return index_table, pos_table
