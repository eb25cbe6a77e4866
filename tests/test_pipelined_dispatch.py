"""Pipelined dispatch/finish engine: TBUF-escalation fallback + equivalence.

The native path extends hits in HBUF-sized programs, then compacts ALL
programs' candidates into one (CBUF, 5) device block per chunk-strand
(pipeline/device._pack_compact). When the chunk has more candidates than
CBUF, finish_chunk re-runs only the compaction at an escalated width (the
per-program extension results are retained on device). Both paths and the
pipelined map_chunks must be bit-identical to the per-chunk API.
"""

import numpy as np

from segalign_tpu.config import make_seed_config, build_substitution_matrix
from segalign_tpu.io.blocks import chunk_interval
from segalign_tpu.parallel.multi import ChunkWork
from segalign_tpu.pipeline.device import DeviceAligner

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)


def _dense_pair(rng, n=3000):
    """A pair with a long exact repeat so nearly every hit is a candidate
    (forces compaction overflow at small CBUF)."""
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 1200).astype(np.uint8)
    ref[200:1400] = core
    query[300:1500] = core
    return ref, query


def _many_extents_pair(rng, n=3000):
    """A pair where single query chunks see MANY DISTINCT candidate
    extents: 12 copies of one exact 300 bp core scattered through the
    ref, two copies in the query. Every (ref copy, query copy) pair is
    its own diagonal -> its own maximal extent, so the on-device exact
    dedup (_pack_compact dedup_exact) CANNOT collapse the chunk below
    CBUF=8 — the escalated recompact stays exercised with dedup on."""
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    for i in range(12):
        p = 60 + i * 235
        ref[p:p + 300] = core
    for p in (400, 1700):
        query[p:p + 300] = core
    return ref, query


def _mk(sc, sub, cbuf, hbuf=512):
    return DeviceAligner(
        shape_pos=sc.shape_pos, seed_size=sc.size, transition=sc.transition,
        step=1, sub_mat=sub, xdrop=910, hspthresh=1500, noentropy=False,
        chunk_size=512, max_hits=10**9, HBUF=hbuf, B=256, W=128,
        CBUF=cbuf)


def _run_overflow_case(make_pair, seed):
    rng = np.random.default_rng(seed)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    ref, query = make_pair(rng)
    qrc = RC[query[::-1]]

    big = _mk(sc, sub, cbuf=2048)  # never overflows
    tiny = _mk(sc, sub, cbuf=8)    # overflows on the dense chunks
    for al in (big, tiny):
        al.set_ref(ref)
        al.set_query(query, qrc)
    if big._native_seeder is None:
        import pytest
        pytest.skip("native seeder unavailable")

    overflowed = 0
    for (cs, ce) in chunk_interval(0, len(query) - sc.size, 512):
        for rev in (False, True):
            want = big.seed_and_filter(cs, ce, rev)
            pend = tiny.dispatch_chunk(cs, ce, rev)
            # count chunk-strands that overflow the CBUF=8 compaction
            import jax
            if pend.fins and int(jax.device_get(pend.total)) > 8:
                overflowed += 1
            got = tiny.finish_chunk(pend)
            assert got.num_hits == want.num_hits
            np.testing.assert_array_equal(got.hsps, want.hsps,
                                          err_msg=f"{cs}:{ce} rev={rev}")
    assert overflowed > 0  # the escalation was actually exercised


def test_tbuf_overflow_escalation_is_exact():
    """With the default on-device exact dedup: needs many DISTINCT
    extents per chunk to overflow CBUF=8 (a single repeated extent is
    collapsed on device before compaction)."""
    _run_overflow_case(_many_extents_pair, seed=11)


def test_tbuf_overflow_escalation_without_device_dedup():
    """The dedup-off escalation variant: a single dense exact repeat
    floods the compaction with duplicate extents; SEGALIGN_DEDUP_DEVICE=0
    keeps them on device so the overflow recompact runs in its original
    (no-dedup) form."""
    import os
    os.environ["SEGALIGN_DEDUP_DEVICE"] = "0"
    try:
        _run_overflow_case(_dense_pair, seed=11)
    finally:
        del os.environ["SEGALIGN_DEDUP_DEVICE"]


def test_pipelined_map_chunks_matches_sequential():
    rng = np.random.default_rng(12)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    ref, query = _dense_pair(rng, n=4000)
    qrc = RC[query[::-1]]

    al = _mk(sc, sub, cbuf=512)
    al.set_ref(ref)
    al.set_query(query, qrc)
    if al._native_seeder is None:
        import pytest
        pytest.skip("native seeder unavailable")

    work = [ChunkWork(cs, ce, rev)
            for (cs, ce) in chunk_interval(0, len(query) - sc.size, 512)
            for rev in (False, True)]
    seq = [al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev)
           for w in work]
    piped = al.map_chunks(work, depth=3)
    assert len(seq) == len(piped)
    nonzero = 0
    for a, b in zip(seq, piped):
        assert a.num_hits == b.num_hits and a.num_seeds == b.num_seeds
        np.testing.assert_array_equal(a.hsps, b.hsps)
        nonzero += len(a.hsps)
    assert nonzero > 0


def test_snug_tail_program_decomposition_is_exact():
    """Strands whose hit count exceeds HBUF split into HBUF-row programs
    plus a SNUG pow2 remainder program (round 5: a uniform program size
    padded ~16% of scanned rows). Mixed program sizes must be
    bit-identical to a single big-program run."""
    rng = np.random.default_rng(21)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    # ~10k hits per chunk-strand: 24 ref copies of one exact 400 bp core
    # x ~400 seedable query positions per copy
    ref = rng.integers(0, 4, 12000).astype(np.uint8)
    query = rng.integers(0, 4, 4000).astype(np.uint8)
    core = rng.integers(0, 4, 400).astype(np.uint8)
    for i in range(24):
        p = 100 + i * 480
        ref[p:p + 400] = core
    for p in (300, 2400):
        query[p:p + 400] = core
    qrc = RC[query[::-1]]

    def mk(hbuf):
        al = DeviceAligner(
            shape_pos=sc.shape_pos, seed_size=sc.size,
            transition=sc.transition, step=1, sub_mat=sub, xdrop=910,
            hspthresh=1500, noentropy=False, chunk_size=2048,
            max_hits=10**9, HBUF=hbuf, B=256, W=128, CBUF=4096)
        al.set_ref(ref)
        al.set_query(query, qrc)
        return al

    # snug remainder classes only exist above the 2^12 class floor:
    # 8192-row programs + a 4096-class remainder
    small = mk(8192)
    big = mk(1 << 15)  # one program per strand
    if small._native_seeder is None:
        import pytest
        pytest.skip("native seeder unavailable")

    saw_mixed = False
    for (cs, ce) in chunk_interval(0, len(query) - sc.size, 2048):
        for rev in (False, True):
            pend = small.dispatch_chunk(cs, ce, rev)
            sizes = {f["candidate"].shape[0] for f in pend.fins}
            if len(sizes) > 1:
                saw_mixed = True
            got = small.finish_chunk(pend)
            want = big.seed_and_filter(cs, ce, rev)
            assert got.num_hits == want.num_hits
            np.testing.assert_array_equal(got.hsps, want.hsps,
                                          err_msg=f"{cs}:{ce} rev={rev}")
    assert saw_mixed  # the snug-remainder path actually ran


def test_map_chunks_on_result_callback():
    """on_result fires once per chunk, in work order, with the same
    results map_chunks returns (the bench's overlapped gapped stage
    consumes HSPs through this hook)."""
    rng = np.random.default_rng(12)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    ref, query = _dense_pair(rng, n=4000)
    qrc = RC[query[::-1]]
    al = _mk(sc, sub, cbuf=512)
    al.set_ref(ref)
    al.set_query(query, qrc)
    if al._native_seeder is None:
        import pytest
        pytest.skip("native seeder unavailable")
    work = [ChunkWork(cs, ce, rev)
            for (cs, ce) in chunk_interval(0, len(query) - sc.size, 512)
            for rev in (False, True)]
    seen = []
    out = al.map_chunks(work, depth=3,
                        on_result=lambda i, r: seen.append((i, r)))
    assert [i for i, _ in seen] == list(range(len(work)))
    for (i, r), o in zip(seen, out):
        np.testing.assert_array_equal(r.hsps, o.hsps)
