"""v2 k-mer-sharded seed table: exact parity vs the replicated path.

Runs the full sharded chunk program (seeding -> all_to_all routing ->
shard-local expansion -> extension -> all_gather) on the virtual 8-device
CPU mesh and asserts the final HSPs equal DeviceAligner's replicated-path
output for the same chunks. Reference seam transcended: per-GPU table
replication at /root/reference/common/seed_pos_table.cu:33-47.
"""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from segalign_tpu.config import make_seed_config, build_substitution_matrix
from segalign_tpu.index.seed_table import build_seed_table
from segalign_tpu.io.blocks import chunk_interval
from segalign_tpu.ops.extend import pad_sequence
from segalign_tpu.parallel.sharded import (shard_seed_table,
                                           make_sharded_extender,
                                           finalize_sharded)
from segalign_tpu.pipeline.device import DeviceAligner

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
S = 8


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices("cpu")
    if len(devs) < S:
        pytest.skip(f"need {S} cpu devices")
    return Mesh(np.array(devs[:S]), axis_names=("shard",))


def test_sharded_matches_replicated(mesh):
    rng = np.random.default_rng(17)
    sc = make_seed_config("12of19")
    xdrop, hspthresh = 910, 1500
    sub = build_substitution_matrix(xdrop)
    n = 4000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 700).astype(np.uint8)
    ref[500:1200] = core
    query[900:1600] = core
    mut = rng.random(700) < 0.06
    query[2500:3200] = np.where(mut, (core + 1) % 4, core).astype(np.uint8)
    ref[3000:3010] = 4  # soft-masked stretch
    qrc = RC[query[::-1]]

    it, pt = build_seed_table(ref, 1, sc.shape_pos, sc.size, sc.kmer_size)
    index_shards, pos_shards = shard_seed_table(it, pt, S)
    # sanity: shards tile the table exactly
    assert index_shards.shape == (S, 4 ** sc.kmer_size // S)
    recon = (index_shards.astype(np.int64)
             + np.concatenate([[0], np.asarray(it, np.int64)[
                 4 ** sc.kmer_size // S - 1::4 ** sc.kmer_size // S]])[
                 :-1, None]).reshape(-1)
    np.testing.assert_array_equal(recon, np.asarray(it, np.int64))

    CHUNK = 512
    pad = 512
    ext = make_sharded_extender(
        mesh, n_shards=S, kmer_size=sc.kmer_size, seed_size=sc.size,
        shape_pos=sc.shape_pos, transition=sc.transition, chunk_cap=CHUNK,
        pad=pad, W=128, xdrop=xdrop, hspthresh=hspthresh,
        CAP=2048, HCAP=4096, CCAP=2048)

    # replicated path (single device, oracle-verified elsewhere)
    al = DeviceAligner(
        shape_pos=sc.shape_pos, seed_size=sc.size, transition=sc.transition,
        step=1, sub_mat=sub, xdrop=xdrop, hspthresh=hspthresh,
        noentropy=False, chunk_size=CHUNK, max_hits=10**9, HBUF=4096,
        B=256, W=128)
    al.set_ref(ref)
    al.set_query(query, qrc)

    ref_pad = pad_sequence(ref, pad)
    sub_flat = np.ascontiguousarray(sub.reshape(-1), np.int32)

    total_hsps = 0
    for rev in (False, True):
        qarr = qrc if rev else query
        q_pad = pad_sequence(qarr, pad)
        for (cs, ce) in chunk_interval(0, n - sc.size, CHUNK):
            want = al.seed_and_filter(cs, ce, rev)
            th, ns, counts, packed, ovf = jax.device_get(ext(
                ref_pad, q_pad, index_shards, pos_shards, sub_flat,
                np.int32(cs), np.int32(ce - cs), np.int32(n), np.int32(n),
                np.int32(10**9), np.int32(0), np.int32(1 << 30)))
            assert int(ovf) == 0
            assert int(th) == want.num_hits, (cs, ce, rev)
            assert int(ns) == want.num_seeds, (cs, ce, rev)
            got = finalize_sharded(counts, packed, hspthresh, False,
                                   (ref, qarr))
            np.testing.assert_array_equal(
                got, want.hsps, err_msg=f"{cs}:{ce} rev={rev}")
            total_hsps += len(got)
    assert total_hsps > 0


def test_sharded_overflow_detected(mesh):
    """Tiny CAP must raise the overflow flag, not silently truncate."""
    rng = np.random.default_rng(3)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    n = 2000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = ref.copy()  # self-identity: dense hits
    it, pt = build_seed_table(ref, 1, sc.shape_pos, sc.size, sc.kmer_size)
    index_shards, pos_shards = shard_seed_table(it, pt, S)
    ext = make_sharded_extender(
        mesh, n_shards=S, kmer_size=sc.kmer_size, seed_size=sc.size,
        shape_pos=sc.shape_pos, transition=sc.transition, chunk_cap=512,
        pad=512, W=128, xdrop=910, hspthresh=1500,
        CAP=8, HCAP=4096, CCAP=2048)
    _, _, _, _, ovf = jax.device_get(ext(
        pad_sequence(ref, 512), pad_sequence(query, 512), index_shards,
        pos_shards, np.ascontiguousarray(sub.reshape(-1), np.int32),
        np.int32(0), np.int32(512), np.int32(n), np.int32(n),
        np.int32(10**9), np.int32(0), np.int32(1 << 30)))
    assert int(ovf) > 0


def test_sharded_aligner_last_partial_chunk_matches_replicated():
    """A chunk wider than the rest of the query: the shards past the
    query's end still slice CHUNK_LOC positions from their start, which
    must stay inside the padded query (a clamped slice read the wrong
    positions for the shard that holds the query's tail)."""
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.parallel.multi import ChunkWork, MultiDeviceAligner
    from segalign_tpu.parallel.sharded import ShardedAligner
    rng = np.random.default_rng(21)
    sc = make_seed_config("12of19")
    ref = rng.integers(0, 4, 30_000).astype(np.uint8)
    query = rng.integers(0, 4, 10_000).astype(np.uint8)
    core = ref[5_000:6_500]
    query[8_200:9_700] = np.where(rng.random(1_500) < 0.05, (core + 1) % 4,
                                  core)
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size,
              transition=sc.transition, step=1,
              sub_mat=build_substitution_matrix(910), xdrop=910,
              hspthresh=3000, noentropy=False, chunk_size=16_000)
    work = [ChunkWork(0, len(query) - sc.size, rev) for rev in (False, True)]
    outs = []
    for al in (MultiDeviceAligner(num_devices=1, **kw),
               ShardedAligner(num_devices=4, **kw)):
        al.set_ref(ref)
        al.set_query(query, revcomp_codes(query))
        outs.append(al.map_chunks(work))
    for want, got in zip(*outs):
        assert got.num_hits == want.num_hits
        np.testing.assert_array_equal(got.hsps, want.hsps)
    assert len(outs[0][0].hsps) > 0


def test_sharded_escalation_does_not_compound_across_chunks_in_flight():
    """Chunks dispatched ahead run with the capacities of their dispatch.
    One that overflows after another chunk has raised the capacities
    retries at the raised ones, so capacities grow once per need, not 4x
    per chunk in flight (which overflowed int32 on a dense pair), and the
    seed-routing CAP never grows."""
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.parallel.multi import ChunkWork, MultiDeviceAligner
    from segalign_tpu.parallel.sharded import ShardedAligner
    rng = np.random.default_rng(23)
    sc = make_seed_config("12of19")
    ref = rng.integers(0, 4, 30_000).astype(np.uint8)
    query = rng.integers(0, 4, 8_000).astype(np.uint8)
    for q0, r0 in ((500, 2_000), (4_500, 20_000)):
        core = ref[r0:r0 + 2_000]
        query[q0:q0 + 2_000] = np.where(rng.random(2_000) < 0.05,
                                        (core + 1) % 4, core)
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size,
              transition=sc.transition, step=1,
              sub_mat=build_substitution_matrix(910), xdrop=910,
              hspthresh=3000, noentropy=False, chunk_size=1_000)
    work = [ChunkWork(cs, ce, rev) for rev in (False, True)
            for cs, ce in chunk_interval(0, len(query) - sc.size, 1_000)]
    outs = []
    for al in (MultiDeviceAligner(num_devices=1, **kw),
               ShardedAligner(num_devices=4, **kw)):
        al.set_ref(ref)
        al.set_query(query, revcomp_codes(query))
        if isinstance(al, ShardedAligner):
            cap0 = al._caps[0]
            al._caps = (cap0, 16, 16)       # every chunk overflows first
        outs.append(al.map_chunks(work, depth=4))
    need = max(r.num_hits for r in outs[0])
    assert al._caps[0] == cap0
    assert al._caps[1] <= 4 * (1 << (need - 1).bit_length())
    for want, got in zip(*outs):
        assert got.num_hits == want.num_hits
        np.testing.assert_array_equal(got.hsps, want.hsps)
    assert sum(len(r.hsps) for r in outs[0]) > 0
