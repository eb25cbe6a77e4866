"""k-mer-range sharded seed table + all_to_all seed routing (v2 scale-out).

The reference replicates the full seed position table on every GPU
(/root/reference/common/seed_pos_table.cu:33-47, seed_filter_interface.cu:
86-100), which caps the reference-block size by one device's memory. Here
the table is sharded by k-mer range across a device mesh:

  shard s owns k-mers whose top log2(S) bits equal s
  (owner = kmer >> (2*kmer_size - log2 S); buckets are contiguous, so each
  shard holds a contiguous slice of index_table and pos_table)

Per chunk, under one `shard_map` program:
  1. seeding      — each shard extracts spaced-seed k-mers for its 1/S
                    position slice of the chunk (replicated query block)
  2. routing      — seeds go to their owner shard with ONE all_to_all
                    (a seed record is 8 bytes: kmer + query position)
  3. expansion    — the owner looks up its local index slice and expands
                    hits from its local pos_table slice (absolute ref
                    positions, so nothing needs re-basing)
  4. extension    — the unchanged x-drop window engine runs shard-locally
                    against the replicated sequence block
  5. gather       — compacted candidates return with an all_gather

Fixed-capacity buffers make every step static-shaped (the same discipline
as the reference's MAX_HITS batching): CAP seeds per (src, dst) pair, HCAP
hits and CCAP candidates per shard. Overflow is *detected* (psum'd flag
returned to the host) rather than silently truncated; callers re-run the
chunk with larger capacities or the replicated path.

This is the scale-out mode for reference blocks whose table exceeds one
device's memory; the single-host production path keeps host-native seeding
(pipeline/device.py). Exact-parity test: tests/test_sharded_table.py;
multi-chip compile/exec check: __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import TRANSITION_MASK


def shard_seed_table(index_table: np.ndarray, pos_table: np.ndarray,
                     n_shards: int):
    """Slice a host-built table by k-mer range.

    Returns (index_shards (S, R) int32, pos_shards (S, Pmax) int32):
      index_shards[s] — inclusive cumulative bucket counts LOCAL to the
                        shard (base subtracted)
      pos_shards[s]   — the shard's positions (absolute), zero-padded to
                        the widest shard
    """
    K = len(index_table)
    assert K % n_shards == 0
    R = K // n_shards
    idx = np.asarray(index_table, np.int64)
    bases = np.concatenate([[0], idx[R - 1::R]])  # shard start offsets
    index_shards = (idx.reshape(n_shards, R)
                    - bases[:-1, None]).astype(np.int32)
    pmax = int(np.max(bases[1:] - bases[:-1])) if len(pos_table) else 1
    pmax = max(pmax, 1)
    pos_shards = np.zeros((n_shards, pmax), np.int32)
    for s in range(n_shards):
        lo, hi = int(bases[s]), int(bases[s + 1])
        pos_shards[s, :hi - lo] = pos_table[lo:hi]
    return index_shards, pos_shards


def _extract_seeds_local(query_pad, chunk_start, chunk_len, *, CHUNK_LOC,
                         seed_size, shape_pos, transition, pad):
    """Seed extraction for one shard's position slice (no table access;
    device analog of ops/seeding.chunk_seeds minus the hit counting)."""
    k = len(shape_pos)
    nvar = 1 + k if transition else 1
    cols = []
    for i in range(seed_size):
        cols.append(jax.lax.dynamic_slice(
            query_pad, (pad + chunk_start + i,),
            (CHUNK_LOC,)).astype(jnp.int32))
    valid_pos = jnp.ones((CHUNK_LOC,), dtype=bool)
    for c in cols:
        valid_pos &= c < 4
    j = jnp.arange(CHUNK_LOC, dtype=jnp.int32)
    valid_pos &= j < chunk_len
    kmer = jnp.zeros((CHUNK_LOC,), dtype=jnp.int32)
    for i, sp in enumerate(shape_pos):
        kmer = kmer | ((cols[sp] & 3) << (2 * (k - 1 - i)))
    if transition:
        xors = jnp.array(
            [0] + [TRANSITION_MASK << (2 * t) for t in range(k)],
            dtype=jnp.int32)
        kmers = (kmer[:, None] ^ xors[None, :]).reshape(-1)
    else:
        kmers = kmer
    qpos = jnp.repeat(chunk_start + j, nvar,
                      total_repeat_length=CHUNK_LOC * nvar)
    valid = jnp.repeat(valid_pos, nvar,
                       total_repeat_length=CHUNK_LOC * nvar)
    return kmers, qpos.astype(jnp.int32), valid


def make_sharded_extender(mesh, *, n_shards, kmer_size, seed_size,
                          shape_pos, transition, chunk_cap, pad, W,
                          xdrop, hspthresh, CAP, HCAP, CCAP,
                          NB_CAP=8, axis="shard", rm_window=False):
    """Build the jitted per-chunk sharded program.

    rm_window=True adds the repeat-masker in-window restriction: hits
    whose ref_loc falls outside [win_lo, win_hi] are dropped between
    expansion and extension (repeat_masker_src/seed_filter.cu:239-244
    semantics; batch boundaries stay based on UNMASKED hit counts, like
    the replicated path's kept_cum remap).

    Returns fn(ref_pad, query_pad, index_shards, pos_shards, sub_flat,
               chunk_start, chunk_len, ref_len, query_len, max_hits,
               win_lo, win_hi)
        -> (num_hits_total, num_seeds_total, cand_counts (S,),
            packed (S*CCAP, 6), overflow int32)
    packed rows: (row index within shard, rs, qs, length, total,
    batch_id); only the first cand_counts[s] rows of each shard slice are
    meaningful. Entropy match counts are not kept on the device;
    finalize_sharded recomputes them from the extents.

    batch_id reproduces the reference's iteration-batch boundaries
    (SeedAndFilter's lower_bound chain over the seed-slot hit cumsum,
    /root/reference/src/seed_filter.cu:718-745): dedup runs PER BATCH, so
    an HSP spanning a boundary is legitimately emitted twice. The chain is
    computed in-program from the globally gathered per-slot hit counts
    (one extra all_to_all returns each seed's count to its origin shard);
    NB_CAP caps the boundary count (overflow flag raised beyond it).
    """
    from jax.sharding import PartitionSpec as P
    from ..ops.extend_fused import _extend_core
    from ..ops.scan_utils import blocked_cumsum

    S = n_shards
    assert chunk_cap % S == 0
    CHUNK_LOC = chunk_cap // S
    shift = 2 * kmer_size - int(np.log2(S))
    nvar = 1 + kmer_size if transition else 1
    NLOC = CHUNK_LOC * nvar
    TOT_SLOTS = S * NLOC

    def body(ref_pad, query_pad, index_local, pos_local, sub_flat,
             chunk_start, chunk_len, ref_len, query_len, max_hits,
             win_lo, win_hi):
        index_local = index_local[0]
        pos_local = pos_local[0]
        sid = jax.lax.axis_index(axis)

        # 1. seeding: this shard's slice of the chunk positions (slots
        # stay in the reference's global position-major order because
        # shard s covers the contiguous position range [s*CHUNK_LOC, ...))
        my_start = chunk_start + sid * CHUNK_LOC
        my_len = jnp.clip(chunk_len - sid * CHUNK_LOC, 0, CHUNK_LOC)
        kmers, qpos, valid = _extract_seeds_local(
            query_pad, my_start, my_len, CHUNK_LOC=CHUNK_LOC,
            seed_size=seed_size, shape_pos=shape_pos,
            transition=transition, pad=pad)
        gslot = sid * NLOC + jnp.arange(NLOC, dtype=jnp.int32)

        # 2. routing: bucket seeds by owner shard, one all_to_all
        owner = jnp.where(valid, kmers >> shift, S)  # invalid -> no owner
        order = jnp.argsort(owner, stable=True)      # owners ascending
        inv_order = jnp.argsort(order, stable=True)
        k_s = jnp.take(kmers, order)
        q_s = jnp.take(qpos, order)
        s_s = jnp.take(gslot, order)
        o_s = jnp.take(owner, order)
        counts = jnp.bincount(o_s, length=S + 1)[:S]
        offs = jnp.concatenate([jnp.zeros(1, counts.dtype),
                                jnp.cumsum(counts)[:-1]])
        slot = jnp.arange(NLOC, dtype=jnp.int32) - jnp.take(
            offs, jnp.minimum(o_s, S - 1)).astype(jnp.int32)
        dest = jnp.where((o_s < S) & (slot < CAP),
                         o_s * CAP + slot, S * CAP)
        send_k = jnp.full((S * CAP + 1,), -1, jnp.int32)
        send_q = jnp.zeros((S * CAP + 1,), jnp.int32)
        send_s = jnp.zeros((S * CAP + 1,), jnp.int32)
        send_k = send_k.at[dest].set(k_s, mode="drop")
        send_q = send_q.at[dest].set(q_s, mode="drop")
        send_s = send_s.at[dest].set(s_s, mode="drop")
        overflow = jnp.max(counts) > CAP
        a2a = lambda x: jax.lax.all_to_all(
            x[:S * CAP].reshape(S, CAP), axis, split_axis=0,
            concat_axis=0, tiled=False).reshape(S * CAP)
        rk = a2a(send_k)
        rq = a2a(send_q)
        rslot = a2a(send_s)

        # 3. expansion against the local table slice
        rvalid = rk >= 0
        # local bucket = low bits (shard-local k-mer range is contiguous
        # and R = 4^k / S is a power of two)
        bucket = jnp.where(rvalid, rk & (index_local.shape[0] - 1), 0)
        ends = jnp.take(index_local, bucket)
        starts = jnp.where(bucket > 0,
                           jnp.take(index_local, bucket - 1), 0)
        hit_counts = jnp.where(rvalid, ends - starts, 0).astype(jnp.int32)
        cum = jnp.cumsum(hit_counts)
        num_hits = cum[-1]
        overflow = overflow | (num_hits > HCAP)
        # hit materialization (ops/hits.expand_hits semantics, plus the
        # owning seed's global slot for batch-boundary assignment)
        g = jnp.arange(HCAP, dtype=jnp.int32)
        hvalid = g < num_hits
        gs = jnp.where(hvalid, g, 0)
        sidx = jnp.searchsorted(cum, gs, side="right").astype(jnp.int32)
        sidx = jnp.minimum(sidx, cum.shape[0] - 1)
        prev = jnp.where(sidx > 0, jnp.take(cum, sidx - 1), 0)
        bpos = jnp.take(starts, sidx) + (gs - prev)
        bpos = jnp.clip(bpos, 0, pos_local.shape[0] - 1)
        ref_loc = jnp.take(pos_local, bpos) + seed_size
        query_loc = jnp.take(rq, sidx) + seed_size
        hit_slot = jnp.take(rslot, sidx)
        if rm_window:
            hvalid = hvalid & (ref_loc >= win_lo) & (ref_loc <= win_hi)

        # 3b. reference iteration-batch boundaries: return each routed
        # seed's hit count to its origin, gather the global per-slot
        # counts, run the lower_bound chain (seed_filter.cu:718-745)
        back = jax.lax.all_to_all(
            hit_counts.reshape(S, CAP), axis, split_axis=0,
            concat_axis=0, tiled=False).reshape(S * CAP)
        back_p = jnp.concatenate([back, jnp.zeros(1, jnp.int32)])
        cnt_sorted = jnp.take(back_p, jnp.minimum(dest, S * CAP))
        cnt_slot = jnp.take(cnt_sorted, inv_order)
        all_cnt = jax.lax.all_gather(cnt_slot, axis, axis=0, tiled=True)
        gcum = blocked_cumsum(all_cnt)
        gnh = gcum[-1]
        # int32 arithmetic is safe: per-chunk hits are bounded by S*HCAP
        # (overflow-flagged above) and the clamped max_hits never exceeds
        # gnh, so val + mh <= 2*gnh << 2^31
        mh = jnp.minimum(jnp.asarray(max_hits, jnp.int32), gnh)
        mh = jnp.maximum(mh, 1)
        nb_real = jnp.where(gnh < mh, 1, gnh // mh + 1)
        overflow = overflow | (nb_real > NB_CAP)

        def chain(i, c):
            poss, limit = c
            pos = (jnp.searchsorted(gcum, limit,
                                    side="left").astype(jnp.int32) - 1)
            val = jnp.where(pos >= 0,
                            jnp.take(gcum, jnp.maximum(pos, 0)), 0)
            poss = poss.at[i].set(
                jnp.where(i < nb_real, pos, TOT_SLOTS))
            return poss, jnp.minimum(val + mh, gnh)

        poss0 = jnp.full((NB_CAP,), TOT_SLOTS, jnp.int32)
        poss, _ = jax.lax.fori_loop(0, NB_CAP, chain, (poss0, mh))
        hit_batch = jnp.sum(
            hit_slot[:, None] > poss[None, :], axis=1).astype(jnp.int32)

        # 4. shard-local extension (unchanged window engine)
        fin = _extend_core(ref_pad, query_pad, ref_loc, query_loc, hvalid,
                           sub_flat, xdrop, hspthresh, ref_len, query_len,
                           pad=pad, W=W, CONT=4096)
        cand = fin["candidate"]
        # in-batch exact-extent dedup before compaction (the sharded
        # analog of pipeline/device._pack_compact dedup_exact, same
        # bit-exactness argument): tandem-repeat diagonals yield
        # thousands of hits with ONE maximal extent; dropping them here
        # keeps CCAP small and the host finalize cheap. Keys: (rs | done
        # bit, qs); length and batch id ride as payload so only true
        # in-batch duplicates drop.
        idx32 = jnp.arange(HCAP, dtype=jnp.int32)
        nc_bit = jnp.where(jnp.logical_not(cand), jnp.int32(1) << 30, 0)
        s_k1, s_qs, s_ln, s_b, s_idx = jax.lax.sort(
            (nc_bit + fin["rs"], fin["qs"], fin["length"], hit_batch,
             idx32), num_keys=2)
        live = s_k1 < (1 << 30)
        dup = ((s_k1[1:] == s_k1[:-1]) & (s_qs[1:] == s_qs[:-1])
               & (s_ln[1:] == s_ln[:-1]) & (s_b[1:] == s_b[:-1])
               & live[1:])
        keep = live & jnp.concatenate(
            [jnp.ones(1, bool), jnp.logical_not(dup)])
        cand = jnp.zeros(HCAP, bool).at[s_idx].set(keep)
        n_c = jnp.sum(cand.astype(jnp.int32))
        overflow = overflow | (n_c > CCAP)
        perm = jnp.argsort(jnp.logical_not(cand), stable=True)
        sel = perm[:CCAP].astype(jnp.int32)
        take = lambda a: jnp.take(a, sel, axis=0)
        packed = jnp.concatenate([
            sel[:, None], take(fin["rs"])[:, None],
            take(fin["qs"])[:, None], take(fin["length"])[:, None],
            take(fin["total"])[:, None], take(hit_batch)[:, None]], axis=1)

        # 5. gather candidates + stats
        total_hits = jax.lax.psum(num_hits, axis)
        total_seeds = jax.lax.psum(
            jnp.sum(valid.astype(jnp.int32)), axis)
        all_counts = jax.lax.all_gather(n_c, axis)
        all_packed = jax.lax.all_gather(packed, axis, axis=0, tiled=True)
        any_overflow = jax.lax.psum(overflow.astype(jnp.int32), axis)
        return total_hits, total_seeds, all_counts, all_packed, any_overflow

    rep = P()
    shd = P(axis)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(rep, rep, shd, shd, rep, rep, rep, rep, rep, rep, rep,
                  rep),
        out_specs=(rep, rep, rep, rep, rep),
        check_vma=False)
    return jax.jit(fn)


class ShardedAligner:
    """Production wrapper: the MultiDeviceAligner interface over the
    sharded-table pipeline (CLI flag --sharded_table).

    Holds the k-mer-sharded table + replicated sequence blocks on an
    S-device mesh and runs every chunk through make_sharded_extender.
    Capacity overflow (hit, candidate, or batch-boundary buffers) is
    detected by the program and handled here by rebuilding the extender
    with 4x hit and candidate capacities and re-running the chunk — the
    escalation analog of the reference's fixed MAX_HITS batching
    (the reference's src/seed_filter.cu:718-745). The seed-routing CAP
    already holds a shard's whole slice of the chunk and never grows.

    Pairwise only (no RM window support): the RM path replicates its
    (single-genome) table, which by construction fits one device.
    """

    def __init__(self, *, num_devices: int = -1, devices=None, shape_pos,
                 seed_size, transition, step, sub_mat, xdrop, hspthresh,
                 noentropy, chunk_size, max_hits: int = 0,
                 window: int = 512, rm_mode: bool = False, **_ignored):
        import os
        from jax.sharding import Mesh
        if devices is None:
            platform = os.environ.get("SEGALIGN_DEVICES") or None
            devices = jax.devices(platform)
            if num_devices > 0:
                devices = devices[:num_devices]
        S = 1 << (len(devices).bit_length() - 1)  # power-of-two shards
        if S < 2:
            raise ValueError("--sharded_table needs >= 2 devices")
        self.devices = list(devices[:S])
        self.mesh = Mesh(np.array(self.devices), axis_names=("shard",))
        self.S = S
        self.shape_pos = tuple(shape_pos)
        self.kmer_size = len(shape_pos)
        self.seed_size = seed_size
        self.transition = transition
        self.step = step
        self.xdrop = xdrop
        self.hspthresh = hspthresh
        self.noentropy = noentropy
        self.chunk_cap = -(-chunk_size // S) * S
        self.max_hits = max_hits or (4194304 * 16)
        self.rm_mode = rm_mode
        # the replicated pipeline's first-window width (DeviceAligner
        # window); continuation windows use the same width here
        self.W = window
        self.pad = max(self.W, 512)
        self.sub_flat = np.ascontiguousarray(
            np.asarray(sub_mat).reshape(-1), np.int32)
        nvar = 1 + self.kmer_size if transition else 1
        # per-shard seed-routing capacity: a shard sends at most its nloc
        # seed slots to any one owner, so CAP = pow2(2 * nloc) never
        # overflows and is never escalated
        nloc = self.chunk_cap // S * nvar
        self._nvar = nvar
        # (CAP, HCAP, CCAP); HCAP/CCAP are re-derived from the measured
        # table density in set_ref (see _derive_caps) — the static
        # defaults under-sized realistic chunks ~100x and tripped the
        # 4x-escalation + extender-rebuild ladder
        self._caps = (max(4096, 1 << (2 * nloc - 1).bit_length()),
                      1 << 13, 1 << 12)
        self._ext_cache = {}
        self._rep_sharding = None
        self.ref_pad = None
        self.q_fw = None
        self.q_rc = None
        self.index_shards = None
        self.pos_shards = None
        self.ref_len = 0
        self.q_len = 0

    @property
    def num_devices(self) -> int:
        return self.S

    def _replicate(self, arr):
        from jax.sharding import NamedSharding, PartitionSpec as P
        if self._rep_sharding is None:
            self._rep_sharding = NamedSharding(self.mesh, P())
        return jax.device_put(arr, self._rep_sharding)

    def _shard0(self, arr):
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(arr, NamedSharding(self.mesh, P("shard")))

    def _pad_seq(self, codes: np.ndarray, right: int = 0) -> np.ndarray:
        from ..ops.extend import pad_sequence
        return pad_sequence(codes, self.pad, max(self.pad, right))

    def _derive_caps(self, index_table: np.ndarray) -> None:
        """Size HCAP/CCAP from the measured table density so a
        bench-density chunk never escalates (each escalation rebuilds the
        extender — a full remote recompile).

        E[hits per seed] for a seed drawn from the reference's own k-mer
        distribution is sum(c_b^2)/sum(c_b) (bucket counts c_b) — an
        upper-end estimator for the self-similar/repeat-driven density
        that dominates real genomes (tandem buckets dominate the sum, and
        query tandem content is usually below the ref's own). Per-shard
        hits/chunk ~ that times the shard's seed-slot count; 4x headroom,
        clamped to [2^13, 2^17] — the ceiling bounds the one-program
        extension state ((HCAP, W) gathers) to what fits device memory;
        denser chunks take the 4x escalation."""
        c = np.diff(np.concatenate([[0], np.asarray(index_table,
                                                    np.int64)]))
        tot = int(c.sum())
        e_hits = float((c.astype(np.float64) ** 2).sum() / max(tot, 1))
        nloc = self.chunk_cap // self.S * self._nvar
        est = nloc * max(e_hits, 1.0)
        hcap = 1 << int(np.ceil(np.log2(min(max(4 * est, 1 << 13),
                                            1 << 17))))
        # with the in-program exact dedup, surviving candidates are
        # unique extents — orders of magnitude below hits even on
        # tandem-repeat data
        ccap = max(hcap >> 3, 1 << 12)
        self._caps = (self._caps[0], hcap, ccap)

    def set_ref(self, ref_codes: np.ndarray, tables=None):
        from ..index.seed_table import build_seed_table
        self.ref_len = len(ref_codes)
        if tables is None:
            tables = build_seed_table(ref_codes, self.step, self.shape_pos,
                                      self.seed_size, self.kmer_size)
        index_table, pos_table = tables
        self._derive_caps(index_table)
        ish, psh = shard_seed_table(index_table, pos_table, self.S)
        self.index_shards = self._shard0(ish)
        self.pos_shards = self._shard0(psh)
        self.ref_pad = self._replicate(self._pad_seq(ref_codes))
        self._ref_host = np.ascontiguousarray(ref_codes, np.uint8)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        self.q_len = len(fw_codes)
        # seeding slices chunk_cap // S positions (plus the seed span) from
        # each shard's start, and XLA's dynamic_slice clamps an
        # out-of-range start silently: pad the right side past the last
        # chunk's reach
        right = self.chunk_cap + self.seed_size + 1
        self.q_fw = self._replicate(self._pad_seq(fw_codes, right))
        self.q_rc = self._replicate(self._pad_seq(rc_codes, right))
        self._q_fw_host = np.ascontiguousarray(fw_codes, np.uint8)
        self._q_rc_host = np.ascontiguousarray(rc_codes, np.uint8)

    def _extender(self, caps):
        key = caps
        if key not in self._ext_cache:
            CAP, HCAP, CCAP = caps
            self._ext_cache[key] = make_sharded_extender(
                self.mesh, n_shards=self.S, kmer_size=self.kmer_size,
                seed_size=self.seed_size, shape_pos=self.shape_pos,
                transition=self.transition, chunk_cap=self.chunk_cap,
                pad=self.pad, W=self.W, xdrop=self.xdrop,
                hspthresh=self.hspthresh, CAP=CAP, HCAP=HCAP, CCAP=CCAP,
                rm_window=self.rm_mode)
        return self._ext_cache[key]

    def _dispatch(self, chunk_start: int, chunk_end: int, rev: bool,
                  window=None):
        """Async sharded-program dispatch: returns (device outputs, args)
        without blocking; _finish collects (and escalates on overflow)."""
        q_pad = self.q_rc if rev else self.q_fw
        win_lo, win_hi = window if window is not None else (0, 1 << 30)
        caps = self._caps
        ext = self._extender(caps)
        out = ext(
            self.ref_pad, q_pad, self.index_shards, self.pos_shards,
            self.sub_flat, np.int32(chunk_start),
            np.int32(chunk_end - chunk_start), np.int32(self.ref_len),
            np.int32(self.q_len), np.int32(self.max_hits),
            np.int32(win_lo), np.int32(win_hi))
        return (out, caps, chunk_start, chunk_end, rev, win_lo, win_hi)

    def _finish(self, pend):
        import sys
        from ..pipeline.device import ChunkResult
        out, caps, chunk_start, chunk_end, rev, win_lo, win_hi = pend
        q_pad = self.q_rc if rev else self.q_fw
        for attempt in range(6):
            th, ns, counts, packed, ovf = jax.device_get(out)
            if int(ovf) == 0:
                hsps = finalize_sharded(
                    counts, packed, self.hspthresh, self.noentropy,
                    (self._ref_host,
                     self._q_rc_host if rev else self._q_fw_host),
                    rm_mode=self.rm_mode, rev=rev, ref_len=self.ref_len)
                return ChunkResult(hsps, int(th), int(ns))
            if caps != self._caps:
                # chunks dispatched ahead ran with the capacities of their
                # dispatch; when a finished chunk has raised them since,
                # retry there before growing (growing from the raised
                # values compounded 4x per chunk in flight)
                caps = self._caps
            else:
                caps = (caps[0], caps[1] * 4, caps[2] * 4)
                print(f"segalign_tpu: sharded capacity escalation to "
                      f"{caps} for chunk {chunk_start}:{chunk_end}",
                      file=sys.stderr)
                self._caps = caps  # later chunks start at the working size
            ext = self._extender(caps)
            out = ext(
                self.ref_pad, q_pad, self.index_shards, self.pos_shards,
                self.sub_flat, np.int32(chunk_start),
                np.int32(chunk_end - chunk_start), np.int32(self.ref_len),
                np.int32(self.q_len), np.int32(self.max_hits),
                np.int32(win_lo), np.int32(win_hi))
        raise RuntimeError("sharded-table capacity escalation exhausted")

    def _run_chunk(self, chunk_start: int, chunk_end: int, rev: bool,
                   window=None):
        return self._finish(self._dispatch(chunk_start, chunk_end, rev,
                                           window))

    def map_chunks(self, work, depth: int = 4):
        """Pipelined: keep up to `depth` sharded programs dispatched ahead
        so the host's candidate fetch + finalize/dedup of chunk k overlaps
        device execution of chunks k+1..k+depth (the dispatch/finish split
        of the replicated path, DeviceAligner.map_chunks, applied to the
        one-program-per-chunk sharded flow)."""
        from collections import deque
        results = []
        pend: "deque" = deque()
        for w in work:
            pend.append(self._dispatch(w.chunk_start, w.chunk_end, w.rev,
                                       w.window))
            if len(pend) > depth:
                results.append(self._finish(pend.popleft()))
        while pend:
            results.append(self._finish(pend.popleft()))
        return results


def finalize_sharded(cand_counts, packed, hspthresh, noentropy, seqs,
                     rm_mode: bool = False, rev: bool = False,
                     ref_len: int = 0):
    """Host finalize of a gathered candidate set: entropy + accept, then
    dedup PER iteration batch (packed column 5 carries the reference
    batch id). seqs = (ref codes, query codes of this strand): the
    entropy match counts are recomputed from them and the extents.
    rm_mode selects the repeat-masker dedup chain and the minus-strand
    query remap (repeat_masker_src/seed_filter.cu:705-709).
    Returns (n, 4) int64 HSPs in batch order.

    Within a batch, candidate input order is irrelevant: dedup keys on
    (diag, rs, len, score), and rows with identical keys are identical
    HSPs, so any order of the same candidate SET yields the same output.
    """
    from ..ops.finalize import finalize_candidates
    from ..ops.dedup import dedup_pairwise, dedup_rm
    S = len(cand_counts)
    CCAP = packed.shape[0] // S
    rows = []
    for s in range(S):
        n = int(cand_counts[s])
        if n:
            rows.append(np.asarray(packed[s * CCAP:s * CCAP + n]))
    if not rows:
        return np.zeros((0, 4), np.int64)
    allrows = np.concatenate(rows).astype(np.int64)
    out = []
    for b in np.unique(allrows[:, 5]):
        r = allrows[allrows[:, 5] == b]
        cnt = np.zeros((len(r), 4), np.int64)
        if not noentropy:
            # entropy-band rows only (oracle/scan_spec.py: counts are a
            # pure function of the extents)
            from ..native import entropy_counts_host
            ref_codes, q_codes = seqs
            band = ((r[:, 4] >= hspthresh) & (r[:, 4] <= 3 * hspthresh))
            if band.any():
                cnt[band] = entropy_counts_host(
                    ref_codes, q_codes, r[band, 1], r[band, 2], r[band, 3])
        accepted, scores = finalize_candidates(
            r[:, 1], r[:, 2], r[:, 3], r[:, 4], cnt, hspthresh,
            noentropy)
        if not accepted.any():
            continue
        rs, qs, ln, sc = (r[accepted, 1], r[accepted, 2], r[accepted, 3],
                          scores[accepted])
        if rm_mode and rev:
            qs = ref_len - 1 - (qs + ln)
        if rm_mode:
            rs, qs, ln, sc = dedup_rm(rs, qs, ln, sc)
        else:
            rs, qs, ln, sc = dedup_pairwise(rs, qs, ln, sc)
        out.append(np.stack([rs, qs, ln, sc], axis=1))
    return (np.concatenate(out) if out else np.zeros((0, 4), np.int64))
