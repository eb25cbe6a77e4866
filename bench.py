"""Benchmark: ungapped seed-filter-extend throughput on one chip.

Generates a synthetic genome pair with realistic repeat + homology
structure, runs the full per-chunk pipeline (native seeding -> hit
expansion -> x-drop extension -> candidate compaction -> host
finalize/dedup), and reports query throughput.

Prints ONE json line:
  {"metric": "ungapped_query_mbps", "value": ..., "unit": "Mbp/s",
   "vs_baseline": ..., "densities": {...}, "legacy_planted_mbps": ...,
   "engine_parity": "..."}

The HEADLINE value comes from the repeat-structured generator at 1x
repeat content (shared interspersed repeat families + microsatellite
tandems + soft-masked runs + N gaps — the heavy-tailed seed-hit
distribution real genome pairs show). `densities` reports a 0.5x/1x/4x
repeat-content sweep; `legacy_planted_mbps` keeps the round-1..3
planted-homology config for cross-round continuity. `engine_parity`
byte-compares one chunk-strand at two first-window widths on the device
and raises on a mismatch.

vs_baseline normalizes against NOMINAL_V100_MBPS, an ESTIMATE of
SegAlign's per-V100 ungapped throughput on comparable data. The reference
repo publishes no numbers (BASELINE.md); the estimate derives from the SC20
paper's reported end-to-end speedups over lastz on AWS P3. Treat it as a
fixed yardstick across rounds, not ground truth.

Env: BENCH_REF_FASTA/BENCH_QUERY_FASTA real inputs; BENCH_REF_MBP /
BENCH_QUERY_MBP sizes; BENCH_SWEEP=0 / BENCH_LEGACY=0 / BENCH_VERIFY=0
skip the extra sections; SEGALIGN_BENCH_GAPPED=0 skips the gapped stage.
"""

import json
import os
import sys
import time

import numpy as np

NOMINAL_V100_MBPS = 2.0

REF_MBP = float(os.environ.get("BENCH_REF_MBP", 4.0))
QUERY_MBP = float(os.environ.get("BENCH_QUERY_MBP", 4.0))
CHUNK = 250_000


def synth_genome(rng, n, homolog_from=None, identity=0.85, repeat_frac=0.10):
    """Round-1..3 generator: planted diverged homology on a uniform
    background (extension-dominated; ~6.2e6 hits/Mbp at 4 Mbp)."""
    seq = rng.integers(0, 4, n).astype(np.uint8)
    if homolog_from is not None:
        # plant diverged copies of segments of the partner genome
        total = int(n * repeat_frac)
        placed = 0
        while placed < total:
            ln = int(rng.integers(2_000, 30_000))
            src = int(rng.integers(0, len(homolog_from) - ln))
            dst = int(rng.integers(0, n - ln))
            core = homolog_from[src:src + ln]
            mut = rng.random(ln) >= identity
            seq[dst:dst + ln] = np.where(
                mut, (core + rng.integers(1, 4, ln)) % 4, core)
            placed += ln
    # soft-masked and N stretches like real assemblies
    for _ in range(n // 500_000):
        p = int(rng.integers(0, n - 1000))
        seq[p:p + int(rng.integers(100, 1000))] = 4
    for _ in range(n // 1_000_000):
        p = int(rng.integers(0, n - 500))
        seq[p:p + int(rng.integers(50, 500))] = 5
    return seq


def make_repeat_library(rng):
    """Shared repeat library for a genome PAIR: interspersed repeat family
    consensus sequences (SINE/LINE-like length mix) and microsatellite
    units. Both genomes draw copies from the SAME library — ancient
    shared families are what give real pairs their heavy-tailed
    cross-genome seed-hit distribution."""
    fams = [(150, 0.10), (300, 0.10), (600, 0.14), (1500, 0.16),
            (5000, 0.18)]
    lib = [(rng.integers(0, 4, ln).astype(np.uint8), div)
           for ln, div in fams]
    units = [np.array(u, np.uint8) for u in
             ([0, 3], [1, 0], [1, 0, 2], [3, 3, 0, 2, 2, 1])]
    return lib, units


def synth_genome_repeats(rng, n, lib, homolog_from=None, identity=0.85,
                         homology_frac=0.10, repeat_mult=1.0):
    """Repeat-structured generator: interspersed family copies (fragmented,
    per-copy diverged, mostly soft-masked like RepeatMasker output),
    shared-unit tandem arrays, planted diverged homology, soft-masked runs
    and N gaps. repeat_mult scales UNMASKED repeat content and thereby the
    seed-hit density (reported, not assumed)."""
    fams, units = lib
    seq = rng.integers(0, 4, n).astype(np.uint8)
    # ~25% repeat-derived sequence, ~88% of copies soft-masked: genomes
    # fed to whole-genome aligners are post-RepeatMasker (that is what
    # the reference RM mode produces), so only the masker's misses stay
    # seedable — those drive the cross-genome repeat HSPs
    budget = int(n * 0.25 * 0.12 * repeat_mult)
    while budget > 0:
        cons, div = fams[int(rng.integers(0, len(fams)))]
        ln = len(cons)
        take = int(rng.integers(ln // 4, ln + 1))   # 5'-truncated copies
        frag = cons[ln - take:]
        mut = rng.random(take) < div * rng.uniform(0.3, 1.7)
        copy = np.where(mut, (frag + rng.integers(1, 4, take)) % 4, frag)
        p = int(rng.integers(0, n - take))
        if rng.random() < 0.88:
            seq[p:p + take] = 4        # soft-masked copy: no seeds
        else:
            seq[p:p + take] = copy
            budget -= take
    for _ in range(max(1, n // 250_000)):           # tandem arrays
        u = units[int(rng.integers(0, len(units)))]
        reps = int(rng.integers(20, 400))
        arr = np.tile(u, reps)[:8000]
        p = int(rng.integers(0, n - len(arr)))
        if rng.random() < 0.85:
            seq[p:p + len(arr)] = 4
        else:
            seq[p:p + len(arr)] = arr
    if homolog_from is not None:
        placed = 0
        total = int(n * homology_frac)
        while placed < total:
            ln = int(rng.integers(2_000, 30_000))
            src = int(rng.integers(0, len(homolog_from) - ln))
            dst = int(rng.integers(0, n - ln))
            core = homolog_from[src:src + ln]
            mut = rng.random(ln) >= identity
            seq[dst:dst + ln] = np.where(
                mut, (core + rng.integers(1, 4, ln)) % 4, core)
            placed += ln
    for _ in range(n // 1_000_000):                 # N gaps
        p = int(rng.integers(0, n - 500))
        seq[p:p + int(rng.integers(50, 500))] = 5
    return seq


def synth_genome_repeats_sweep(rng, n, lib, homolog_from=None,
                               repeat_mult=1.0):
    """Density-sweep generator: like synth_genome_repeats but with the
    SEEDABLE repeat content controlled deterministically so repeat_mult
    moves measured hits/Mbp monotonically (a sweep whose density rides
    on coin-flips over whether the few tandem arrays stay unmasked is not
    monotone). Exact counts, not probabilities:
    unmasked interspersed budget and unmasked tandem-array count both
    scale linearly with repeat_mult; masked copies stay fixed."""
    fams, units = lib
    seq = rng.integers(0, 4, n).astype(np.uint8)
    budget = int(n * 0.03 * repeat_mult)        # unmasked interspersed
    while budget > 0:
        cons, div = fams[int(rng.integers(0, len(fams)))]
        ln = len(cons)
        take = int(rng.integers(ln // 4, ln + 1))
        frag = cons[ln - take:]
        mut = rng.random(take) < div * rng.uniform(0.3, 1.7)
        copy = np.where(mut, (frag + rng.integers(1, 4, take)) % 4, frag)
        p = int(rng.integers(0, n - take))
        seq[p:p + take] = copy
        budget -= take
    for _ in range(n // 200_000):               # masked copies (no seeds)
        cons, _ = fams[int(rng.integers(0, len(fams)))]
        take = int(rng.integers(len(cons) // 4, len(cons) + 1))
        p = int(rng.integers(0, n - take))
        seq[p:p + take] = 4
    n_tandem = max(1, round(n / 1e6 * repeat_mult))  # unmasked tandems
    for _ in range(n_tandem):
        u = units[int(rng.integers(0, len(units)))]
        arr = np.tile(u, int(rng.integers(20, 400)))[:8000]
        p = int(rng.integers(0, n - len(arr)))
        seq[p:p + len(arr)] = arr
    if homolog_from is not None:
        placed = 0
        total = int(n * 0.10)
        while placed < total:
            ln = int(rng.integers(2_000, 30_000))
            src = int(rng.integers(0, len(homolog_from) - ln))
            dst = int(rng.integers(0, n - ln))
            core = homolog_from[src:src + ln]
            mut = rng.random(ln) >= 0.85
            seq[dst:dst + ln] = np.where(
                mut, (core + rng.integers(1, 4, ln)) % 4, core)
            placed += ln
    for _ in range(n // 1_000_000):
        p = int(rng.integers(0, n - 500))
        seq[p:p + int(rng.integers(50, 500))] = 5
    return seq


def load_inputs():
    """Synthetic pair by default; real FASTA via BENCH_REF_FASTA /
    BENCH_QUERY_FASTA env paths (BASELINE.md configs run the moment
    genomes are mounted). Real inputs report the measured hit density so
    the synthetic generators' density choices can be validated."""
    ref_fa = os.environ.get("BENCH_REF_FASTA")
    query_fa = os.environ.get("BENCH_QUERY_FASTA")
    if ref_fa and query_fa:
        from segalign_tpu.io.fasta import read_fasta
        from segalign_tpu.io.encode import encode
        ref = np.concatenate([encode(s) for _, s in read_fasta(ref_fa)])
        query = np.concatenate([encode(s)
                                for _, s in read_fasta(query_fa)])
        print(f"bench inputs: {ref_fa} ({len(ref)/1e6:.1f} Mbp) x "
              f"{query_fa} ({len(query)/1e6:.1f} Mbp)", file=sys.stderr)
        return ref, query
    rng = np.random.default_rng(2024)
    lib = make_repeat_library(rng)
    ref = synth_genome_repeats(rng, int(REF_MBP * 1e6), lib)
    query = synth_genome_repeats(rng, int(QUERY_MBP * 1e6), lib,
                                 homolog_from=ref)
    return ref, query


def make_aligner(chunk_size=CHUNK):
    from segalign_tpu.config import make_seed_config, \
        build_substitution_matrix
    from segalign_tpu.pipeline.device import DeviceAligner
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    return DeviceAligner(
        shape_pos=sc.shape_pos, seed_size=sc.size, transition=True, step=1,
        sub_mat=sub, xdrop=910, hspthresh=3000, noentropy=False,
        chunk_size=chunk_size), sc, sub


def run_config(ref, query, label, al=None, qrc=None, skip_setup=False):
    """Align one synthetic/real pair end to end; returns a result dict
    (mbps, hit density, HSP batches for the gapped stage).

    skip_setup reuses an aligner whose ref/query state is already set
    (steady-state re-run of the same pair: every executable and device
    block is warm, so the measurement is pure pipeline)."""
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.parallel.multi import ChunkWork
    if qrc is None:
        qrc = revcomp_codes(query)
    if al is None:
        al, _, _ = make_aligner()
    table_s = 0.0
    q_len = len(query) - al.seed_size
    if not skip_setup:
        t0 = time.time()
        al.set_ref(ref)
        table_s = time.time() - t0
        al.set_query(query, qrc)
        # warmup: compile on first chunks
        al.seed_and_filter(0, min(CHUNK, q_len), rev=False)
        al.seed_and_filter(0, min(CHUNK, q_len), rev=True)
    work = []
    for cs in range(0, q_len, CHUNK):
        work.append(ChunkWork(cs, min(cs + CHUNK, q_len), False))
        work.append(ChunkWork(cs, min(cs + CHUNK, q_len), True))
    t1 = time.time()
    stats = dict(hsps=0, hits=0, seeds=0)
    results = al.map_chunks(work, depth=6)
    for r in results:
        stats["hsps"] += len(r.hsps)
        stats["hits"] += r.num_hits
        stats["seeds"] += r.num_seeds
    dt = time.time() - t1
    n_query = len(query)
    mbps = (n_query / 1e6) / dt
    dens = stats["hits"] / (n_query / 1e6)
    dump = os.environ.get("BENCH_SAVE_HSPS")
    if dump:
        np.savez(dump, **{f"h{i}_{int(w.rev)}_{w.chunk_start}": r.hsps
                          for i, (r, w) in enumerate(zip(results, work))
                          if len(r.hsps)})
    print(f"bench[{label}]: {n_query/1e6:.0f} Mbp query vs "
          f"{len(ref)/1e6:.0f} Mbp ref in {dt:.2f}s (+{table_s:.2f}s "
          f"table) | seeds={stats['seeds']} hits={stats['hits']} "
          f"hsps={stats['hsps']} ({dens:.2g} hits/Mbp) -> "
          f"{mbps:.3f} Mbp/s", file=sys.stderr, flush=True)
    return dict(mbps=mbps, density=dens, dt=dt, stats=stats,
                batches=[(r.hsps, w.rev) for r, w in zip(results, work)
                         if len(r.hsps)], qrc=qrc, al=al)


def bench_gapped_overlap(ref, query, qrc, al, sub8x8):
    """End-to-end pass with the gapped stage OVERLAPPING the ungapped
    pipeline and the product path's anchor-interference filter
    (output/native_gapped._InterferenceIndex semantics: an anchor inside
    an accepted alignment's box is skipped — lastz discards covered
    anchors the same way, which the reference inherits by delegation).

    Concurrency mirrors the reference driver, which eval-s lastz
    commands while segalign still runs (scripts/run_segalign:112-117):
    DP jobs start as chunks finish, on host threads that are idle-heavy
    during the device-bound ungapped run. Parallelism within the
    ordered filter is speculative and barrier-free: each batch's jobs
    enqueue score-descending; every worker re-checks coverage right
    before its DP and indexes acceptances right after — a parallel
    schedule of the same filter (concurrent anchors may both run where
    the serial order would skip one; measured skip rate ~50%)."""
    from concurrent.futures import ThreadPoolExecutor
    from segalign_tpu.native import gapped_extend_native
    from segalign_tpu.parallel.multi import ChunkWork
    import threading
    q_len = len(query) - al.seed_size
    work = []
    for cs in range(0, q_len, CHUNK):
        work.append(ChunkWork(cs, min(cs + CHUNK, q_len), False))
        work.append(ChunkWork(cs, min(cs + CHUNK, q_len), True))
    cap = int(os.environ.get("BENCH_GAPPED_MAX", "20000"))
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
    lock = threading.Lock()
    SHIFT = 14
    index = {False: ([], {}), True: ([], {})}  # items, r-bucket dict
    stats = dict(dp=0, skip=0, acc=0, seen=0)
    futs = []

    def covered(rev, mr, mq):
        items, buckets = index[rev]
        for i in buckets.get(mr >> SHIFT, ()):
            r0, r1, q0, q1 = items[i]
            if r0 <= mr < r1 and q0 <= mq < q1:
                return True
        return False

    def add(rev, box):
        items, buckets = index[rev]
        i = len(items)
        items.append(box)
        for b in range(box[0] >> SHIFT,
                       (max(box[1] - 1, box[0]) >> SHIFT) + 1):
            buckets.setdefault(b, []).append(i)

    def one(rev, mid_r, mid_q):
        with lock:
            if covered(rev, mid_r, mid_q):
                stats["skip"] += 1
                return
            stats["dp"] += 1
        r = gapped_extend_native(ref, qrc if rev else query, sub8x8,
                                 400, 30, 9430, mid_r, mid_q)
        if r is not None and r[0] >= 3000:
            with lock:
                stats["acc"] += 1
                add(rev, (r[1], r[3], r[2], r[4]))

    def on_result(i, res):
        rev = work[i].rev
        jobs = sorted(((int(sc), int(rs + ln // 2), int(qs + ln // 2))
                       for rs, qs, ln, sc in res.hsps), reverse=True)
        for _, mr, mq in jobs:
            if stats["seen"] < cap:
                stats["seen"] += 1
                futs.append(pool.submit(one, rev, mr, mq))

    t0 = time.time()
    al.map_chunks(work, depth=6, on_result=on_result)
    t_ungapped = time.time() - t0
    for f in futs:
        f.result()
    pool.shutdown(wait=True)
    t_total = time.time() - t0
    e2e = (len(query) / 1e6) / t_total
    print(f"e2e[overlapped+interference]: ungapped {t_ungapped:.2f}s, "
          f"+gapped drain {t_total - t_ungapped:.2f}s = {t_total:.2f}s "
          f"total ({stats['dp']} DPs, {stats['skip']} skipped, "
          f"{stats['acc']} accepted) -> {e2e:.3f} Mbp/s",
          file=sys.stderr, flush=True)
    return e2e


def bench_gapped(ref, q_fw, q_rc, hsp_batches, sub8x8, ungapped_dt):
    """Native ydrop gapped stage over the ungapped stage's real output:
    one DP extension per final HSP, anchored at its midpoint — the same
    per-segment contract the reference delegates to <= nproc lastz
    processes (scripts/run_segalign:112-117). HSP-dense workloads are
    SAMPLED (BENCH_GAPPED_MAX, default 20000 segments) and the
    end-to-end number extrapolates the measured segments/s — printed as
    such."""
    from concurrent.futures import ThreadPoolExecutor
    from segalign_tpu.native import gapped_extend_native
    jobs = []
    for hsps, rev in hsp_batches:
        q = q_rc if rev else q_fw
        for rs, qs, ln, sc in hsps:
            jobs.append((q, int(rs + ln // 2), int(qs + ln // 2)))
    n_all = len(jobs)
    cap = int(os.environ.get("BENCH_GAPPED_MAX", "20000"))
    if n_all > cap:
        idx = np.linspace(0, n_all - 1, cap).astype(int)
        jobs = [jobs[i] for i in idx]
    t0 = time.time()

    def one(j):
        q, mid_r, mid_q = j
        r = gapped_extend_native(ref, q, sub8x8, 400, 30, 9430,
                                 mid_r, mid_q)
        return r is not None and r[0] >= 3000

    # ctypes releases the GIL during the DP; <= nproc workers like the
    # reference's lastz process pool
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        nacc = sum(ex.map(one, jobs))
    g_s = time.time() - t0
    g_full = g_s * n_all / max(len(jobs), 1)
    e2e = (len(q_fw) / 1e6) / (ungapped_dt + g_full)
    note = (f" [sampled {len(jobs)}/{n_all}, extrapolated]"
            if n_all > len(jobs) else "")
    print(f"gapped stage (native ydrop): {len(jobs)} segments in "
          f"{g_s:.2f}s ({len(jobs)/max(g_s,1e-9):.0f} segments/s, "
          f"{nacc} accepted) | end-to-end {e2e:.3f} Mbp/s{note}",
          file=sys.stderr, flush=True)


def engine_parity(ref, query, qrc):
    """Run one chunk-strand at two first-window widths (512 and 256):
    window-decomposition independence is the core correctness property of
    the scan-form extension (oracle/scan_spec.py), and the two widths
    compile distinct programs. Raises on a mismatch; returns
    'identical:...' or 'skipped:BENCH_VERIFY=0'."""
    if os.environ.get("BENCH_VERIFY", "1") == "0":
        return "skipped:BENCH_VERIFY=0"
    outs = {}
    for name, window in (("w512", "512"), ("w256", "256")):
        old = os.environ.get("SEGALIGN_WINDOW")
        os.environ["SEGALIGN_WINDOW"] = window
        try:
            al, _, _ = make_aligner()
            al.set_ref(ref[:1_000_000])
            al.set_query(query[:1_000_000], qrc[-1_000_000:])
            outs[name] = al.seed_and_filter(0, CHUNK, rev=False).hsps
        finally:
            if old is None:
                os.environ.pop("SEGALIGN_WINDOW", None)
            else:
                os.environ["SEGALIGN_WINDOW"] = old
    if not np.array_equal(outs["w512"], outs["w256"]):
        raise AssertionError(f"engine parity: w512 != w256 "
                             f"({outs['w512'].shape} vs "
                             f"{outs['w256'].shape})")
    n = len(outs["w512"])
    print(f"engine parity: w512 == w256 over 1 chunk-strand ({n} HSPs)",
          file=sys.stderr, flush=True)
    return f"identical:w512+w256:{n}hsps"


def run_breakdown(ref, query, res):
    """Serial, per-program-synchronized re-run of the headline config:
    every stage time is a true blocking measurement (async dispatch hides
    device time inside finish's d2h wait otherwise). Returns the stage
    dict plus the run's wall; kernel_fraction = device extension time /
    serial wall. Accounts for >=80% of the serial wall by construction."""
    from segalign_tpu.pipeline import device as devmod
    old = {k: os.environ.get(k) for k in
           ("SEGALIGN_SYNC", "SEGALIGN_OVERLAP")}
    os.environ["SEGALIGN_SYNC"] = "1"
    os.environ["SEGALIGN_OVERLAP"] = "0"
    devmod.reset_stage_totals()
    try:
        r = run_config(ref, query, "repeat-1x-serial", al=res["al"],
                       qrc=res["qrc"], skip_setup=True)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stages = {k: round(v, 3) for k, v in devmod.STAGE_TOTALS.items()}
    covered = sum(devmod.STAGE_TOTALS.values())
    wall = r["dt"]
    kf = devmod.STAGE_TOTALS.get("extend", 0.0) / max(wall, 1e-9)
    print(f"breakdown[serial-sync]: wall={wall:.2f}s covered="
          f"{covered:.2f}s ({100*covered/max(wall,1e-9):.0f}%) "
          f"kernel_fraction={kf:.2f} stages={stages}",
          file=sys.stderr, flush=True)
    return dict(stages=stages, serial_wall=round(wall, 2),
                covered_frac=round(covered / max(wall, 1e-9), 3),
                kernel_fraction=round(kf, 3))


def main():
    ref, query = load_inputs()
    real_inputs = bool(os.environ.get("BENCH_REF_FASTA"))

    # Cold pass compiles every data-dependent executable (pow2 size
    # classes the warmup chunks never reach); the steady pass is the
    # HEADLINE — per-chip throughput with compilation excluded, the same
    # convention as the reference's timers (src/main.cpp:745-748 time the
    # pipeline after GPU init) and robust to a cold persistent cache in
    # a fresh process. BENCH_STEADY=0
    # keeps the single cold pass as headline.
    res = run_config(ref, query, "repeat-1x-cold")
    cold_s = res["dt"]
    if os.environ.get("BENCH_STEADY", "1") != "0":
        # best of N steady passes: the minimum wall is the machine's
        # capability, which is what a throughput benchmark reports (the
        # spread between passes is untested on the H100)
        reps = int(os.environ.get("BENCH_STEADY_REPS", "3"))
        best = None
        for r in range(reps):
            cur = run_config(ref, query, "repeat-1x", al=res["al"],
                             qrc=res["qrc"], skip_setup=True)
            if best is None or cur["dt"] < best["dt"]:
                best = cur
        res = best
    headline = res["mbps"]
    densities = {"1x": dict(mbps=round(res["mbps"], 3),
                            hits_per_mbp=round(res["density"]))}

    breakdown = None
    if os.environ.get("BENCH_BREAKDOWN", "1") != "0":
        breakdown = run_breakdown(ref, query, res)

    e2e_mbps = None
    if os.environ.get("SEGALIGN_BENCH_GAPPED", "1") != "0":
        from segalign_tpu.config import build_substitution_matrix
        sub8x8 = build_substitution_matrix(910)
        bench_gapped(ref, query, res["qrc"], res["batches"], sub8x8,
                     res["dt"])
        e2e_mbps = round(bench_gapped_overlap(
            ref, query, res["qrc"], res["al"], sub8x8), 3)

    if not real_inputs and os.environ.get("BENCH_SWEEP", "1") != "0":
        n = int(min(REF_MBP, 2.0) * 1e6)
        for mult, key in ((0.5, "0.5x"), (4.0, "4x")):
            # per-config rng + mult applied to BOTH genomes: the knob
            # controls the measured density monotonically (density-sweep
            # generator doc). Steady-state like the headline: first pass
            # compiles this size class's executables.
            rng = np.random.default_rng(7000 + int(mult * 10))
            lib = make_repeat_library(rng)
            r2 = synth_genome_repeats_sweep(rng, n, lib, repeat_mult=mult)
            q2 = synth_genome_repeats_sweep(rng, n, lib, homolog_from=r2,
                                            repeat_mult=mult)
            rr = run_config(r2, q2, f"repeat-{key}-cold")
            rr = run_config(r2, q2, f"repeat-{key}", al=rr["al"],
                            qrc=rr["qrc"], skip_setup=True)
            densities[key] = dict(mbps=round(rr["mbps"], 3),
                                  hits_per_mbp=round(rr["density"]))

    legacy = None
    if not real_inputs and os.environ.get("BENCH_LEGACY", "1") != "0":
        rng = np.random.default_rng(2024)
        r3 = synth_genome(rng, int(REF_MBP * 1e6))
        q3 = synth_genome(rng, int(QUERY_MBP * 1e6), homolog_from=r3)
        r0 = run_config(r3, q3, "legacy-planted-cold")
        legacy = round(run_config(r3, q3, "legacy-planted", al=r0["al"],
                                  qrc=r0["qrc"],
                                  skip_setup=True)["mbps"], 3)

    parity = engine_parity(ref, query, res["qrc"])

    out = {
        "metric": "ungapped_query_mbps",
        "value": round(headline, 3),
        "unit": "Mbp/s",
        "vs_baseline": round(headline / NOMINAL_V100_MBPS, 3),
        "cold_s": round(cold_s, 2),
        "densities": densities,
        "engine_parity": parity,
    }
    if breakdown is not None:
        out["kernel_fraction"] = breakdown["kernel_fraction"]
        out["breakdown"] = breakdown
    if e2e_mbps is not None:
        out["e2e_overlapped_mbps"] = e2e_mbps
    if legacy is not None:
        out["legacy_planted_mbps"] = legacy
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
