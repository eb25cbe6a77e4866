#!/usr/bin/env python3
"""Smoke run of the aligner's main path on one NVIDIA GPU.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: the multi-GPU phase only

Phases (any failure exits non-zero and prints no result line):

  device   JAX's default backend is a GPU; the native host library was
           built from this tree's sources and DeviceAligner seeds with it.
  step     x-drop window step at HBUF = 2^17 rows of real seed hits, first
           window W = 512 and continuation W_CONT = 2048, both directions:
           the Triton kernel equals the XLA step on every row, and the XLA
           step equals the NumPy window spec (oracle/scan_spec.window_step)
           on 4096 sampled rows; done/cum/maxv/maxp bit-identical.
  chunk    one 250 kb query chunk, each strand, through DeviceAligner at the
           production HBUF equals oracle.seed_and_filter (hit count and HSPs).
  cli      a 32 Mbp target (chromosomes of 20 and 12 Mbp) against a 4 Mbp
           query (16 chunks of 250 kb, both strands) from bench.py's
           repeat-structured generator, through
           `python -m segalign_tpu.cli.run_segalign ... --format maf-
           --gapped_mode native` at the reference defaults (12of19,
           transitions, xdrop 910, hspthresh 3000), run cold then warm: exit
           0, identical non-empty MAF, every block re-scored from its aligned
           text to its stated score. Prints both wall times, the CLI's
           own summary (pipeline time, seed hits, HSPs) and the sha256.
  --four   the cli phase's 32 Mbp target against a query of FOUR_QUERY_LEN
           from the same generator, on 4 GPUs with the k-mer-sharded table
           (--sharded_table), on 4 GPUs with replicated tables
           (--num_gpu 4) and on 1 GPU: the three MAF files must be
           byte-identical.

The parent process never starts a JAX backend: the in-process phases run in
one child, each CLI run is another, so one process holds the card at a
time. The last stdout line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBUF = 1 << 17
W, W_CONT = 512, 2048
CHUNK = 250_000
STEP_PAIR = (8_000_000, 1_000_000)     # target, query lengths
CHUNK_PAIR = (1_000_000, 300_000)
TARGET_CHROMS = (("chr1", 20_000_000), ("chr2", 12_000_000))
QUERY_LEN = 4_000_000
FOUR_QUERY_LEN = 1_000_000
SPEC_ROWS = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device() -> dict:
    """The device JAX computes on; exits unless it is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX's backend is "
                         f"{jax.default_backend()!r}, not a GPU")
    d = jax.devices()[0]
    return dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def median_time(fn, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- in-process phases (child) ----------------------------------------------

def phase_device() -> dict:
    import jax
    info = check_device()
    from segalign_tpu import native
    log(f"device: {info['kind']} x{info['count']} | nvidia-smi: "
        f"{nvidia_smi()}")
    flags = os.environ.get("XLA_FLAGS", "")
    log(f"jax {jax.__version__} | XLA_FLAGS={flags!r} | compile cache: "
        f"{jax.config.jax_compilation_cache_dir}")
    lib = native.get_lib()
    if lib is None or lib._name != native.lib_path():
        raise SystemExit("chip_smoke: native library not built from this "
                         "tree's sources")
    log(f"native library: {lib._name}")
    return info


def repeat_pair(ref_len: int, query_len: int, seed: int):
    import bench
    rng = np.random.default_rng(seed)
    lib = bench.make_repeat_library(rng)
    ref = bench.synth_genome_repeats(rng, ref_len, lib)
    query = bench.synth_genome_repeats(rng, query_len, lib,
                                       homolog_from=ref)
    return ref, query


def phase_step() -> None:
    import jax
    import jax.numpy as jnp
    from segalign_tpu.config import (build_substitution_matrix,
                                     make_seed_config)
    from segalign_tpu.index.seed_table import build_seed_table
    from segalign_tpu.native import ChunkSeeder
    from segalign_tpu.ops.extend import pad_sequence
    from segalign_tpu.ops.extend3 import _extension_window_step_jit
    from segalign_tpu.ops.window_kernel import window_step_kernel
    from segalign_tpu.oracle.scan_spec import window_step

    ref, query = repeat_pair(*STEP_PAIR, 11)
    sc = make_seed_config("12of19")
    it, pt = build_seed_table(ref, 1, sc.shape_pos, sc.size, sc.kmer_size)
    rl, ql, *_ = ChunkSeeder(CHUNK, sc.kmer_size, True).seed(
        query, 0, CHUNK, it, pt, sc.shape_pos, sc.size, 1 << 30)
    rng = np.random.default_rng(12)
    pick = np.sort(rng.choice(len(rl), HBUF, replace=False))
    rl, ql = rl[pick], ql[pick]
    sub = build_substitution_matrix(910)
    d_sub = jnp.asarray(sub.reshape(-1), jnp.int32)
    rp = jnp.asarray(pad_sequence(ref, W_CONT))
    qp = jnp.asarray(pad_sequence(query, W_CONT))
    d_rl, d_ql = jnp.asarray(rl), jnp.asarray(ql)
    zc = jnp.zeros((HBUF, 4), jnp.int32)
    kernel = jax.jit(window_step_kernel, static_argnames=("pad", "W", "left"))
    sample = np.sort(rng.choice(HBUF, SPEC_ROWS, replace=False))
    for left in (False, True):
        for w, tile in ((W, 0), (W_CONT, W)):
            z = jnp.zeros((HBUF,), jnp.int32)
            done = jnp.zeros((HBUF,), bool)
            maxp = jnp.full((HBUF,), 0 if left else -1, jnp.int32)
            args = (rp, qp, d_rl, d_ql, jnp.int32(tile), done, z, z, maxp)
            tail = (d_sub, 910, len(ref), len(query))
            kw = dict(pad=W_CONT, W=w, left=left)

            def xla():
                o = _extension_window_step_jit(*args, zc, zc, *tail,
                                               with_counts=False, **kw)
                return o["done"], o["cum"], o["maxv"], o["maxp"]

            def ker():
                return kernel(*args, *tail, **kw)

            a = [np.asarray(x) for x in xla()]
            b = [np.asarray(x) for x in ker()]
            for name, x, y in zip(("done", "cum", "maxv", "maxp"), a, b):
                if not np.array_equal(x, y):
                    bad = int(np.sum(x != y))
                    raise SystemExit(f"chip_smoke: kernel != XLA step in "
                                     f"{name} ({bad} rows)")
            init_maxp = 0 if left else -1
            for i in sample:
                want = window_step(ref, query, int(rl[i]), int(ql[i]), tile,
                                   w, left, 0, 0, init_maxp, sub, 910)
                got = (bool(a[0][i]), int(a[1][i]), int(a[2][i]),
                       int(a[3][i]))
                if got != want:
                    raise SystemExit(f"chip_smoke: XLA step != window "
                                     f"spec at row {i}: {got} != {want}")
            log(f"step {'left' if left else 'right'} W={w} tile={tile}: "
                f"kernel == XLA step on {HBUF} rows, XLA step == spec on "
                f"{SPEC_ROWS}; {int((~a[0]).sum())} rows alive after | "
                f"XLA step {median_time(xla) * 1e3:.3f} ms, kernel "
                f"{median_time(ker) * 1e3:.3f} ms")


def phase_chunk() -> None:
    from segalign_tpu.config import (build_substitution_matrix,
                                     make_seed_config)
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.oracle import reference as oracle
    from segalign_tpu.pipeline.device import DeviceAligner

    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, CHUNK_PAIR[0]).astype(np.uint8)
    query = rng.integers(0, 4, CHUNK_PAIR[1]).astype(np.uint8)
    for k in range(12):   # diverged homology, forward and reverse copies
        ln = int(rng.integers(1_000, 4_000))
        src = int(rng.integers(0, len(ref) - ln))
        dst = int(rng.integers(0, CHUNK - ln))
        core = ref[src:src + ln]
        if k % 2:
            core = revcomp_codes(core)
        mut = rng.random(ln) < 0.1
        query[dst:dst + ln] = np.where(mut, (core + 1) % 4, core)
    qrc = revcomp_codes(query)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    al = DeviceAligner(
        shape_pos=sc.shape_pos, seed_size=sc.size, transition=True, step=1,
        sub_mat=sub, xdrop=910, hspthresh=3000, noentropy=False,
        chunk_size=CHUNK)
    if al._native_seeder is None:
        raise SystemExit("chip_smoke: DeviceAligner has no native seeder")
    al.set_ref(ref)
    al.set_query(query, qrc)
    it, pt = oracle.generate_seed_pos_table(ref, 1, sc.shape_pos, sc.size,
                                            sc.kmer_size)
    for rev, q in ((False, query), (True, qrc)):
        t0 = time.time()
        got = al.seed_and_filter(0, CHUNK, rev=rev)
        t_dev = time.time() - t0
        seeds = oracle.extract_seed_offsets(q, 0, 0, CHUNK, sc.size,
                                            sc.shape_pos, True)
        want, want_nh = oracle.seed_and_filter(
            seeds, it.astype(np.int64), pt, ref, q, sc.size, sub, 910,
            3000, False, al.max_hits)
        want = np.array([h.astuple() for h in want],
                        np.int64).reshape(-1, 4)
        if got.num_hits != want_nh or not np.array_equal(got.hsps, want):
            raise SystemExit(f"chip_smoke: chunk rev={rev} differs from "
                             f"the oracle: hits {got.num_hits} vs "
                             f"{want_nh}, HSPs {len(got.hsps)} vs "
                             f"{len(want)}")
        if not len(want):
            raise SystemExit("chip_smoke: chunk produced no HSPs")
        log(f"chunk rev={rev}: {got.num_hits} hits, {len(want)} HSPs == "
            f"oracle (HBUF {al.HBUF}; device path {t_dev:.2f} s)")


def inproc() -> None:
    t0 = time.time()
    info = phase_device()
    for phase in (phase_step, phase_chunk):
        t = time.time()
        phase()
        log(f"{phase.__name__}: {time.time() - t:.1f} s")
    log(f"in-process phases: {time.time() - t0:.1f} s")
    log("device-info: " + json.dumps(info))


# -- CLI phases (parent) ------------------------------------------------------

FASTA_LUT = np.frombuffer(b"ACGTacgtN", np.uint8)


def to_text(codes: np.ndarray, rng) -> bytes:
    """Codes -> FASTA letters: soft-masked (4) becomes a random lower-case
    base, 5 becomes N."""
    idx = codes.astype(np.int64)
    masked = idx == 4
    idx[masked] = 4 + rng.integers(0, 4, int(masked.sum()))
    idx[codes == 5] = 8
    return FASTA_LUT[idx].tobytes()


def write_inputs(workdir: str, chroms, query_len: int) -> dict:
    from segalign_tpu.io.fasta import write_fasta
    total = sum(n for _, n in chroms)
    ref, query = repeat_pair(total, query_len, 2024)
    rng = np.random.default_rng(5)
    seqs, recs, pos = {}, [], 0
    for name, n in chroms:
        seqs[name] = to_text(ref[pos:pos + n], rng)
        recs.append((name, seqs[name]))
        pos += n
    paths = dict(target=os.path.join(workdir, "target.fa"),
                 query=os.path.join(workdir, "query.fa"))
    write_fasta(paths["target"], recs)
    seqs["query"] = to_text(query, rng)
    write_fasta(paths["query"], [("query", seqs["query"])])
    paths["seqs"] = seqs
    return paths


def run_cli(inputs: dict, out: str, extra=()):
    """Run the CLI; returns (wall seconds, its summary lines joined)."""
    cmd = [sys.executable, "-m", "segalign_tpu.cli.run_segalign",
           inputs["target"], inputs["query"], "--output", out,
           "--format", "maf-", "--gapped_mode", "native", "--debug",
           *extra]
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    r = subprocess.run(cmd, cwd=os.path.dirname(out), env=env,
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                       text=True)
    dt = time.time() - t0
    if r.returncode != 0:
        raise SystemExit(f"chip_smoke: CLI exit {r.returncode}:\n"
                         + r.stderr[-3000:])
    keys = ("Time elapsed", "#seed hits", "#HSPs")
    summary = "; ".join(ln.strip() for ln in r.stderr.splitlines()
                        if ln.startswith(keys))
    return dt, summary


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def revcomp_text(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGTacgt", b"TGCAtgca"))


def check_maf(path: str, seqs: dict) -> int:
    """Every block's rows match the input and its aligned text re-scores to
    the stated score (gap open 400, extend 30; case-insensitive matrix)."""
    from segalign_tpu.output.scoring import (default_gapped_matrix,
                                             encode_gapped)
    sub = default_gapped_matrix()
    rc = {}
    n = 0
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    for i, ln in enumerate(lines):
        if not ln.startswith("a "):
            continue
        score = int(ln.split("score=")[1])
        rows = [lines[i + 1].split(), lines[i + 2].split()]
        for s in rows:
            name, start, size, strand, src, text = (
                s[1], int(s[2]), int(s[3]), s[4], int(s[5]), s[6])
            seq = seqs[name]
            if src != len(seq):
                raise SystemExit(f"chip_smoke: MAF size of {name} is {src}")
            if strand == "-":
                seq = rc.setdefault(name, revcomp_text(seq))
            if text.replace("-", "").encode() != seq[start:start + size]:
                raise SystemExit(f"chip_smoke: MAF text of {name}:{start} "
                                 f"does not match the input")
        t1, t2 = rows[0][6].encode(), rows[1][6].encode()
        a, b = encode_gapped(t1), encode_gapped(t2)
        gap = (np.frombuffer(t1, np.uint8) == ord("-")) | \
              (np.frombuffer(t2, np.uint8) == ord("-"))
        opens = gap & ~np.concatenate([[False], gap[:-1]])
        got = int(sub[a[~gap], b[~gap]].sum()) - 30 * int(gap.sum()) \
            - 400 * int(opens.sum())
        if got != score:
            raise SystemExit(f"chip_smoke: MAF block re-scores to {got}, "
                             f"states {score}")
        n += 1
    if n == 0:
        raise SystemExit("chip_smoke: MAF has no blocks")
    return n


def phase_cli(workdir: str, inputs: dict) -> None:
    outs = []
    for label in ("cold", "warm"):
        out = os.path.join(workdir, f"{label}.maf")
        dt, summary = run_cli(inputs, out)
        outs.append(out)
        log(f"cli {label}: {dt:.1f} s wall, {os.path.getsize(out)} bytes, "
            f"sha256 {sha256(out)} | {summary}")
    if sha256(outs[0]) != sha256(outs[1]):
        raise SystemExit("chip_smoke: cold and warm MAF differ")
    n = check_maf(outs[0], inputs["seqs"])
    log(f"cli: {n} MAF blocks, every one re-scores to its stated score")


def phase_four(workdir: str, inputs: dict) -> None:
    digests = {}
    # the sharded run first: it is the one most likely to fail
    for label, extra in (("4 GPUs sharded table",
                          ("--num_gpu", "4", "--sharded_table")),
                         ("4 GPUs replicated", ("--num_gpu", "4")),
                         ("1 GPU", ("--num_gpu", "1"))):
        out = os.path.join(workdir, f"four_{len(digests)}.maf")
        dt, summary = run_cli(inputs, out, extra)
        digests[label] = sha256(out)
        log(f"{label}: {dt:.1f} s wall, {os.path.getsize(out)} bytes, "
            f"sha256 {digests[label]} | {summary}")
        if len(digests) == 1:
            log(f"{check_maf(out, inputs['seqs'])} MAF blocks re-score")
    if len(set(digests.values())) != 1:
        raise SystemExit("chip_smoke: multi-GPU outputs differ")
    log("1 GPU, 4 GPUs replicated and 4 GPUs sharded: byte-identical MAF")


def child_device_info() -> dict:
    code = ("import json, chip_smoke; "
            "print(json.dumps(chip_smoke.check_device()))")
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(r.stderr[-2000:] or "chip_smoke: no GPU")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU comparison")
    ap.add_argument("--inproc", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.inproc:
        inproc()
        return 0
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            info = child_device_info()
            log(f"nvidia-smi: {nvidia_smi()}")
            if info["count"] < 4:
                raise SystemExit(f"chip_smoke: --four needs 4 GPUs, JAX "
                                 f"sees {info['count']}")
            phase_four(workdir, write_inputs(workdir, TARGET_CHROMS,
                                             FOUR_QUERY_LEN))
        else:
            info = None
            with subprocess.Popen([sys.executable, __file__, "--inproc"],
                                  stdout=subprocess.PIPE, text=True) as p:
                for ln in p.stdout:
                    if ln.startswith("device-info: "):
                        info = json.loads(ln[len("device-info: "):])
                    else:
                        log(ln.rstrip("\n"))
            if p.returncode != 0 or info is None:
                return p.returncode or 1
            t = time.time()
            inputs = write_inputs(workdir, TARGET_CHROMS, QUERY_LEN)
            log(f"inputs written: {time.time() - t:.1f} s")
            phase_cli(workdir, inputs)
            log(f"nvidia-smi: {nvidia_smi()}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
