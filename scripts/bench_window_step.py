"""Time the x-drop window step on one GPU at bench shapes; print JSON.

Rows are real seed hits of bench.py's repeat-structured pair: HBUF hits
sampled uniformly, in stream order, from the native seeder's hits of the
first 250 kb query chunk (forward strand). Compared:

  xla     ops/extend3._extension_window_step_jit (the plain reference)
  kernel  ops/window_kernel.window_step_kernel (Triton)

at HBUF = 2^17 rows for the first window (W = 512, tile 0) and the
continuation (W_CONT = 2048, tile 512, every row alive), both directions,
and at the continuation cohort size (CONT = 16384 rows); a sweep of the
kernel's block shape; then the whole extend_fields_program at HBUF rows
with the kernel and with the XLA step. Every kernel result is compared
with the XLA step (bit-identical state).

Each variant reports the median host time of --reps calls ending in
block_until_ready, and its device time: the summed durations of the
device events in a profiler trace of 5 calls, divided by 5.

Usage: python scripts/bench_window_step.py [--reps 20] [--trace DIR]
(DIR holds the traces; default: a temporary directory)
"""

import argparse
import functools
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBUF = 1 << 17
W, W_CONT, CONT, PAD = 512, 2048, 16384, 2048
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def real_hits(ref_mbp=8.0, query_mbp=4.0):
    import bench
    from segalign_tpu.config import make_seed_config
    from segalign_tpu.index.seed_table import build_seed_table
    from segalign_tpu.native import ChunkSeeder
    rng = np.random.default_rng(2024)
    lib = bench.make_repeat_library(rng)
    ref = bench.synth_genome_repeats(rng, int(ref_mbp * 1e6), lib)
    query = bench.synth_genome_repeats(rng, int(query_mbp * 1e6), lib,
                                       homolog_from=ref)
    sc = make_seed_config("12of19")
    it, pt = build_seed_table(ref, 1, sc.shape_pos, sc.size, sc.kmer_size)
    seeder = ChunkSeeder(bench.CHUNK, sc.kmer_size, True)
    rl, ql, *_ = seeder.seed(query, 0, bench.CHUNK, it, pt, sc.shape_pos,
                             sc.size, 1 << 30)
    assert len(rl) >= HBUF, len(rl)
    pick = np.sort(rng.choice(len(rl), HBUF, replace=False))
    return ref, query, rl[pick], ql[pick]


def timed(fn, reps, trace_dir):
    """(median host seconds, device seconds per call from a trace)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    with jax.profiler.trace(trace_dir):
        for _ in range(5):
            jax.block_until_ready(fn())
    dev = sum(device_kernel_ns(trace_dir).values()) / 5 / 1e9
    return float(np.median(ts)), dev


def device_kernel_ns(trace_dir):
    """Sum of device event durations per event name in the newest trace."""
    import jax
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out[ev.name] = out.get(ev.name, 0) + ev.duration_ns
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from segalign_tpu.config import build_substitution_matrix
    from segalign_tpu.ops import extend3, extend_fused, window_kernel
    from segalign_tpu.ops.extend import pad_sequence

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device: {dev.platform} {dev.device_kind} | {smi.strip()}",
          file=sys.stderr)
    ref, query, rl, ql = real_hits()
    rp = jnp.asarray(pad_sequence(ref, PAD))
    qp = jnp.asarray(pad_sequence(query, PAD))
    sub = jnp.asarray(build_substitution_matrix(910).reshape(-1), jnp.int32)
    n_r, n_q = len(ref), len(query)
    res = dict(device=dev.device_kind, power=smi.strip(), rows=HBUF)

    def state(B, init_maxp):
        z = jnp.zeros((B,), jnp.int32)
        return dict(done=jnp.zeros((B,), bool), cum=z, maxv=z,
                    maxp=jnp.full((B,), init_maxp, jnp.int32))

    zc = jnp.zeros((HBUF, 4), jnp.int32)
    steps = {
        "xla": lambda *a, **k: extend3._extension_window_step_jit(
            *a[:9], zc[:a[2].shape[0]], zc[:a[2].shape[0]], *a[9:],
            with_counts=False, **k),
        "kernel": jax.jit(window_kernel.window_step_kernel,
                          static_argnames=("pad", "W", "left",
                                           "interpret")),
    }
    keys = ("done", "cum", "maxv", "maxp")

    def as_tuple(o):
        return tuple(o[k] for k in keys) if isinstance(o, dict) else o

    import tempfile
    tdir = args.trace or tempfile.mkdtemp()
    ntrace = [0]

    def measure(key, call):
        ntrace[0] += 1
        host, devs = timed(call, args.reps,
                           os.path.join(tdir, f"t{ntrace[0]}"))
        res[f"{key}_s"] = host
        res[f"{key}_dev_s"] = devs
        print(f"{key}: host {host * 1e3:.3f} ms, device {devs * 1e3:.3f} ms",
              file=sys.stderr, flush=True)

    d_rl, d_ql = jnp.asarray(rl), jnp.asarray(ql)
    cohort = np.sort(np.random.default_rng(1).choice(HBUF, CONT, False))
    shapes = (("first", W, 0, d_rl, d_ql),
              ("cont", W_CONT, W, d_rl, d_ql),
              ("cohort", W_CONT, W, d_rl[cohort], d_ql[cohort]))
    for left in (False, True):
        side = "left" if left else "right"
        for tag, w, tile, lr, lq in shapes:
            # fresh state: every row alive at `tile`
            st = state(lr.shape[0], 0 if left else -1)
            outs = {}
            for name, fn in steps.items():
                call = lambda fn=fn: as_tuple(fn(
                    rp, qp, lr, lq, jnp.int32(tile), st["done"], st["cum"],
                    st["maxv"], st["maxp"], sub, 910, n_r, n_q, pad=PAD,
                    W=w, left=left))
                outs[name] = call()
                measure(f"{tag}_{side}_{name}", call)
            for k, a, b in zip(keys, outs["xla"], outs["kernel"]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), \
                    (tag, side, k)
            if tag == "first":
                res[f"first_{side}_survivors"] = int(
                    (~np.asarray(outs["xla"][0])).sum())
    # bytes the kernel must move: 2 sequence bytes per lane plus 4 int32
    # state words in and out per row
    for tag, w, _, lr, _ in shapes:
        nbytes = lr.shape[0] * (2 * w + 32)
        res[f"{tag}_kernel_hbm_share"] = (
            nbytes / res[f"{tag}_right_kernel_dev_s"] / HBM_BYTES_PER_S)

    # block-shape sweep (rows, lanes, warps) at the first and cont shapes
    for br, tw, nw in ((16, 128, 4), (64, 64, 8), (32, 128, 8),
                       (128, 32, 4), (8, 256, 4), (64, 32, 4)):
        fn = jax.jit(functools.partial(
            window_kernel.window_step_kernel, block_rows=br, tile_lanes=tw,
            num_warps=nw), static_argnames=("pad", "W", "left"))
        for tag, w, tile, lr, lq in shapes[:2]:
            st = state(HBUF, -1)
            call = lambda fn=fn: fn(
                rp, qp, lr, lq, jnp.int32(tile), st["done"], st["cum"],
                st["maxv"], st["maxp"], sub, 910, n_r, n_q, pad=PAD, W=w,
                left=False)
            measure(f"sweep_{tag}_{br}x{tw}w{nw}", call)

    # whole program: kernel vs XLA step. Each variant traces a new
    # function object, so JAX's trace cache cannot hand back the other's.
    kernel_fn = window_kernel.window_step_kernel

    def xla_as_kernel(seq_r, seq_q, loc_r, loc_q, tile, done, cum, maxv,
                      maxp, sub_flat, xdrop, ref_len, query_len, *, pad, W,
                      left, interpret=False):
        z = jnp.zeros((loc_r.shape[0], 4), jnp.int32)
        o = extend3._extension_window_step_jit.__wrapped__(
            seq_r, seq_q, loc_r, loc_q, tile, done, cum, maxv, maxp, z, z,
            sub_flat, xdrop, ref_len, query_len, pad=pad, W=W, left=left,
            with_counts=False)
        return o["done"], o["cum"], o["maxv"], o["maxp"]

    prog_out = {}
    for name, impl in (("kernel", kernel_fn), ("xla", xla_as_kernel),
                       ("xla2", xla_as_kernel), ("kernel2", kernel_fn)):
        window_kernel.window_step_kernel = impl

        def program(*a, **k):
            return extend_fused.extend_fields_program.__wrapped__(*a, **k)

        prog = jax.jit(program, static_argnames=(
            "pad", "W", "CONT", "W_CONT", "UNROLL"))
        call = lambda prog=prog: prog(
            rp, qp, d_rl, d_ql, HBUF, sub, 910, 3000, n_r, n_q, pad=PAD,
            W=W, CONT=CONT, W_CONT=W_CONT, UNROLL=2)
        prog_out[name] = jax.device_get(call())
        measure(f"program_{name}", call)
    window_kernel.window_step_kernel = kernel_fn
    for k in prog_out["xla"]:
        assert np.array_equal(prog_out["xla"][k], prog_out["kernel"][k]), k
    res["program_candidates"] = int(prog_out["xla"]["candidate"].sum())
    print(json.dumps(res))


if __name__ == "__main__":
    main()
