"""Measure what can be measured on scaling without multi-chip hardware.

(a) MultiDeviceAligner on 1/2/4/8 virtual CPU devices: fixed chunk
    workload, wall time + efficiency vs 1 device. This measures the
    queue/dispatch machinery (the analog of the reference's GPU checkout
    pool, /root/reference/src/seed_filter.cu:700-706); CPU devices share
    host cores, so compute itself does NOT scale — the interesting number
    is how much the work-queue + per-device residency machinery costs.
(b) Two-process jax.distributed run: per-host interval partition
    (parallel/distributed.py), wall-clock split and merge cost.

Usage: python scripts/measure_scaling.py
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["SEGALIGN_DEVICES"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def make_pair(n=400_000, seed=5):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    total = 0
    while total < n // 10:
        ln = int(rng.integers(2000, 20000))
        src = int(rng.integers(0, n - ln))
        dst = int(rng.integers(0, n - ln))
        core = ref[src:src + ln]
        mut = rng.random(ln) >= 0.85
        query[dst:dst + ln] = np.where(
            mut, (core + rng.integers(1, 4, ln)) % 4, core)
        total += ln
    return ref, query


def measure_multidevice():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from segalign_tpu.config import (make_seed_config,
                                     build_substitution_matrix)
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.parallel.multi import MultiDeviceAligner, ChunkWork
    ref, query = make_pair()
    qrc = revcomp_codes(query)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    CHUNK = 32768
    work = []
    for cs in range(0, len(query) - sc.size, CHUNK):
        ce = min(cs + CHUNK, len(query) - sc.size)
        work.append(ChunkWork(cs, ce, False))
        work.append(ChunkWork(cs, ce, True))

    rows = []
    base = None
    want = None
    for nd in (1, 2, 4, 8):
        al = MultiDeviceAligner(
            num_devices=nd, shape_pos=sc.shape_pos, seed_size=sc.size,
            transition=sc.transition, step=1, sub_mat=sub, xdrop=910,
            hspthresh=3000, noentropy=False, chunk_size=CHUNK,
            HBUF=16384, B=2048, W=128)
        al.set_ref(ref)
        al.set_query(query, qrc)
        al.map_chunks(work[:2 * nd])          # warm per-device compiles
        t0 = time.time()
        res = al.map_chunks(work)
        dt = time.time() - t0
        hsps = np.concatenate([r.hsps for r in res if len(r.hsps)])
        hsps = hsps[np.lexsort(hsps.T[::-1])]
        if want is None:
            want = hsps
        assert np.array_equal(hsps, want), f"nd={nd} output mismatch"
        if base is None:
            base = dt
        rows.append((nd, dt, base / dt, base / dt / nd))
        print(f"devices={nd}: {dt:.2f}s speedup={base/dt:.2f} "
              f"efficiency={base/dt/nd:.2f}", flush=True)
    return rows


def measure_two_process():
    """Union-of-two-hosts vs single run: wall clock of each half + the
    host-side merge, via subprocesses with jax.distributed (the
    coordinator handshake is the measured overhead; compute does not
    speed up on one shared CPU)."""
    import subprocess
    script = os.path.join(os.path.dirname(__file__),
                          "_scaling_worker.py")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, script, str(i)],
        stdout=subprocess.PIPE, text=True, env=os.environ)
        for i in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    wall = time.time() - t0
    for p in procs:
        assert p.returncode == 0
    hsp_counts = [int(o.strip().splitlines()[-1]) for o in outs]
    print(f"two-process distributed: wall={wall:.2f}s "
          f"per-host hsps={hsp_counts}", flush=True)
    return wall, hsp_counts


if __name__ == "__main__":
    print("== MultiDeviceAligner on virtual CPU devices ==")
    measure_multidevice()
    if os.path.exists(os.path.join(os.path.dirname(__file__),
                                   "_scaling_worker.py")):
        print("== two-process jax.distributed ==")
        measure_two_process()
