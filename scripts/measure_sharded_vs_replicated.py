"""Sharded-table vs replicated-table cost on the virtual CPU mesh.

Device scaling needs real GPUs (chip_smoke.py --four); what IS
measurable on 8 virtual CPU devices (which share
one host's cores) is the sharded pipeline's fixed costs vs the
replicated path on identical input: compile time, per-chunk exec wall,
escalation count (must be ZERO with density-derived capacities),
and output parity. Run:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/measure_sharded_vs_replicated.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("SEGALIGN_DEVICES", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    from segalign_tpu.config import make_seed_config, \
        build_substitution_matrix
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.parallel.multi import MultiDeviceAligner, ChunkWork
    from segalign_tpu.parallel.sharded import ShardedAligner

    rng = np.random.default_rng(77)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench as B
    lib = B.make_repeat_library(rng)
    n = 600_000
    ref = B.synth_genome_repeats(rng, n, lib)
    query = B.synth_genome_repeats(rng, n, lib, homolog_from=ref)
    qrc = revcomp_codes(query)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size, transition=True,
              step=1, sub_mat=sub, xdrop=910, hspthresh=3000,
              noentropy=False, chunk_size=250_000)

    CHUNK = 250_000
    q_len = len(query) - sc.size
    work = [ChunkWork(cs, min(cs + CHUNK, q_len), rev)
            for cs in range(0, q_len, CHUNK) for rev in (False, True)]

    results = {}
    for name, mk in (("replicated", lambda: MultiDeviceAligner(**kw)),
                     ("sharded", lambda: ShardedAligner(**kw))):
        t0 = time.time()
        al = mk()
        al.set_ref(ref)
        al.set_query(query, qrc)
        setup = time.time() - t0
        t0 = time.time()
        out = al.map_chunks(list(work), depth=4)  # includes compiles
        cold = time.time() - t0
        t0 = time.time()
        out = al.map_chunks(list(work), depth=4)
        warm = time.time() - t0
        hsps = int(sum(len(r.hsps) for r in out))
        hits = int(sum(r.num_hits for r in out))
        caps = getattr(al, "_caps", None)
        results[name] = (out, hsps)
        print(f"{name}: setup={setup:.1f}s cold={cold:.1f}s warm={warm:.1f}s"
              f" hsps={hsps} hits={hits} caps={caps}", flush=True)

    a = np.concatenate([r.hsps for r in results["replicated"][0]]) \
        if results["replicated"][1] else np.zeros((0, 4))
    b = np.concatenate([r.hsps for r in results["sharded"][0]]) \
        if results["sharded"][1] else np.zeros((0, 4))
    same = a.shape == b.shape and np.array_equal(a, b)
    print(f"parity: {'identical' if same else 'MISMATCH'} "
          f"({len(a)} vs {len(b)} HSPs)", flush=True)


if __name__ == "__main__":
    main()
