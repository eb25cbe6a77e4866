"""Worker for measure_scaling.measure_two_process: one of two
jax.distributed processes aligning its interval partition (the
parallel/distributed.py host-partition scheme). Prints per-stage timings
and, as the last line, its HSP count."""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SEGALIGN_DEVICES"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

proc_id = int(sys.argv[1])


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    jax.distributed.initialize(coordinator_address="localhost:12421",
                               num_processes=2, process_id=proc_id)
    t_init = time.time() - t0
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from scripts.measure_scaling import make_pair
    from segalign_tpu.config import (make_seed_config,
                                     build_substitution_matrix)
    from segalign_tpu.io.encode import revcomp_codes
    from segalign_tpu.pipeline.device import DeviceAligner
    from segalign_tpu.parallel.distributed import partition_intervals

    ref, query = make_pair()
    qrc = revcomp_codes(query)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    CHUNK = 32768
    al = DeviceAligner(
        shape_pos=sc.shape_pos, seed_size=sc.size,
        transition=sc.transition, step=1, sub_mat=sub, xdrop=910,
        hspthresh=3000, noentropy=False, chunk_size=CHUNK, HBUF=16384,
        B=2048, W=128,
        # under jax.distributed only THIS process's devices are
        # addressable; jax.devices() would return global ones
        device=jax.local_devices()[0])
    t0 = time.time()
    al.set_ref(ref)
    al.set_query(query, qrc)
    t_res = time.time() - t0

    class IV:
        def __init__(self, i):
            self.num_invoked = i

    ivs = [IV(i) for i in range((len(query) - sc.size) // CHUNK + 1)]
    mine = partition_intervals(ivs, proc_id, 2)
    t0 = time.time()
    n = 0
    for iv in mine:
        cs = iv.num_invoked * CHUNK
        ce = min(cs + CHUNK, len(query) - sc.size)
        if ce <= cs:
            continue
        for rev in (False, True):
            n += len(al.seed_and_filter(cs, ce, rev).hsps)
    t_align = time.time() - t0
    print(f"proc {proc_id}: init={t_init:.2f}s residency={t_res:.2f}s "
          f"align={t_align:.2f}s intervals={len(mine)}", file=sys.stderr)
    print(n)


if __name__ == "__main__":
    main()
