"""v2 k-mer-sharded table composed with multi-process jax.distributed.

Here TWO processes x 4 CPU devices rendezvous through a localhost
coordinator and run the REAL sharded extender (seed routing all_to_all +
shard-local expansion/extension + all_gather) over the 8-device GLOBAL
mesh, then each process asserts parity against the replicated
single-device path computed locally. This is the launch shape a
table-exceeds-one-host deployment uses (SURVEY §2 "Phase 2 north star").

Launch procedure (documented for production in parallel/distributed.py):
  SEGALIGN_NUM_HOSTS=<N> SEGALIGN_HOST_ID=<i> SEGALIGN_COORD=<host:port>
  + ShardedAligner(devices=jax.devices()) after
  maybe_initialize_distributed().
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["SEGALIGN_REPO"])
    from segalign_tpu.parallel.distributed import \\
        maybe_initialize_distributed
    host_id, num_hosts = maybe_initialize_distributed()
    import jax
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, jax.devices()

    from segalign_tpu.config import make_seed_config, \\
        build_substitution_matrix
    from segalign_tpu.pipeline.device import DeviceAligner
    from segalign_tpu.parallel.sharded import ShardedAligner
    from segalign_tpu.parallel.multi import ChunkWork
    from segalign_tpu.io.encode import revcomp_codes

    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    rc_core = (3 - core)[::-1].copy()
    ref = np.concatenate([rng.integers(0, 4, 500), core,
                          rng.integers(0, 4, 400)]).astype(np.uint8)
    q = np.concatenate([rng.integers(0, 4, 250), core,
                        rng.integers(0, 4, 150), rc_core,
                        rng.integers(0, 4, 200)]).astype(np.uint8)
    qrc = revcomp_codes(q)
    sc = make_seed_config("12of19")
    sub = build_substitution_matrix(910)
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size, transition=True,
              step=1, sub_mat=sub, xdrop=910, hspthresh=1500,
              noentropy=True, chunk_size=512)

    sh = ShardedAligner(devices=jax.devices(), **kw)
    sh.set_ref(ref)
    sh.set_query(q, qrc)
    qlen = len(q) - sc.size
    work = []
    for cs in range(0, qlen, 512):
        work.append(ChunkWork(cs, min(cs + 512, qlen), False))
        work.append(ChunkWork(cs, min(cs + 512, qlen), True))
    res_sh = sh.map_chunks(work)

    rep = DeviceAligner(device=jax.local_devices()[0], **kw)
    rep.set_ref(ref)
    rep.set_query(q, qrc)
    res_rep = [rep.seed_and_filter(w.chunk_start, w.chunk_end, w.rev)
               for w in work]

    total = 0
    for a, b in zip(res_sh, res_rep):
        np.testing.assert_array_equal(a.hsps, b.hsps)
        assert a.num_hits == b.num_hits, (a.num_hits, b.num_hits)
        assert a.num_seeds == b.num_seeds
        total += len(a.hsps)
    assert total > 0, "no HSPs found: test would be vacuous"
    print(f"WORKER_OK {host_id} hsps={total}")
""")


def test_two_process_sharded_parity(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for hid in range(2):
        env = dict(
            os.environ,
            SEGALIGN_REPO=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            SEGALIGN_NUM_HOSTS="2",
            SEGALIGN_HOST_ID=str(hid),
            SEGALIGN_COORD=f"127.0.0.1:{port}",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
        assert "WORKER_OK" in out, (out, err)
