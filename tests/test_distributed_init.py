"""Real jax.distributed two-process test (CPU backend, localhost
coordinator).

Round-1 gap: the multihost test only exercised the partitioning logic with
env vars; maybe_initialize_distributed's jax.distributed.initialize path
was never executed. Here two actual processes rendezvous through
SEGALIGN_COORD, see each other's devices, and run a cross-process psum —
the collective plumbing multi-host runs ride on.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["SEGALIGN_REPO"])
    from segalign_tpu.parallel.distributed import (
        maybe_initialize_distributed, partition_intervals)
    host_id, num_hosts = maybe_initialize_distributed()
    assert num_hosts == 2
    import jax
    assert jax.process_count() == 2, jax.process_count()
    assert jax.process_index() == host_id
    # one device per process -> 2 global devices
    devs = jax.devices()
    assert len(devs) == 2, devs
    from jax.sharding import Mesh, PartitionSpec as P
    import jax.numpy as jnp
    mesh = Mesh(np.array(devs), ("hosts",))
    def body(x):
        return jax.lax.psum(x, "hosts")
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("hosts"),),
                              out_specs=P("hosts"), check_vma=False))
    import jax.experimental.multihost_utils as mhu
    x = np.full((2, 4), host_id + 1, np.int32)
    y = f(mhu.host_local_array_to_global_array(
        x[host_id:host_id + 1], mesh, P("hosts")))
    got = mhu.global_array_to_host_local_array(y, mesh, P("hosts"))
    np.testing.assert_array_equal(np.asarray(got), np.full((1, 4), 3))
    # interval partitioning is disjoint and complete across hosts
    ivs = list(range(11))
    mine = partition_intervals(ivs, host_id, num_hosts)
    assert mine == ivs[host_id::2]
    print(f"WORKER_OK {host_id}")
""")


def test_multihost_cli_flags(tmp_path):
    """Multi-host launch through the CLI surface (--num_hosts/--host_id):
    two CLI processes each align their interval slice; outputs are
    disjoint and their union equals the single-host run. v1 replicated
    mode needs no coordinator (parallel/distributed.py), so the
    processes run independently — the same one-command-per-host UX as
    the reference's driver."""
    import numpy as np
    from segalign_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(5)
    bases = "ACGT"
    core = "".join(bases[i] for i in rng.integers(0, 4, 400))
    t_chr = ("".join(bases[i] for i in rng.integers(0, 4, 300)) + core
             + "".join(bases[i] for i in rng.integers(0, 4, 800)) + core)
    q_chr = ("".join(bases[i] for i in rng.integers(0, 4, 150)) + core
             + "".join(bases[i] for i in rng.integers(0, 4, 1000)))
    ref_fa, query_fa = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    write_fasta(ref_fa, [("t", t_chr)])
    write_fasta(query_fa, [("q", q_chr)])

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SEGALIGN_DEVICES="cpu")
    env.pop("PYTHONPATH", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(outfile, extra):
        cmd = [sys.executable, "-m", "segalign_tpu.cli.run_segalign",
               ref_fa, query_fa, "--nogapped", "--hspthresh", "1500",
               "--noentropy", "--wga_chunk_size", "512",
               "--lastz_interval_size", "600", "--output", outfile] + extra
        r = subprocess.run(cmd, env=env, cwd=repo, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        if not os.path.exists(outfile):   # slice with no alignments
            return set()
        with open(outfile) as f:
            return set(ln for ln in f.read().splitlines() if ln)

    single = run(str(tmp_path / "single.segments"), [])
    parts = [run(str(tmp_path / f"host{h}.segments"),
                 ["--num_hosts", "2", "--host_id", str(h)])
             for h in (0, 1)]
    assert parts[0] & parts[1] == set(), "hosts overlapped on intervals"
    assert parts[0] | parts[1] == single
    assert single  # non-trivial


def test_two_process_distributed(tmp_path):
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
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=220)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, out, err))
    for hid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {hid} failed:\n{err[-2000:]}"
        assert f"WORKER_OK {hid}" in out
