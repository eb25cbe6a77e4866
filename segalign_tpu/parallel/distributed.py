"""Multi-host distribution.

The reference is single-host (SURVEY section 2: no NCCL/MPI; multi-GPU =
replicate inputs + dynamic checkout). This scale-out keeps that
data flow and adds a host dimension:

  v1 (implemented here): every host holds the full reference block + seed
  table (replicated, exactly like the reference's per-GPU replication) and
  aligns a disjoint SLICE of the query intervals. Host-local tmp files are
  merged afterwards with the same sort -V contract — the reference's own
  output-merge step, applied across hosts. No inter-host communication is
  needed during alignment, so scaling is embarrassingly parallel (the
  north-star >= 80% 2-host efficiency is limited only by interval-count
  imbalance).

  v2 (implemented, parallel/sharded.py): for reference blocks whose seed
  table exceeds one chip's HBM, shard pos_table by k-mer range across
  chips; route each query chunk's seeds with an all_to_all over ICI keyed
  on kmer >> (2*kmer_size - log2(n_shards)); extend hits locally against
  the replicated sequence; all_gather candidate HSPs. The window-step
  kernel is unchanged — only hit expansion becomes distributed.

Launch: run the same CLI on every host with
  SEGALIGN_NUM_HOSTS=N SEGALIGN_HOST_ID=i [SEGALIGN_COORD=ip:port]
(jax.distributed needs the coordinator, process count and id).

v1 + v2 compose: after maybe_initialize_distributed(), a
ShardedAligner(devices=jax.devices()) builds its mesh over the GLOBAL
device list, so the k-mer shards span processes and the all_to_all rides
whatever links connect them (NVLink within a host, the network across).
Because every collective input is either fully replicated (sequence
blocks, scalars) or shard-sharded by the mesh, the same script runs
unmodified at any process count; tests/test_distributed_sharded.py
executes exactly this shape (2 processes x 4 CPU devices, byte parity
vs the replicated path).
"""

from __future__ import annotations

import os
from typing import List


def maybe_initialize_distributed() -> tuple[int, int]:
    """Initialize jax.distributed from SEGALIGN_* / cluster env; returns
    (host_id, num_hosts). Single-process fallback: (0, 1)."""
    num_hosts = int(os.environ.get("SEGALIGN_NUM_HOSTS", "1"))
    host_id = int(os.environ.get("SEGALIGN_HOST_ID", "0"))
    coord = os.environ.get("SEGALIGN_COORD", "")
    if num_hosts > 1 and coord:
        import jax
        jax.distributed.initialize(
            coordinator_address=coord, num_processes=num_hosts,
            process_id=host_id)
    return host_id, num_hosts


def partition_intervals(intervals: List, host_id: int, num_hosts: int):
    """Deterministic round-robin slice of the interval work list.

    Round-robin (not contiguous blocks) spreads dense regions across hosts,
    the law-of-large-numbers balancing the reference gets from its dynamic
    GPU checkout (src/seed_filter.cu:700-706)."""
    if num_hosts <= 1:
        return intervals
    return [iv for i, iv in enumerate(intervals) if i % num_hosts == host_id]
