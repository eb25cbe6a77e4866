"""Multi-device work distribution.

Replacement for the reference's multi-GPU checkout pool
(/root/reference/common/seed_filter_interface.cu:6-9 + the mutex/cv checkout
in src/seed_filter.cu:700-706): every device holds a replicated copy of the
current reference block + seed table and of the query block; wga chunks are
the unit of work, pulled from a shared queue by one host thread per device
(JAX releases the GIL during device execution, so threads overlap compute,
transfers, and host-side dedup).

The seed table is built ONCE on host and replicated — the same
replicate-tables / partition-queries scheme as the reference. A k-mer-range
sharded table with all_to_all seed routing is the planned scale-out mode for
tables that exceed one chip's HBM (see SURVEY.md section 2).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import numpy as np

from ..index.seed_table import build_seed_table
from ..pipeline.device import DeviceAligner, ChunkResult, COMPILE_LOCK

# One process-wide lock serializing first-compilations across device worker
# threads (see MultiDeviceAligner.map_chunks). Shared with the pipeline's
# finish-side lazy compiles (escalated recompact) so finisher threads and
# dispatch threads never cold-compile concurrently.
_COMPILE_LOCK = COMPILE_LOCK


@dataclass
class ChunkWork:
    chunk_start: int
    chunk_end: int
    rev: bool
    window: Optional[Tuple[int, int]] = None


class MultiDeviceAligner:
    """Farm chunks over N devices with replicated block state."""

    def __init__(self, *, num_devices: int = -1, devices=None, **kw):
        if devices is None:
            import os
            platform = os.environ.get("SEGALIGN_DEVICES") or None
            # addressable devices only: under jax.distributed the global
            # list includes other hosts' devices, which this process
            # cannot device_put to (each host runs its own worker pool
            # over its own chips; cross-host work splits by interval,
            # parallel/distributed.py).
            pidx = jax.process_index()
            devices = [d for d in jax.devices(platform)
                       if d.process_index == pidx]
            if num_devices > 0:
                devices = devices[:num_devices]
        self.devices = devices
        self.aligners = [DeviceAligner(device=d, **kw) for d in devices]
        a0 = self.aligners[0]
        self._table_args = (a0.step, a0.shape_pos, a0.seed_size, a0.kmer_size)

    @property
    def num_devices(self) -> int:
        return len(self.aligners)

    def set_ref(self, ref_codes: np.ndarray):
        step, shape_pos, seed_size, kmer_size = self._table_args
        tables = build_seed_table(ref_codes, step, shape_pos, seed_size,
                                  kmer_size)
        for a in self.aligners:
            a.set_ref(ref_codes, tables=tables)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        for a in self.aligners:
            a.set_query(fw_codes, rc_codes)

    def map_chunks(self, work: List[ChunkWork],
                   depth: int = 4) -> List[ChunkResult]:
        """Process chunks across all devices; results in input order.

        Each device worker keeps up to `depth` chunks in flight (async
        dispatch pipelining, see DeviceAligner.map_chunks). A worker that
        fails requeues its in-flight chunks so surviving devices (or a
        final sequential pass) complete them — the retry the reference
        lacks (a failed SeedAndFilter is fatal there,
        common/cuda_utils.h:4-37)."""
        if len(self.aligners) == 1:
            return self.aligners[0].map_chunks(work, depth=depth)

        q: "queue.Queue[tuple[int, ChunkWork]]" = queue.Queue()
        for i, w in enumerate(work):
            q.put((i, w))
        results: List[Optional[ChunkResult]] = [None] * len(work)
        errors: List[BaseException] = []
        dead: set = set()

        import os
        from concurrent.futures import ThreadPoolExecutor
        overlap = os.environ.get("SEGALIGN_OVERLAP", "") != "0"

        def worker(ai: int, aligner: DeviceAligner):
            pend: List[tuple] = []  # (i, w, PendingChunk)
            futs: List[tuple] = []  # (i, w, Future) finishes in flight
            pipelined = aligner._native_seeder is not None
            cur: Optional[tuple] = None  # (i, w) being dispatched right now
            first = True
            ex = (ThreadPoolExecutor(1) if pipelined and overlap else None)

            def drain_one():
                # A failing finisher future must not lose its work item:
                # requeue it for surviving workers BEFORE propagating (the
                # outer handler requeues the rest; without this the popped
                # item only resurfaced in the end-of-run straggler pass,
                # serialized on one device).
                jj, wjj, f = futs.pop(0)
                try:
                    results[jj] = f.result()
                except BaseException:
                    if results[jj] is None:
                        q.put((jj, wjj))
                    raise

            def finish(j, wj, pd):
                # overlap mode: the finisher thread's blocking candidate
                # fetches + numpy finalize/dedup run concurrently with this
                # thread's native seeding/planning of the next chunk (the
                # same dispatch/finish split as DeviceAligner.map_chunks)
                if ex is None:
                    results[j] = aligner.finish_chunk(pd)
                    return
                futs.append((j, wj, ex.submit(aligner.finish_chunk, pd)))
                while len(futs) > depth + 2:
                    drain_one()

            try:
                while True:
                    try:
                        cur = q.get_nowait()
                    except queue.Empty:
                        cur = None
                        break
                    i, w = cur
                    if pipelined:
                        # Serialize each worker's FIRST chunk end-to-end:
                        # concurrent first-compiles from N threads crashed
                        # XLA's compiler in an earlier environment (not
                        # re-checked on GPUs); after the warmup every
                        # executable is cached and the threads run free.
                        if first:
                            with _COMPILE_LOCK:
                                results[i] = aligner.seed_and_filter(
                                    w.chunk_start, w.chunk_end, w.rev,
                                    window=w.window)
                            first = False
                            cur = None
                            continue
                        pend.append((i, w, aligner.dispatch_chunk(
                            w.chunk_start, w.chunk_end, w.rev,
                            window=w.window)))
                        cur = None
                        if len(pend) > depth:
                            finish(*pend.pop(0))
                    else:
                        results[i] = aligner.seed_and_filter(
                            w.chunk_start, w.chunk_end, w.rev,
                            window=w.window)
                        cur = None
                while pend:
                    finish(*pend.pop(0))
                while futs:
                    drain_one()
            except BaseException as e:
                errors.append(e)
                dead.add(ai)
                # requeue everything this worker had in flight; completed
                # finisher futures keep their results
                for j, wj, f in futs:
                    if f.done() and f.exception() is None:
                        results[j] = f.result()
                    elif results[j] is None:
                        q.put((j, wj))
                for j, wj, _ in pend:
                    if results[j] is None:
                        q.put((j, wj))
                if cur is not None and results[cur[0]] is None:
                    q.put(cur)
            finally:
                if ex is not None:
                    ex.shutdown(wait=True)

        threads = [threading.Thread(target=worker, args=(ai, a))
                   for ai, a in enumerate(self.aligners)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        missing = [k for k, r in enumerate(results) if r is None]
        if missing:
            # workers may have exited before the requeue landed; finish the
            # stragglers on a surviving device (or raise if none survive)
            alive = [a for ai, a in enumerate(self.aligners)
                     if ai not in dead]
            if not alive:
                raise errors[0]
            import sys
            print(f"segalign_tpu: retrying {len(missing)} chunk(s) after "
                  f"device failure", file=sys.stderr)
            by_idx = {}
            while True:
                try:
                    i, w = q.get_nowait()
                except queue.Empty:
                    break
                by_idx[i] = w
            for k in missing:
                w = by_idx.get(k) or work[k]
                results[k] = alive[0].seed_and_filter(
                    w.chunk_start, w.chunk_end, w.rev, window=w.window)
        return results  # type: ignore[return-value]
