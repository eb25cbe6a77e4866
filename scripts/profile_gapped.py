"""Profile the native ydrop gapped DP: wall time and band behaviour vs
alignment length.

Synthesizes anchored homologies of controlled length/identity (plus the
divergent flanks that make ydrop terminate), runs gapped_extend_native
per anchor, and prints time, extension length, and cells/s. Run before
and after DP optimizations to document the speedup.

Usage: python scripts/profile_gapped.py [lengths...]
"""

import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

from segalign_tpu.config import build_substitution_matrix  # noqa: E402
from segalign_tpu.native import gapped_extend_native  # noqa: E402


def make_case(rng, ln, identity=0.85, flank=5000):
    """ref/query with a planted homology of length ln between random
    flanks; anchor at the middle of the homology."""
    core = rng.integers(0, 4, ln).astype(np.uint8)
    mut = rng.random(ln) >= identity
    core_q = np.where(mut, (core + rng.integers(1, 4, ln)) % 4, core)
    ref = np.concatenate([rng.integers(0, 4, flank), core,
                          rng.integers(0, 4, flank)]).astype(np.uint8)
    q = np.concatenate([rng.integers(0, 4, flank), core_q,
                        rng.integers(0, 4, flank)]).astype(np.uint8)
    return ref, q, flank + ln // 2, flank + ln // 2


def main():
    lengths = [int(a) for a in sys.argv[1:]] or \
        [1_000, 3_000, 10_000, 30_000, 100_000]
    sub = build_substitution_matrix(910)
    rng = np.random.default_rng(11)
    gap_open, gap_extend, ydrop = 400, 30, 9430
    reps = 5
    print(f"{'len':>8} {'ms/ext':>9} {'ext_len':>9} {'ops':>9} "
          f"{'Mcell/s*':>9}  (*assumes ~600-wide band)")
    for ln in lengths:
        cases = [make_case(rng, ln) for _ in range(reps)]
        t0 = time.time()
        outs = [gapped_extend_native(r, q, sub, gap_open, gap_extend,
                                     ydrop, ar, aq)
                for r, q, ar, aq in cases]
        dt = (time.time() - t0) / reps
        ext = np.mean([o[3] - o[1] for o in outs])
        nops = np.mean([len(o[5]) for o in outs])
        cells = ext * 600  # nominal band estimate for a rate yardstick
        print(f"{ln:>8} {dt*1e3:>9.2f} {ext:>9.0f} {nops:>9.0f} "
              f"{cells/dt/1e6:>9.1f}")


if __name__ == "__main__":
    main()
