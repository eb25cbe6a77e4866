"""Property test: the literal tile-32 oracle is equivalent to the sequential
scan specification. This equivalence is what the device programs rely on."""

import numpy as np
import pytest

from segalign_tpu.config import build_substitution_matrix
from segalign_tpu.constants import E_NT
from segalign_tpu.oracle.reference import extend_hit_tile32
from segalign_tpu.oracle.scan_spec import extend_hit_scan

BASES = np.arange(4, dtype=np.uint8)


def random_seq(rng, n, p_mask=0.0, p_n=0.0):
    seq = rng.integers(0, 4, size=n).astype(np.uint8)
    if p_mask:
        seq = np.where(rng.random(n) < p_mask, 4, seq)  # L
    if p_n:
        seq = np.where(rng.random(n) < p_n, 5, seq)     # N
    return seq


def planted_pair(rng, n=2000, hom_len=600, identity=0.9):
    """ref/query with a planted homologous stretch."""
    ref = random_seq(rng, n)
    query = random_seq(rng, n)
    r0, q0 = n // 4, n // 3
    core = random_seq(rng, hom_len)
    ref[r0:r0 + hom_len] = core
    mut = rng.random(hom_len) >= identity
    q_core = np.where(mut, (core + rng.integers(1, 4, hom_len)) % 4, core)
    query[q0:q0 + hom_len] = q_core.astype(np.uint8)
    return ref, query, r0, q0, hom_len


@pytest.mark.parametrize("xdrop", [25, 250, 910, 3000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile32_equals_scan_random(xdrop, seed):
    rng = np.random.default_rng(seed)
    sub = build_substitution_matrix(xdrop)
    ref, query, r0, q0, hl = planted_pair(rng)
    for trial in range(120):
        # anchor points: mix of in-homology and random
        if trial % 2 == 0:
            d = int(rng.integers(0, hl))
            ref_loc, query_loc = r0 + d, q0 + d
        else:
            ref_loc = int(rng.integers(0, len(ref)))
            query_loc = int(rng.integers(0, len(query)))
        a = extend_hit_tile32(ref, query, ref_loc, query_loc, sub, xdrop,
                              3000, False)
        b = extend_hit_scan(ref, query, ref_loc, query_loc, sub, xdrop,
                            3000, False)
        assert a == b, (ref_loc, query_loc, xdrop, a, b)


def test_tile32_equals_scan_edges_and_walls():
    rng = np.random.default_rng(7)
    xdrop = 910
    sub = build_substitution_matrix(xdrop)
    # identical sequences -> edge-terminated extension, with '&' walls
    core = random_seq(rng, 500)
    seq = np.concatenate([core, [E_NT], core, [E_NT], core]).astype(np.uint8)
    ref = seq
    query = seq.copy()
    for loc in [0, 1, 31, 32, 33, 499, 500, 501, 600, len(seq) - 40,
                len(seq) - 2, len(seq) - 1]:
        a = extend_hit_tile32(ref, query, loc, loc, sub, xdrop, 3000, False)
        b = extend_hit_scan(ref, query, loc, loc, sub, xdrop, 3000, False)
        assert a == b, (loc, a, b)
    # asymmetric anchors near edges
    for _ in range(60):
        rl = int(rng.integers(0, len(ref)))
        ql = int(rng.integers(0, len(query)))
        a = extend_hit_tile32(ref, query, rl, ql, sub, xdrop, 3000, False)
        b = extend_hit_scan(ref, query, rl, ql, sub, xdrop, 3000, False)
        assert a == b


@pytest.mark.parametrize("noentropy", [False, True])
def test_entropy_path(noentropy):
    rng = np.random.default_rng(3)
    xdrop = 910
    sub = build_substitution_matrix(xdrop)
    # low-complexity: poly-A homology scoring inside the entropy band
    # [hspthresh, 3*hspthresh] => entropy = 0 => rejected unless noentropy
    n = 80  # total score 80*91 = 7280, within [3000, 9000]
    ref = np.zeros(n, dtype=np.uint8)
    query = np.zeros(n, dtype=np.uint8)
    ok_e, *_ = extend_hit_tile32(ref, query, 40, 40, sub, xdrop, 3000,
                                 noentropy)
    ok_s, *rest = extend_hit_scan(ref, query, 40, 40, sub, xdrop, 3000,
                                  noentropy)
    assert ok_e == ok_s
    # entropy=0 (single-base composition) should reject; noentropy accepts
    assert ok_e == noentropy

    # mixed-composition homology in the entropy score band
    ref2, query2, r0, q0, hl = planted_pair(rng, n=1500, hom_len=60,
                                            identity=1.0)
    a = extend_hit_tile32(ref2, query2, r0 + 10, q0 + 10, sub, xdrop, 3000,
                          noentropy)
    b = extend_hit_scan(ref2, query2, r0 + 10, q0 + 10, sub, xdrop, 3000,
                        noentropy)
    assert a == b


def test_immediate_drop_negative_right_extent():
    # A hit whose right extension drops at position 0 yields max_pos == -1,
    # making extent = left_pos - 1 (reference quirk).
    xdrop = 25
    sub = build_substitution_matrix(xdrop)
    n = 200
    ref = np.zeros(n, dtype=np.uint8)
    query = np.zeros(n, dtype=np.uint8)
    # mismatches at/after the anchor on the right
    query[100:] = 1
    query[99] = 0
    a = extend_hit_tile32(ref, query, 100, 100, sub, xdrop, 100, True)
    b = extend_hit_scan(ref, query, 100, 100, sub, xdrop, 100, True)
    assert a == b
