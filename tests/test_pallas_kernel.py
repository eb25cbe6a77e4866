"""The Triton window-step kernel (interpret mode here) against the XLA
step, the choice of step, and the extension program at sequence ends."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from segalign_tpu.config import build_substitution_matrix
from segalign_tpu.ops import extend3, window_kernel
from segalign_tpu.ops.extend import pad_sequence
from segalign_tpu.oracle.scan_spec import extend_hit_scan, window_step

SUB = build_substitution_matrix(910)
SUB_FLAT = jnp.asarray(SUB.reshape(-1).astype(np.int32))


def _pair(seed, n=6000, hom=(1000, 3000, 1500)):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    r0, q0, ln = hom
    core = rng.integers(0, 4, ln).astype(np.uint8)
    mut = rng.random(ln) < 0.08
    ref[r0:r0 + ln] = core
    query[q0:q0 + ln] = np.where(mut, (core + 1) % 4, core)
    ref[200:260] = 4        # soft-masked run
    query[n - 700] = 7      # separator wall
    return rng, ref, query


def _rows(rng, n, B, hom=(1000, 3000, 1500)):
    r0, q0, ln = hom
    rl = rng.integers(0, n, B).astype(np.int32)
    ql = rng.integers(0, n, B).astype(np.int32)
    k = B // 3
    off = rng.integers(0, ln, k)
    rl[:k] = r0 + off
    ql[:k] = q0 + off
    rl[k:k + 6] = [0, 1, n - 1, n - 5, 5, 100]
    ql[k:k + 6] = [3, 0, n - 2, 7, n - 1, 100]
    return rl, ql


def _xla_step(*args, **kw):
    B = args[2].shape[0]
    zc = jnp.zeros((B, 4), jnp.int32)
    o = extend3._extension_window_step_jit(*args[:9], zc, zc, *args[9:],
                                           with_counts=False, **kw)
    return o["done"], o["cum"], o["maxv"], o["maxp"]


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("W,tile", [(512, 0), (2048, 512)])
def test_window_kernel_interpret_matches_xla_step(left, W, tile):
    """Bit-identical done/cum/maxv/maxp at the first-window and
    continuation widths; 100 rows (not a multiple of the block height)
    exercise the wrapper's row padding, done rows its masking."""
    rng, ref, query = _pair(1)
    n = len(ref)
    B = 100
    rl, ql = _rows(rng, n, B)
    pad = 2048
    done = jnp.asarray(rng.random(B) < 0.1)
    if tile:
        cum = rng.integers(-50, 5000, B).astype(np.int32)
        maxv = (np.maximum(cum, 0) + rng.integers(0, 300, B)).astype(
            np.int32)
        maxp = rng.integers(0, tile, B).astype(np.int32)
    else:
        cum = maxv = np.zeros(B, np.int32)
        maxp = np.full(B, 0 if left else -1, np.int32)
    args = (jnp.asarray(pad_sequence(ref, pad)),
            jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
            jnp.asarray(ql), tile, done, jnp.asarray(cum),
            jnp.asarray(maxv), jnp.asarray(maxp), SUB_FLAT, 910, n, n)
    want = _xla_step(*args, pad=pad, W=W, left=left)
    got = window_kernel.window_step_kernel(*args, pad=pad, W=W, left=left,
                                           interpret=True)
    for name, a, b in zip(("done", "cum", "maxv", "maxp"), want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert (np.asarray(want[2]) > maxv).sum() > 10   # rows found new maxima


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_xla_step_matches_window_spec(left):
    """The XLA step against the NumPy window spec, row by row, from a
    carried state."""
    rng, ref, query = _pair(3, n=5000)
    n = len(ref)
    B = 150
    rl, ql = _rows(rng, n, B)
    pad, W, tile = 1024, 1024, 256
    cum = rng.integers(-100, 3000, B).astype(np.int32)
    maxv = (np.maximum(cum, 0) + rng.integers(0, 500, B)).astype(np.int32)
    maxp = rng.integers(0, tile + 1, B).astype(np.int32)
    got = _xla_step(jnp.asarray(pad_sequence(ref, pad)),
                    jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
                    jnp.asarray(ql), tile, jnp.zeros(B, bool),
                    jnp.asarray(cum), jnp.asarray(maxv), jnp.asarray(maxp),
                    SUB_FLAT, 910, n, n, pad=pad, W=W, left=left)
    got = [np.asarray(g) for g in got]
    for i in range(B):
        want = window_step(ref, query, int(rl[i]), int(ql[i]), tile, W,
                           left, int(cum[i]), int(maxv[i]), int(maxp[i]),
                           SUB, 910)
        assert (bool(got[0][i]), int(got[1][i]), int(got[2][i]),
                int(got[3][i])) == want, i


def _program_inputs(n=3000, B=256):
    rng, ref, query = _pair(5, n=n, hom=(500, 900, 1500))
    rl, ql = _rows(rng, n, B, hom=(500, 900, 1500))
    return ref, query, rl, ql


def test_cpu_program_lowers_the_xla_step():
    """The platform picks the step when the program is lowered: no Triton
    call in the CPU program, the kernel in the CUDA one."""
    from segalign_tpu.ops.extend_fused import extend_fields_program
    ref, query, rl, ql = _program_inputs()
    pad = 2048
    args = (jnp.asarray(pad_sequence(ref, pad)),
            jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
            jnp.asarray(ql), len(rl), SUB_FLAT, 910, 3000, len(ref),
            len(query))
    traced = extend_fields_program.trace(
        *args, pad=pad, W=512, CONT=128, W_CONT=2048, UNROLL=2)
    cpu = traced.lower().as_text()
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" not in cpu
    assert "triton" in cuda
    assert "xdrop_window_left" in cuda and "xdrop_window_right" in cuda


def test_no_config_reaches_interpret_mode(monkeypatch):
    """No option selects a kernel: the aligner has no engine knob, and
    the production program stages the kernel without interpret mode."""
    from segalign_tpu.config import Config, RMConfig, make_seed_config
    from segalign_tpu.pipeline.device import DeviceAligner
    for cls in (DeviceAligner, Config, RMConfig):
        params = inspect.signature(cls).parameters
        assert not {"use_pallas", "engine"} & set(params), cls
    seen = []
    real = window_kernel.window_step_kernel

    def spy(*a, **kw):
        seen.append(kw.get("interpret", False))
        return real(*a, **kw)

    monkeypatch.setattr(window_kernel, "window_step_kernel", spy)
    rng, ref, query = _pair(7, n=4000, hom=(500, 800, 1200))
    qrc = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)[query[::-1]]
    sc = make_seed_config("12of19")
    al = DeviceAligner(
        shape_pos=sc.shape_pos, seed_size=sc.size,
        transition=sc.transition, step=1, sub_mat=SUB, xdrop=910,
        hspthresh=1500, noentropy=False, chunk_size=2048,
        max_hits=10**9, HBUF=4096, B=256, W=128)
    al.set_ref(ref)
    al.set_query(query, qrc)
    assert al.seed_and_filter(0, 2048, False).num_hits > 0
    assert seen and not any(seen)


@pytest.mark.parametrize("left_end", [False, True], ids=["end", "start"])
def test_continuation_reaches_sequence_end_matches_oracle(left_end):
    """Homology running into a sequence end: continuation windows of
    W_CONT = 2048 read up to the pad (2048, the widest window) and the
    results equal the scan oracle hit by hit."""
    from segalign_tpu.ops.extend_fused import extend_fields_program
    rng = np.random.default_rng(11)
    n = 7000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    ln = 5000
    r0, q0 = (0, 0) if left_end else (n - ln, n - ln - 300)
    core = rng.integers(0, 4, ln).astype(np.uint8)
    ref[r0:r0 + ln] = core
    query[q0:q0 + ln] = np.where(rng.random(ln) < 0.05, (core + 1) % 4,
                                 core)
    B = 64
    off = rng.integers(0, ln, B).astype(np.int32)
    rl, ql = (r0 + off).astype(np.int32), (q0 + off).astype(np.int32)
    pad = 2048
    res = jax.device_get(extend_fields_program(
        jnp.asarray(pad_sequence(ref, pad)),
        jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
        jnp.asarray(ql), B, SUB_FLAT, 910, 3000, n, n,
        pad=pad, W=512, CONT=16, W_CONT=2048, UNROLL=2))
    for i in range(B):
        ok, rs, qs, ext, _ = extend_hit_scan(ref, query, int(rl[i]),
                                             int(ql[i]), SUB, 910, 3000,
                                             True)
        assert bool(res["candidate"][i]) == ok, i
        if ok:
            assert (int(res["rs"][i]), int(res["qs"][i]),
                    int(res["length"][i])) == (rs, qs, ext), i
    assert res["candidate"].all()
    # the extents do reach the sequence end
    ends = res["rs"] + res["length"] if not left_end else res["rs"]
    assert (ends == (n - 1 if not left_end else 0)).any()


def test_mixed_continuation_width_is_exact():
    """W_CONT != W continuation yields identical results (window-width
    independence of the scan; continuation phases use wider windows on
    the device to amortize loop overheads)."""
    from segalign_tpu.ops.extend_fused import extend_fields_program

    rng = np.random.default_rng(44)
    n = 16_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 6000).astype(np.uint8)
    ref[2000:8000] = core
    query[7000:13000] = core

    pad = 1024  # must cover W_CONT
    sub_flat = jnp.asarray(
        build_substitution_matrix(910).reshape(-1).astype(np.int32))
    ref_pad = jnp.asarray(pad_sequence(ref, pad))
    query_pad = jnp.asarray(pad_sequence(query, pad))

    B = 512
    rl = rng.integers(0, n, B).astype(np.int32)
    ql = rng.integers(0, n, B).astype(np.int32)
    d = B // 2
    off = rng.integers(50, 5900, d).astype(np.int32)
    rl[:d] = 2000 + off
    ql[:d] = 7000 + off

    outs = []
    # CONT=128 < B forces the phase-2/3 compaction path
    for (w, wc, unroll) in ((128, 0, 1), (128, 512, 4), (128, 1024, 2)):
        res = extend_fields_program(
            ref_pad, query_pad, jnp.asarray(rl), jnp.asarray(ql), B,
            sub_flat, 910, 1800, n, n, pad=pad, W=w, CONT=128, W_CONT=wc,
            UNROLL=unroll)
        outs.append(jax.device_get(res))
    base = outs[0]
    assert np.asarray(base["candidate"]).sum() > 0
    for other in outs[1:]:
        for k in ("candidate", "rs", "qs", "length", "total"):
            np.testing.assert_array_equal(np.asarray(base[k]),
                                          np.asarray(other[k]), err_msg=k)
