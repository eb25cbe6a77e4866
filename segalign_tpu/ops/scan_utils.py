"""Blocked scans and the dispatch wrapper.

Long 1-D scans in the pipeline use a blocked 2-D formulation: lane-axis
cumsums within rows plus a short second-level scan of row totals. (It was
introduced for a backend whose 1-D cumulative lowering degenerated on
large arrays; not re-measured on GPUs.)
"""

from __future__ import annotations

import jax.numpy as jnp


import os

# SEGALIGN_SYNC=1 (debugging): synchronize after every wrapped dispatch and
# retry once, with a cleared trace cache, on an INVALID_ARGUMENT /
# buffer-count dispatch error. Off by default: the sync defeats JAX's
# async dispatch.
_SYNC_RETRY = os.environ.get("SEGALIGN_SYNC", "") == "1"


def robust_call(fn, *args, **kw):
    """Dispatch a jitted function (see _SYNC_RETRY for the debug mode)."""
    if not _SYNC_RETRY:
        return fn(*args, **kw)
    import jax

    def run():
        out = fn(*args, **kw)
        # materialize so async execution errors surface inside the retry
        # scope
        jax.block_until_ready(out)
        return out

    try:
        return run()
    except Exception as e:
        msg = str(e)
        if "INVALID_ARGUMENT" not in msg and "buffers" not in msg:
            raise
        try:
            fn.clear_cache()
        except Exception:
            pass
        return run()


def sum1d(x, dtype=jnp.int32):
    """Reduce a long 1-D array without triggering the 1-D lowering cliff."""
    n = x.shape[0]
    if n <= 1 << 15:
        return jnp.sum(x, dtype=dtype)
    pad = (-n) % 512
    xp = jnp.pad(x.astype(dtype), (0, pad))
    return jnp.sum(xp.reshape(-1, 512), dtype=dtype)


def blocked_cumsum(x, block: int = 2048):
    """Inclusive 1-D cumsum via 2-D blocking. Exact for int dtypes."""
    n = x.shape[0]
    if n <= 1 << 15:
        return jnp.cumsum(x, dtype=x.dtype)
    m = -(-n // block)
    pad = m * block - n
    xp = jnp.pad(x, (0, pad))
    cs = jnp.cumsum(xp.reshape(m, block), axis=1, dtype=x.dtype)
    tot = cs[:, -1]
    if m > 1 << 15:
        off = blocked_cumsum(tot, block) - tot
    else:
        off = jnp.cumsum(tot, dtype=x.dtype) - tot
    return (cs + off[:, None]).reshape(-1)[:n]
