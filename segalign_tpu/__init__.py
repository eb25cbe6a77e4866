"""segalign_tpu: whole-genome aligner in JAX (SegAlign capabilities).

JAX's persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is set,
JAX uses that directory and nothing is set here. Otherwise the cache lives
in .jax_cache at the root of the checkout, a fixed path, so every process
run from the same checkout finds what an earlier one compiled. CPU-only
processes (the tests) keep no persistent cache.
"""

import os


def _setup_malloc_reuse():
    """Keep freed pages in the process (glibc mallopt).

    On lazily-restored VMs (and some cloud sandboxes) first-touch page
    faults are served by a userspace handler at single-digit MB/s. glibc's
    default policy mmap()s large allocations and returns them to the OS on
    free, so every large numpy array re-pays that fault cost. Forcing all
    allocations onto the heap (M_MMAP_MAX=0) and disabling trim makes the
    cost once-per-process. Measured here: repeated 128 MB cumsum 24-56 s
    -> 0.2 s. Opt out with SEGALIGN_MALLOC_REUSE=0.
    """
    if os.environ.get("SEGALIGN_MALLOC_REUSE", "1") != "1":
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-4, 0)          # M_MMAP_MAX = 0
        libc.mallopt(-1, 2**31 - 1)  # M_TRIM_THRESHOLD = never
    except Exception:  # pragma: no cover - non-glibc platforms
        pass


def _cache_dir(environ) -> str | None:
    """The compile-cache directory to set in code, or None to set none."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    plats = environ.get("JAX_PLATFORMS", "")
    if plats and all(p.strip() == "cpu"
                     for p in plats.split(",") if p.strip()):
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def _setup_jax_cache():
    cache = _cache_dir(os.environ)
    if cache is None:
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", cache)


_setup_malloc_reuse()
_setup_jax_cache()
