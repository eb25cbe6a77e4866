"""Set-up around the device: where the compile cache goes, how the native
library is keyed, and chip_smoke's refusal of a process without a GPU."""

import os
import shutil
import sys

import pytest

import segalign_tpu
from segalign_tpu import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_CHECKOUT = os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("environ,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere", "JAX_PLATFORMS": "cuda"},
     None),
    ({}, IN_CHECKOUT),
    ({"JAX_PLATFORMS": "cuda"}, IN_CHECKOUT),
    ({"JAX_PLATFORMS": "cpu"}, None),
], ids=["env-set", "env-set-gpu", "unset", "unset-gpu", "cpu-only"])
def test_compile_cache_placement(environ, want):
    """The variable wins and nothing is set in code; otherwise one fixed
    directory in the checkout; CPU-only processes keep none."""
    assert segalign_tpu._cache_dir(environ) == want


def test_native_library_built_from_tree_sources():
    lib = native.get_lib()
    assert lib is not None
    assert lib._name == native.lib_path()
    assert os.path.dirname(lib._name) == os.path.join(
        REPO, "segalign_tpu", "native", "build")


def test_native_key_follows_source_content(tmp_path, monkeypatch):
    srcs = []
    for src in native._SRCS:
        dst = tmp_path / os.path.basename(src)
        shutil.copy(src, dst)
        srcs.append(str(dst))
    monkeypatch.setattr(native, "_SRCS", srcs)
    before = native.lib_path()
    os.utime(srcs[0], (0, 0))          # an mtime alone changes nothing
    assert native.lib_path() == before
    with open(srcs[0], "a") as f:
        f.write("\n// edited\n")
    assert native.lib_path() != before


def test_chip_smoke_refuses_a_cpu_only_process():
    sys.path.insert(0, REPO)
    import chip_smoke
    with pytest.raises(SystemExit, match="not a GPU"):
        chip_smoke.check_device()
