#!/bin/bash
# CI: build native lib, run the test suite on local CPU devices, smoke the
# CLIs (reference CI was build + --help only, .travis.yml:39-41; we do more).
#
# Each test file runs in its OWN pytest process, which keeps one file's
# compile state from affecting the next. The GPU checks are not tests:
# run `python chip_smoke.py` on a machine with an NVIDIA GPU.
set -e
cd "$(dirname "$0")/.."
python -c "from segalign_tpu.native import get_lib; assert get_lib() is not None, 'native build failed'"

# LASTZ ground-truth gate: zero-egress containers can't download lastz
# (the reference vendors it as a submodule, .gitmodules:1-6). Drop
# lastz-1.04.*.tar.gz into third_party/ whenever network exists and this
# builds it, un-skipping tests/test_lastz_ground_truth.py.
tarball=$(ls third_party/lastz-*.tar.gz 2>/dev/null | head -1 || true)
if [ -n "$tarball" ] && ! command -v lastz >/dev/null 2>&1; then
    lzdir=$(mktemp -d)
    tar -xzf "$tarball" -C "$lzdir"
    if make -C "$lzdir"/lastz-*/src -j lastz >/dev/null 2>&1; then
        export PATH="$(dirname "$(ls "$lzdir"/lastz-*/src/lastz)"):$PATH"
        echo "lastz built from $tarball: ground-truth gate active"
    else
        echo "lastz build from $tarball failed; gate stays skipped"
    fi
fi

fail=0
total_passed=0
for f in tests/test_*.py; do
    out=$(python -m pytest "$f" -q --tb=short 2>&1) || {
        echo "$out"
        echo "CI FAIL: $f"
        fail=1
        break
    }
    tail=$(echo "$out" | tail -1)
    echo "$f: $tail"
done
[ "$fail" -ne 0 ] && exit 1

python -m segalign_tpu.cli.run_segalign --help > /dev/null
python -m segalign_tpu.cli.run_segalign_repeat_masker --help > /dev/null
echo "CI OK"
