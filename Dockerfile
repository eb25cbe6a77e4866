# SegAlign container. The image runs on the CPU as built; for an NVIDIA
# GPU install JAX's CUDA plugin instead ("jax[cuda12]").
FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    curl ca-certificates \
    && rm -rf /var/lib/apt/lists/*
# LASTZ for the byte-compatible gapped stage + the ground-truth test gate
# (tests/test_lastz_ground_truth.py). Same source the reference builds
# (scripts/installUbuntu.sh:69-75 pins the lastz submodule; we take the
# canonical release tarball). The build is best-effort: the native ydrop
# stage covers gapped mode when lastz is absent.
RUN curl -fsSL https://github.com/lastz/lastz/archive/refs/tags/1.04.22.tar.gz \
      | tar xz -C /tmp \
    && make -C /tmp/lastz-1.04.22/src -j lastz \
    && install -m 0755 /tmp/lastz-1.04.22/src/lastz /usr/local/bin/lastz \
    && rm -rf /tmp/lastz-1.04.22 || echo "lastz build skipped (no network)"
WORKDIR /opt/segalign_tpu
COPY segalign_tpu ./segalign_tpu
COPY setup.py README.md ./
RUN pip install --no-cache-dir "jax[cpu]" numpy && pip install .
ENTRYPOINT ["run_segalign"]
