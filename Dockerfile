# acoustid_index — GPU audio-fingerprint search engine.
#
# Operational contract mirrors the reference image
# (/root/reference/Dockerfile: serve on 8080, data in a volume, non-root
# user, wget for healthchecks), adapted to this stack: a Python/JAX server
# whose native C++ codec + search front build inside the image (g++ via
# make -C acoustid_index/native; pure-Python fallbacks exist, so the
# build stage failing soft would still leave a working server).
#
# Run with the host's NVIDIA driver exposed to the container (the NVIDIA
# container toolkit: --gpus all). One server process per card: a JAX
# process reserves three quarters of its card's memory at start. Without a
# GPU the server comes up on the CPU backend (AITPU_JAX_PLATFORMS=cpu) —
# useful for functional smoke tests only.

FROM python:3.12-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make wget \
    && rm -rf /var/lib/apt/lists/*

# The CUDA 12 build of JAX (jaxlib plus its CUDA plugin and the NVIDIA
# libraries from PyPI), pinned in lockstep with the version this tree is
# developed against. numpy is the only other runtime dependency.
RUN pip install --no-cache-dir "jax[cuda12]==0.9.0" numpy

RUN useradd -m -s /bin/bash -u 6081 acoustid

COPY acoustid_index /opt/aitpu/acoustid_index
WORKDIR /opt/aitpu

# Build the native modules at image-build time (first-use auto-build would
# also work, but /opt/aitpu is read-only at runtime for user 6081).
RUN make -C acoustid_index/native && chown -R root:root /opt/aitpu

RUN mkdir -p /var/lib/aitpu && chown acoustid /var/lib/aitpu
VOLUME ["/var/lib/aitpu"]

# Persistent XLA compile cache: keep it in the data volume so server
# restarts reuse compiled search programs (JAX reads this variable; the
# server uses it verbatim).
ENV JAX_COMPILATION_CACHE_DIR=/var/lib/aitpu/.jax-cache
ENV PYTHONUNBUFFERED=1

USER acoustid
EXPOSE 8080

HEALTHCHECK --interval=30s --timeout=5s --start-period=120s \
    CMD wget -q -O /dev/null http://127.0.0.1:8080/_health || exit 1

CMD ["python", "-m", "acoustid_index.main", \
     "--dir", "/var/lib/aitpu", "--host", "0.0.0.0", "--port", "8080"]
