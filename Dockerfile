# rkmh-tpu container image (the reference ships ubuntu:16.04 + make;
# here: python + JAX + the package, native IO extension built at install).
# For NVIDIA GPUs install jax[cuda12] instead of the CPU jax below.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ zlib1g-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/rkmh-tpu
COPY pyproject.toml README.md ./
COPY rkmh_tpu ./rkmh_tpu
COPY scripts ./scripts

COPY model_docker ./model_docker

# optax powers the built-in VW-format trainer (rkmh-tpu-wabbit)
RUN pip install --no-cache-dir "jax[cpu]" numpy optax && pip install --no-cache-dir -e . \
    && python -c "from rkmh_tpu.io.native import load; load()"  # prebuild librkmh_io.so

ENTRYPOINT ["rkmh-tpu"]
CMD ["--help"]
