# Two-stage image mirroring the reference's packaging
# (reference Dockerfile: rust builder → ubuntu runtime).  Stage 1 builds
# the native components; stage 2 is the serving image.
FROM python:3.12-slim AS builder
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*
WORKDIR /src
COPY native/ native/
RUN make -C native

FROM python:3.12-slim
WORKDIR /opt/vector-store-tpu
COPY vector_store_tpu/ vector_store_tpu/
COPY --from=builder /src/native/libvst_native.so native/
COPY pyproject.toml README.md ./
# The GPU runtime comes with JAX's CUDA plugin (jax[cuda12]); the host
# needs an NVIDIA driver matching it.
RUN pip install --no-cache-dir numpy aiohttp "jax[cuda12]"
EXPOSE 6080
CMD ["python", "-m", "vector_store_tpu", "--addr", "0.0.0.0:6080"]
