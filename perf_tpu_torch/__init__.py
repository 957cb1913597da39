"""perf_tpu_torch — the PyTorch / CUDA port of ``perf_tpu`` for NVIDIA Hopper.

The package mirrors ``perf_tpu``'s file layout, so every module has its
JAX counterpart at the same relative path. It imports ``torch`` and never
``jax``. ``mode=train``, ``mode=render_dense`` and ``mode=serve`` run here
end to end (``python -m perf_tpu_torch``):

- ``core``     — rays, cameras, resampling, morphology, the guarded Adam
- ``kernels``  — the brick and hash grids (plain encodes), the row
  gathers, and the CUDA kernel build
- ``fields``   — the NGP field on either grid, the sphere distance field
- ``render``   — occupancy grids, the marches, the baked snapshot
- ``train``    — ``NeRFScene`` (fit, prune, bake, render), the pool,
  checkpoints
- ``app``      — the runner and the HTTP scene server
- ``tools``    — the row-gather microbenchmark
- ``convert``  — carries a ``perf_tpu`` parameter tree into torch tensors

Every hand-written kernel has a plain PyTorch version beside it. A wrapper
runs the plain version for CPU tensors and launches its CUDA kernel for
CUDA tensors (sources in ``kernels/csrc``, built with ``nvcc`` at first use).
"""

__version__ = "0.1.0"
