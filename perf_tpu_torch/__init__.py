"""perf_tpu_torch — the PyTorch / CUDA port of ``perf_tpu`` for NVIDIA Hopper.

The package mirrors ``perf_tpu``'s file layout, so every module has its
JAX counterpart at the same relative path. It imports ``torch`` and never
``jax``. The serving path (``mode=serve``) runs here end to end:

- ``core``     — rays and the pano / perspective camera chain
- ``kernels``  — brick-grid encode (plain) and the CUDA kernel build
- ``fields``   — the NGP brick field: MLP, ``trunc_exp``, fused ``field_eval``
- ``render``   — occupancy grids, the eval march, the baked snapshot
- ``train``    — checkpoint IO and ``NeRFScene`` (bake + render)
- ``app``      — the HTTP scene server
- ``convert``  — carries a ``perf_tpu`` parameter tree into torch tensors

Every hand-written kernel has a plain PyTorch version beside it. A wrapper
runs the plain version for CPU tensors and launches its CUDA kernel for
CUDA tensors (sources in ``kernels/csrc``, built with ``nvcc`` at first use).
"""

__version__ = "0.1.0"
