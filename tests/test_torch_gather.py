"""Port vs ``perf_tpu``: the two Pallas row gathers of
``tools/bench_pallas_encode.py`` (``take_gather``, ``onehot_gather``).

The Pallas kernels themselves run on the CPU in interpret mode
(``pl.pallas_call`` patched to ``interpret=True`` for the test; no JAX file
changes), on a bf16 table [4096, 128] and int32 rows drawn with NumPy from
a seed. The port's gathers on CPU tensors take their plain versions, which
must equal the Pallas outputs bitwise for every block. The CUDA entry
points refuse CPU tensors and ragged blocks before building anything, and
the benchmark entry point refuses to run without a GPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tools import bench_pallas_encode as J

from perf_tpu_torch.kernels import cuda
from perf_tpu_torch.kernels.gather import (onehot_gather, onehot_gather_cuda,
                                           onehot_gather_plain, take_gather,
                                           take_gather_cuda,
                                           take_gather_plain)
from perf_tpu_torch.tools import bench_pallas_encode

N = 1024


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((J.R, J.W)).astype(np.float32)
    rows = rng.integers(0, J.R, N).astype(np.int32)
    tj = jnp.asarray(table).astype(jnp.bfloat16)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    return tj, jnp.asarray(rows), tt, torch.from_numpy(rows)


def _bits(a) -> np.ndarray:
    """bf16 values as their 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("kind,block", [("take", 256), ("take", 512),
                                        ("take", 1024), ("onehot", 512),
                                        ("onehot", 1024)])
def test_port_gathers_equal_the_pallas_kernels(monkeypatch, inputs, kind,
                                               block):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    tj, rj, tt, rt = inputs
    j_fn, t_fn = {"take": (J.take_gather, take_gather),
                  "onehot": (J.onehot_gather, onehot_gather)}[kind]
    ref = _bits(j_fn(tj, rj, block))
    cuda.reset_counts()
    got = t_fn(tt, rt, block)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (N, J.W)
    # one non-zero product per output: both are the table's rows, bitwise
    np.testing.assert_array_equal(_bits(got), ref)
    np.testing.assert_array_equal(ref, _bits(tt[rt.long()]))
    assert all(v == 0 for v in cuda.counts().values())    # the plain path


def test_plain_onehot_works_in_chunks():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((256, 128)).astype(
        np.float32)).to(torch.bfloat16)
    rows = torch.from_numpy(rng.integers(0, 256, 9001).astype(np.int32))
    assert torch.equal(onehot_gather_plain(table, rows).view(torch.int16),
                       take_gather_plain(table, rows).view(torch.int16))


def test_gathers_refuse_ragged_blocks_and_cpu_tensors():
    table = torch.zeros((J.R, J.W), dtype=torch.bfloat16)
    rows = torch.zeros(1000, dtype=torch.int32)
    for fn in (take_gather, onehot_gather):
        # the JAX grid is n // block steps: the tail would stay unwritten
        with pytest.raises(ValueError, match="not a multiple of block"):
            fn(table, rows, 512)
    for fn in (take_gather_cuda, onehot_gather_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(table, torch.zeros(1024, dtype=torch.int32), 512)


def test_benchmark_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_pallas_encode.main(["--samples", "1024"])
    assert e.value.code != 0
