"""The two row gathers of the Pallas encode microbenchmark.

Counterpart of ``tools/bench_pallas_encode.py``'s ``take_gather``
(``take_kernel``) and ``onehot_gather`` (``onehot_kernel``): ``out[i] =
table[rows[i]]`` for a bf16 table [R, 128] and int32 rows [n], the first a
plain row gather, the second the same gather done on the matrix unit as a
one-hot bf16 [n, R] x table product with float32 sums, cast to bf16.

``take_gather`` / ``onehot_gather`` launch the hand-written kernels of
``csrc/row_gather.cu`` for CUDA tensors and take the plain versions here
for CPU tensors. Both take the benchmark's ``block`` (rows per grid step on
the TPU, rows per CTA on the card) and refuse ``n % block != 0``: the JAX
grid is ``n // block`` steps and leaves the tail rows unwritten, which the
port does not copy. Rows must lie in [0, R).
"""

from __future__ import annotations

import torch

from . import cuda

W = 128                 # bf16 lanes per row
ONEHOT_TILE = 128       # output rows per tensor-core tile of the kernel
ONEHOT_K = 64           # table rows per K-tile of the kernel
PLAIN_CHUNK = 4096      # one-hot rows the plain version builds at once


def _check_block(n: int, block: int):
    if block < 1 or n % block:
        raise ValueError(f"{n} rows are not a multiple of block {block} (the "
                         "JAX grid would leave the tail unwritten)")


def take_gather_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]``."""
    return table[rows.long()]


def onehot_gather_plain(table: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """The one-hot product: a bf16 one-hot [chunk, R] times the table with
    float32 sums, cast to bf16, in chunks of rows so that [n, R] is never
    built at once."""
    r = table.shape[0]
    cols = torch.arange(r, device=rows.device)
    tf = table.float()
    outs = []
    for s in range(0, rows.shape[0], PLAIN_CHUNK):
        oh = (rows[s:s + PLAIN_CHUNK, None] == cols).to(torch.bfloat16)
        outs.append((oh.float() @ tf).to(table.dtype))
    return torch.cat(outs) if outs else table.new_empty((0, table.shape[1]))


def _check_args(table, rows):
    cuda.check(table, "table", torch.bfloat16, (None, W))
    cuda.check(rows, "rows", torch.int32, (None,), table.device)
    if rows.shape[0] >= 2 ** 31:
        raise ValueError("the kernels index rows in int32")


def take_gather_cuda(table: torch.Tensor, rows: torch.Tensor,
                     block: int) -> torch.Tensor:
    _check_args(table, rows)
    n = rows.shape[0]
    _check_block(n, block)
    out = torch.empty((n, W), dtype=torch.bfloat16, device=table.device)
    _TAKE.launch(table.data_ptr(), table.shape[0], rows.data_ptr(), n, block,
                 out.data_ptr())
    return out


def onehot_gather_cuda(table: torch.Tensor, rows: torch.Tensor,
                       block: int) -> torch.Tensor:
    _check_args(table, rows)
    n = rows.shape[0]
    _check_block(n, block)
    if block % ONEHOT_TILE or table.shape[0] % ONEHOT_K:
        raise ValueError(f"the one-hot kernel takes a block that is a "
                         f"multiple of {ONEHOT_TILE} rows and a table of a "
                         f"multiple of {ONEHOT_K} rows; got block {block}, "
                         f"{table.shape[0]} rows")
    out = torch.empty((n, W), dtype=torch.bfloat16, device=table.device)
    _ONEHOT.launch(table.data_ptr(), table.shape[0], rows.data_ptr(), n,
                   block, out.data_ptr())
    return out


def _dispatch(kernel, plain, table, rows, block: int) -> torch.Tensor:
    if rows.is_cuda:
        return kernel(table, rows, block)
    if rows.device.type != "cpu":
        raise ValueError(f"row gather: unsupported device {rows.device}")
    _check_block(rows.shape[0], block)
    return plain(table, rows)


def take_gather(table: torch.Tensor, rows: torch.Tensor,
                block: int) -> torch.Tensor:
    """``table[rows]`` by the take kernel (CUDA) or its plain version."""
    return _dispatch(take_gather_cuda, take_gather_plain, table, rows, block)


def onehot_gather(table: torch.Tensor, rows: torch.Tensor,
                  block: int) -> torch.Tensor:
    """``table[rows]`` as a one-hot product on the tensor cores (CUDA) or
    its plain version."""
    return _dispatch(onehot_gather_cuda, onehot_gather_plain, table, rows,
                     block)


_ARGS = [cuda.P, cuda.I32, cuda.P, cuda.I64, cuda.I32, cuda.P]
_TAKE = cuda.register(cuda.CudaKernel(
    "take_gather", "row_gather.cu", "take_gather_launch", _ARGS))
_ONEHOT = cuda.register(cuda.CudaKernel(
    "onehot_gather", "row_gather.cu", "onehot_gather_launch", _ARGS))
