"""Deterministic scatter-add: CUDA kernel ``csrc/scatter_add.cu`` and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/scatter_bucket.py``:
``bucket_scatter_add_planes`` (:112) and ``bucket_scatter_add`` (:151).
``out[g, n, c] = Σ_s v[g, s, c]·1[idx[g, s] == n]``, out-of-range targets
dropped; every sum is taken in ascending source position, on the card and in
the twin, so a run repeats its bits.  Bytes bound it.

:func:`gather_backward` is the backward of every row gather of the port: it
takes the kernel exactly where the JAX gather VJP takes the Pallas kernel
(``mocopci_tpu/ops/sampling.py:206-209``) and ``index_add_`` elsewhere, as JAX
takes XLA's scatter there.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/scatter_add.cu"
REPLACES = "mocopci_tpu/ops/pallas/scatter_bucket.py:112"


def scatter_add_plain(v: torch.Tensor, idx: torch.Tensor, n_rows: int,
                      planes: bool = False) -> torch.Tensor:
    """(G, S, C) rows (or (G, C, S) planes) + (G, S) targets -> (G, n_rows, C),
    one ``index_add_``; out-of-range targets land in a spare row, dropped."""
    rows = v.transpose(1, 2) if planes else v
    G, S, C = rows.shape
    flat = idx.long() + torch.arange(G, device=v.device)[:, None] * n_rows
    flat = torch.where((idx >= 0) & (idx < n_rows), flat, G * n_rows)
    out = torch.zeros((G * n_rows + 1, C), dtype=v.dtype, device=v.device)
    out.index_add_(0, flat.reshape(-1), rows.reshape(G * S, C))
    return out[:-1].reshape(G, n_rows, C)


def scatter_add(v: torch.Tensor, idx: torch.Tensor, n_rows: int,
                planes: bool = False) -> torch.Tensor:
    """The kernel on CUDA, the twin on the CPU; ``planes`` reads v as (G, C, S)."""
    if _lib.dispatch_device(v, idx) == "cpu":
        return scatter_add_plain(v, idx, n_rows, planes)
    _lib.check_cuda("scatter_add v", v, torch.float32, 3)
    _lib.check_cuda("scatter_add idx", idx, torch.int32, 2)
    G = v.shape[0]
    C, S = (v.shape[1], v.shape[2]) if planes else (v.shape[2], v.shape[1])
    if idx.shape != (G, S):
        raise ValueError(f"scatter_add: idx {tuple(idx.shape)} for values {tuple(v.shape)}")
    out = torch.empty((G, n_rows, C), dtype=torch.float32, device=v.device)
    work = torch.empty(G * (3 * n_rows + 1 + S) + 1, dtype=torch.int32, device=v.device)
    _lib.launch("scatter_add", v.data_ptr(), idx.data_ptr(), out.data_ptr(), work.data_ptr(),
                G, S, C, n_rows, int(planes), _lib.stream(v))
    return out


def kernel_gate(n_rows: int, s: int, c: int) -> bool:
    """Where the JAX gather VJP takes its Pallas scatter (``ops/sampling.py:206-209``)."""
    return n_rows % 128 == 0 and s >= 32768 and (c <= 4 and n_rows <= 16384
                                                 or c <= 160 and n_rows <= 2048)


def gather_backward(g: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Gradient of a row gather: (B, S, C) cotangent rows, (B, S) int targets
    -> (B, n_rows, C), through the kernel where :func:`kernel_gate` holds."""
    B, S, C = g.shape
    if kernel_gate(n_rows, S, C):
        return scatter_add(g.float().contiguous(), idx.int().contiguous(), n_rows).to(g.dtype)
    return scatter_add_plain(g, idx, n_rows)
