"""The k smallest of each candidate row: CUDA kernel ``csrc/select_k.cu`` and
its plain twin.

Replaces ``mocopci_tpu/ops/pallas/select_k.py``: ``select_min_k_pallas``
(:54).  For values (..., L) and indices (..., L) it returns (..., k) int32: the
indices at the positions of the k smallest values, in ascending order, ties to
the lowest position.  That is ``lax.top_k(-vals, k)``'s order and the Pallas
kernel's k rounds of (row min, lowest position holding it, mask to +inf).
Without indices the positions themselves are returned.  Values must not be
NaN, and 1 <= k <= L.  Bytes bound it: the values are read once.
"""
from __future__ import annotations

from typing import Optional

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.knn import sort_keys

SOURCE = "mocopci_torch/csrc/select_k.cu"
REPLACES = "mocopci_tpu/ops/pallas/select_k.py:54"

# candidate entries per chunk of the plain version
_CHUNK = 1 << 24


def _check(vals: torch.Tensor, idxs: Optional[torch.Tensor], k: int) -> None:
    if idxs is not None and idxs.shape != vals.shape:
        raise ValueError(f"select_min_k: idxs {tuple(idxs.shape)} for vals {tuple(vals.shape)}")
    if not 1 <= k <= vals.shape[-1]:
        raise ValueError(f"select_min_k: k={k} for rows of {vals.shape[-1]}")


def select_min_k_plain(vals: torch.Tensor, idxs: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """(..., L) values (+ (..., L) indices) -> (..., k) int32, by a top-k of
    (value, position) keys."""
    _check(vals, idxs, k)
    L = vals.shape[-1]
    flat = vals.reshape(-1, L)
    rows = max(1, _CHUNK // L)
    pos = torch.cat([
        torch.topk(sort_keys(flat[s:s + rows].float()), k, dim=-1, largest=False,
                   sorted=True).values & 0xFFFFFFFF
        for s in range(0, flat.shape[0], rows)])
    if idxs is not None:
        pos = idxs.reshape(-1, L).gather(1, pos)
    return pos.to(torch.int32).reshape(vals.shape[:-1] + (k,))


def select_min_k(vals: torch.Tensor, idxs: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """The kernel on CUDA, the twin on the CPU; ``idxs=None`` returns positions."""
    tensors = (vals,) if idxs is None else (vals, idxs)
    if _lib.dispatch_device(*tensors) == "cpu":
        return select_min_k_plain(vals, idxs, k)
    _check(vals, idxs, k)
    L = vals.shape[-1]
    v = vals.float().reshape(-1, L).contiguous()
    _lib.check_cuda("select_min_k vals", v, torch.float32, 2)
    i = None
    if idxs is not None:
        i = idxs.int().reshape(-1, L).contiguous()
        _lib.check_cuda("select_min_k idxs", i, torch.int32, 2)
    R = v.shape[0]
    out = torch.empty((R, k), dtype=torch.int32, device=v.device)
    if R:
        _lib.launch("select_min_k", v.data_ptr(), 0 if i is None else i.data_ptr(),
                    out.data_ptr(), R, L, k, _lib.stream(v))
    return out.reshape(vals.shape[:-1] + (k,))
