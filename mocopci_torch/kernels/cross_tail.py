"""Cost-volume tail: CUDA kernel ``csrc/cross_tail.cu`` and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/cross_tail.py``: ``cross_tail`` forward
(:155).  The kernel gathers its neighbour rows from the table itself, so both
versions take (table, idx) instead of materialised k-major rows.  Operations
bound it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/cross_tail.cu"
REPLACES = "mocopci_tpu/ops/pallas/cross_tail.py:155"

LEAKY_RATE = 0.1
_MAX_SMEM = 227 * 1024


def cross_tail_plain(tab, idx, base, w, b):
    """max_j leaky(leaky(tab[idx[n, j]] + base[n]) @ w + b): (B, N, C2)."""
    x = F.leaky_relu(_lib.group_rows(tab, idx) + base[:, :, None, :], LEAKY_RATE)
    x = F.leaky_relu(torch.matmul(x, w) + b, LEAKY_RATE)
    return x.amax(dim=2)


def cross_tail(tab, idx, base, w, b):
    """tab (B, M, C), idx (B, N, K) int32, base (B, N, C), w (C, C2), b (C2)."""
    if _lib.dispatch_device(tab, idx, base, w, b) == "cpu":
        return cross_tail_plain(tab, idx, base, w, b)
    _lib.check_cuda("cross_tail tab", tab, torch.float32, 3)
    _lib.check_cuda("cross_tail idx", idx, torch.int32, 3)
    _lib.check_cuda("cross_tail base", base, torch.float32, 3)
    _lib.check_cuda("cross_tail w", w, torch.float32, 2)
    _lib.check_cuda("cross_tail b", b, torch.float32, 1)
    B, M, C = tab.shape
    N, K = idx.shape[1], idx.shape[2]
    C2 = w.shape[1]
    if idx.shape[0] != B or base.shape != (B, N, C) or w.shape[0] != C or b.shape != (C2,):
        raise ValueError("cross_tail: inconsistent shapes")
    if (C * C2 + K * C + 256) * 4 > _MAX_SMEM:
        raise ValueError(f"cross_tail kernel: C={C}, C2={C2}, K={K} exceed shared memory")
    out = torch.empty((B, N, C2), dtype=torch.float32, device=tab.device)
    _lib.launch("cross_tail", tab.data_ptr(), idx.data_ptr(), base.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), B, M, N, K, C, C2, _lib.stream(tab))
    return out
