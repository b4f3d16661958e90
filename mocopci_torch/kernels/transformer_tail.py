"""Point-transformer tail: CUDA kernel ``csrc/transformer_tail.cu`` and its twin.

Replaces ``mocopci_tpu/ops/pallas/transformer_tail.py``: ``transformer_tail``
forward (:212).  Both versions gather the [xyz | k | v] rows from the table
by index.  Operations bound it.
"""
from __future__ import annotations

import math

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/transformer_tail.cu"
REPLACES = "mocopci_tpu/ops/pallas/transformer_tail.py:212"

_MAX_SMEM = 227 * 1024


def transformer_tail_plain(table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2):
    """table (B, M, 3+2D), idx (B, N, K), xyzq (B, N, 3), q (B, N, D) -> (B, N, D)."""
    D = q.shape[-1]
    r = _lib.group_rows(table, idx)
    knn_xyz, k_g, v_g = r[..., :3], r[..., 3:3 + D], r[..., 3 + D:]
    rel = xyzq[:, :, None, :] - knn_xyz
    pos = torch.relu(rel @ wd1 + bd1) @ wd2 + bd2
    gv = q[:, :, None] - k_g + pos
    logit = torch.relu(gv @ wg1 + bg1) @ wg2 + bg2
    attn = torch.softmax(logit / math.sqrt(D), dim=2)
    return torch.sum(attn * (v_g + pos), dim=2)


def transformer_tail(table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2):
    """Kernel on CUDA, twin on the CPU; weights (in, out), biases (out,)."""
    weights = (wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    if _lib.dispatch_device(table, idx, xyzq, q, *weights) == "cpu":
        return transformer_tail_plain(table, idx, xyzq, q, *weights)
    _lib.check_cuda("transformer_tail table", table, torch.float32, 3)
    _lib.check_cuda("transformer_tail idx", idx, torch.int32, 3)
    _lib.check_cuda("transformer_tail xyzq", xyzq, torch.float32, 3)
    _lib.check_cuda("transformer_tail q", q, torch.float32, 3)
    B, M, W = table.shape
    N, K = idx.shape[1], idx.shape[2]
    D = q.shape[2]
    if W != 3 + 2 * D or xyzq.shape != (B, N, 3) or q.shape != (B, N, D):
        raise ValueError("transformer_tail: inconsistent shapes")
    for i, t in enumerate(weights):
        _lib.check_cuda(f"transformer_tail weight {i}", t, torch.float32, 2 - i % 2)
        want = (D,) if i % 2 else ((3, D) if i == 0 else (D, D))
        if tuple(t.shape) != want:
            raise ValueError(f"transformer_tail weight {i}: {tuple(t.shape)} != {want}")
    if (3 * D * D + 8 * D + 3 * K + 3 * K * D) * 4 > _MAX_SMEM:
        raise ValueError(f"transformer_tail kernel: D={D}, K={K} exceed shared memory")
    out = torch.empty((B, N, D), dtype=torch.float32, device=table.device)
    _lib.launch("transformer_tail", table.data_ptr(), idx.data_ptr(), xyzq.data_ptr(),
                q.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
                B, M, N, K, D, _lib.stream(table))
    return out
