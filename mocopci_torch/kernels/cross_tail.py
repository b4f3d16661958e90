"""Cost-volume tail: CUDA kernels ``csrc/cross_tail.cu`` and their plain twins.

Replaces ``mocopci_tpu/ops/pallas/cross_tail.py``: ``cross_tail`` forward
(:155) and backward (:172).  The kernels gather their neighbour rows from the
table themselves, so both versions take (table, idx) instead of materialised
k-major rows; the backward returns the gathered rows' gradient, which
:func:`~mocopci_torch.kernels.scatter_add.gather_backward` scatters into the
table (through the ``scatter_add`` kernel at the up_1 shape, as JAX's gather
VJP).  At a max tie the kernel routes the gradient to the first neighbour, the
twin splits it evenly; both give the same table, base and weight gradients
(duplicate neighbours are the only systematic ties, ``cross_tail.py:20-31``).
Operations bound both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.scatter_add import gather_backward

SOURCE = "mocopci_torch/csrc/cross_tail.cu"
REPLACES = "mocopci_tpu/ops/pallas/cross_tail.py:155"
REPLACES_BWD = "mocopci_tpu/ops/pallas/cross_tail.py:172"

LEAKY_RATE = 0.1
_MAX_SMEM = 227 * 1024
BWD_BLOCKS = 264      # two per SM of an H100; fixes the dW/db summation order


def _tail(rows, base, w, b):
    x = F.leaky_relu(rows + base[:, :, None, :], LEAKY_RATE)
    x = F.leaky_relu(torch.matmul(x, w) + b, LEAKY_RATE)
    return x.amax(dim=2)


def cross_tail_plain(tab, idx, base, w, b):
    """max_j leaky(leaky(tab[idx[n, j]] + base[n]) @ w + b): (B, N, C2)."""
    return _tail(_lib.group_rows(tab, idx), base, w, b)


def cross_tail_bwd_plain(tab, idx, base, w, b, dout):
    """(d_rows (B, N, K, C), d_base, dw, db) of :func:`cross_tail_plain` by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (_lib.group_rows(tab, idx), base, w, b)]
        return torch.autograd.grad(_tail(*leaves), leaves, dout)


def _check(tab, idx, base, w, b):
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
    if (C * C2 + K * C + 256) * 4 > _MAX_SMEM or (3 * C * C2 + 3 * C2 + 2 * K * C + 512) * 4 > _MAX_SMEM:
        raise ValueError(f"cross_tail kernel: C={C}, C2={C2}, K={K} exceed shared memory")
    return B, M, N, K, C, C2


def cross_tail_fwd(tab, idx, base, w, b):
    """Kernel forward, (B, N, C2)."""
    B, M, N, K, C, C2 = _check(tab, idx, base, w, b)
    out = torch.empty((B, N, C2), dtype=torch.float32, device=tab.device)
    _lib.launch("cross_tail", tab.data_ptr(), idx.data_ptr(), base.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), B, M, N, K, C, C2, _lib.stream(tab))
    return out


def cross_tail_bwd(tab, idx, base, w, b, out, dout):
    """Kernel backward: (d_rows (B, N, K, C), d_base, dw, db)."""
    B, M, N, K, C, C2 = _check(tab, idx, base, w, b)
    _lib.check_cuda("cross_tail dout", dout, torch.float32, 3)
    dev = tab.device
    d_rows = torch.empty((B, N, K, C), dtype=torch.float32, device=dev)
    d_base = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    dwb = torch.empty(C * C2 + C2, dtype=torch.float32, device=dev)
    nblk = min(BWD_BLOCKS, B * N)
    partial = torch.empty(nblk * (C * C2 + C2), dtype=torch.float32, device=dev)
    _lib.launch("cross_tail_bwd", tab.data_ptr(), idx.data_ptr(), base.data_ptr(),
                w.data_ptr(), b.data_ptr(), out.data_ptr(), dout.data_ptr(), d_rows.data_ptr(),
                d_base.data_ptr(), dwb.data_ptr(), partial.data_ptr(), B, M, N, K, C, C2, nblk,
                _lib.stream(tab))
    return d_rows, d_base, dwb[:C * C2].view(C, C2), dwb[C * C2:]


class _CrossTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tab, idx, base, w, b):
        cpu = _lib.dispatch_device(tab, idx, base, w, b) == "cpu"
        out = cross_tail_plain(tab, idx, base, w, b) if cpu else cross_tail_fwd(
            tab, idx, base, w, b)
        ctx.save_for_backward(tab, idx, base, w, b, out)
        ctx.cpu = cpu
        return out

    @staticmethod
    def backward(ctx, dout):
        tab, idx, base, w, b, out = ctx.saved_tensors
        if ctx.cpu:
            d_rows, d_base, dw, db = cross_tail_bwd_plain(tab, idx, base, w, b, dout)
        else:
            d_rows, d_base, dw, db = cross_tail_bwd(tab, idx, base, w, b, out,
                                                    dout.contiguous())
        B, N, K, C = d_rows.shape
        d_tab = gather_backward(d_rows.reshape(B, N * K, C), idx.reshape(B, N * K),
                                tab.shape[1])
        return d_tab, None, d_base, dw, db


def cross_tail(tab, idx, base, w, b):
    """tab (B, M, C), idx (B, N, K) int32, base (B, N, C), w (C, C2), b (C2)
    -> (B, N, C2); the kernels on CUDA, the twins on the CPU; differentiable
    in tab, base, w and b."""
    return _CrossTail.apply(tab, idx, base, w, b)
