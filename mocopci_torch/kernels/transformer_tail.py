"""Point-transformer tail: CUDA kernels ``csrc/transformer_tail.cu`` and their twins.

Replaces ``mocopci_tpu/ops/pallas/transformer_tail.py``: ``transformer_tail``
forward (:212) and backward (:237).  Both versions gather the [xyz | k | v]
rows from the table by index; the backward returns the rows' gradient, which
:func:`~mocopci_torch.kernels.scatter_add.gather_backward` scatters into the
table (through the ``scatter_add`` kernel at the refine head's shape, as JAX's
gather VJP).  The backward kernel recomputes the per-channel softmax instead
of reading a saved (m, l).  At the (K, D) of the model's refine heads,
``BWD_SHAPES``, both directions run the chain over tiles of 128 pair rows
with its products on the tensor cores at float32 grade (the backward's
recompute keeps its two mask-deciding products on FMAs); every other (K, D)
whose working set fits in shared memory takes a general route on FMAs,
``transformer_tail_general`` (a block a tile of 8 queries) and
``transformer_tail_bwd_general`` (a query at a time).  Operations bound them
all.
"""
from __future__ import annotations

import math

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.scatter_add import gather_backward

SOURCE = "mocopci_torch/csrc/transformer_tail.cu"
REPLACES = "mocopci_tpu/ops/pallas/transformer_tail.py:212"
REPLACES_BWD = "mocopci_tpu/ops/pallas/transformer_tail.py:237"

_MAX_SMEM = 227 * 1024
BWD_BLOCKS = 132      # one per SM of an H100 (either direction's shared memory fills one)
BWD_ROWS = 128        # the tiled routes' pair rows a tile: 128 / K queries
# (K, D) the tiled routes of both directions take: ModelConfig()
# (refine_k 16) and the tiny configs (refine_k 4), both at the refine head's
# width 64; every other (K, D) takes the general routes
BWD_SHAPES = ((16, 64), (4, 64))
GENERAL_QUERIES = 8   # the general forward's queries a block


def _tail(rows, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2):
    D = q.shape[-1]
    knn_xyz, k_g, v_g = rows[..., :3], rows[..., 3:3 + D], rows[..., 3 + D:]
    rel = xyzq[:, :, None, :] - knn_xyz
    pos = torch.relu(rel @ wd1 + bd1) @ wd2 + bd2
    gv = q[:, :, None] - k_g + pos
    logit = torch.relu(gv @ wg1 + bg1) @ wg2 + bg2
    attn = torch.softmax(logit / math.sqrt(D), dim=2)
    return torch.sum(attn * (v_g + pos), dim=2)


def transformer_tail_plain(table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2):
    """table (B, M, 3+2D), idx (B, N, K), xyzq (B, N, 3), q (B, N, D) -> (B, N, D)."""
    return _tail(_lib.group_rows(table, idx), xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)


def transformer_tail_bwd_plain(table, idx, xyzq, q, *weights_and_dout):
    """(d_rows (B, N, K, 3+2D), dxq, dq, 8 weight grads) by autograd."""
    *weights, dout = weights_and_dout
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (_lib.group_rows(table, idx), xyzq, q, *weights)]
        return torch.autograd.grad(_tail(*leaves), leaves, dout)


def _check(table, idx, xyzq, q, weights):
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
    return B, M, N, K, D


def fwd_route(K: int, D: int) -> str:
    """The forward's entry point for (K, D); raises, before any launch, where
    the general route's working set (3 D^2 + 8 D + 3 K + 3 K D floats)
    exceeds shared memory."""
    if (K, D) in BWD_SHAPES:
        return "transformer_tail"
    need = (3 * D * D + 8 * D + 3 * K + 3 * K * D) * 4
    if need > _MAX_SMEM:
        raise ValueError(f"transformer_tail forward: K={K}, D={D} need {need} bytes of shared "
                         f"memory, past the {_MAX_SMEM} a block has")
    return "transformer_tail_general"


def fwd_grid(B: int, N: int, K: int, route: str = "transformer_tail") -> int:
    """The forward's blocks: one an SM, at most one a tile of 128 / K queries
    (the general route: one a tile of 8 queries of a batch, its own grid)."""
    if route == "transformer_tail_general":
        return B * -(-N // GENERAL_QUERIES)
    return min(BWD_BLOCKS, -(-B * N * K // BWD_ROWS))


def general_floats(K: int, D: int) -> int:
    """The general route's shared memory in floats: the weights and their
    transposed copies, the eight gradients, a query's K x D stages."""
    return 9 * D * D + 20 * D + 6 * K + 11 * K * D


def bwd_route(K: int, D: int) -> str:
    """The backward's entry point for (K, D); raises, before any launch, where
    the general route's working set exceeds shared memory."""
    if (K, D) in BWD_SHAPES:
        return "transformer_tail_bwd"
    if general_floats(K, D) * 4 > _MAX_SMEM:
        raise ValueError(f"transformer_tail backward: K={K}, D={D} need "
                         f"{general_floats(K, D) * 4} bytes of shared memory, past the "
                         f"{_MAX_SMEM} a block has")
    return "transformer_tail_bwd_general"


def bwd_grid(B: int, N: int, K: int, route: str = "transformer_tail_bwd") -> int:
    """The backward's blocks: one an SM, at most one a tile of 128 / K queries
    (the general route: at most one a query)."""
    if route == "transformer_tail_bwd_general":
        return min(BWD_BLOCKS, B * N)
    return min(BWD_BLOCKS, -(-B * N * K // BWD_ROWS))


def transformer_tail_fwd(table, idx, xyzq, q, *weights):
    """Kernel forward, (B, N, D), on the route ``fwd_route`` picks."""
    B, M, N, K, D = _check(table, idx, xyzq, q, weights)
    route = fwd_route(K, D)
    out = torch.empty((B, N, D), dtype=torch.float32, device=table.device)
    grid = () if route == "transformer_tail_general" else (fwd_grid(B, N, K),)
    _lib.launch(route, table.data_ptr(), idx.data_ptr(), xyzq.data_ptr(),
                q.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
                B, M, N, K, D, *grid, _lib.stream(table))
    return out


def transformer_tail_bwd(table, idx, xyzq, q, *weights_and_dout):
    """Kernel backward: (d_rows (B, N, K, 3+2D), dxq, dq, 8 weight grads)."""
    *weights, dout = weights_and_dout
    B, M, N, K, D = _check(table, idx, xyzq, q, weights)
    route = bwd_route(K, D)
    _lib.check_cuda("transformer_tail dout", dout, torch.float32, 3)
    dev = table.device
    d_rows = torch.empty((B, N, K, 3 + 2 * D), dtype=torch.float32, device=dev)
    dxq = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    dq = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    sizes = [3 * D, D, D * D, D, D * D, D, D * D, D]
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    nblk = bwd_grid(B, N, K, route)
    partial = torch.empty(nblk * sum(sizes), dtype=torch.float32, device=dev)
    _lib.launch(route, table.data_ptr(), idx.data_ptr(), xyzq.data_ptr(),
                q.data_ptr(), *(t.data_ptr() for t in weights), dout.data_ptr(),
                d_rows.data_ptr(), dxq.data_ptr(), dq.data_ptr(), dw.data_ptr(),
                partial.data_ptr(), B, M, N, K, D, nblk, _lib.stream(table))
    grads = [g.view(t.shape) for g, t in zip(torch.split(dw, sizes), weights)]
    return (d_rows, dxq, dq, *grads)


class _TransformerTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, xyzq, q, *weights):
        cpu = _lib.dispatch_device(table, idx, xyzq, q, *weights) == "cpu"
        ctx.cpu = cpu
        ctx.save_for_backward(table, idx, xyzq, q, *weights)
        if cpu:
            return transformer_tail_plain(table, idx, xyzq, q, *weights)
        if any(ctx.needs_input_grad):
            bwd_route(idx.shape[2], q.shape[2])      # refuses before the forward's launch
        return transformer_tail_fwd(table, idx, xyzq, q, *weights)

    @staticmethod
    def backward(ctx, dout):
        table, idx, xyzq, q, *weights = ctx.saved_tensors
        bwd = transformer_tail_bwd_plain if ctx.cpu else transformer_tail_bwd
        d_rows, dxq, dq, *dws = bwd(table, idx, xyzq, q, *weights, dout.contiguous())
        B, N, K, W = d_rows.shape
        d_table = gather_backward(d_rows.reshape(B, N * K, W), idx.reshape(B, N * K),
                                  table.shape[1])
        return (d_table, None, dxq, dq, *dws)


def transformer_tail(table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2):
    """The kernels on CUDA, the twins on the CPU; weights (in, out), biases
    (out,); differentiable in everything but idx."""
    return _TransformerTail.apply(table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
