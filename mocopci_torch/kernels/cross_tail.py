"""Cost-volume tail: CUDA kernels ``csrc/cross_tail.cu`` and their plain twins.

Replaces ``mocopci_tpu/ops/pallas/cross_tail.py``: ``cross_tail`` forward
(:155) and backward (:172).  The kernels gather their neighbour rows from the
table themselves, so both versions take (table, idx) instead of materialised
k-major rows; the backward returns the gathered rows' gradient, which
:func:`~mocopci_torch.kernels.scatter_add.gather_backward` scatters into the
table (through the ``scatter_add`` kernel at the up_1 shape, as JAX's gather
VJP).  When a gradient is needed the forward kernel also writes, for each
output, the first neighbour j attaining its max (:func:`cross_tail_argmax_plain`
is its twin), and the backward kernel routes the gradient there with no
recompute; the twin's backward splits a max tie evenly instead.  Both give
the same table, base and weight gradients (duplicate neighbours are the only
systematic ties, ``cross_tail.py:20-31``).  Operations bound the forward, a
register-tiled product over chunks of 128 gathered pair rows on a fixed grid
(``FWD_BLOCKS``); bytes (the rows' gradient it writes) bound the backward.
Where that product's shared memory (W, x transposed, 128 staged rows) does
not fit, as at cross3 of a 32768-point cloud (C = C2 = 256), the forward
takes the declared route ``cross_tail_wide`` (:func:`fwd_route`): a block a
query, the same chains, so the same bits and argmax.  The backward likewise
(:func:`bwd_route`): where its tiled footprint (W and dW transposed, a
query's rows and their gradient) does not fit, ``cross_tail_bwd_wide``
takes groups of 4 queries a block, W read from a transposed copy in L2 and
dW summed into per-block partials in global memory; its d_rows and d_base
are the tiled kernel's bits, its dW and db the same sums in another
grouping.
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
# the backward's fixed grid, two blocks per SM of an H100: each block sums its
# tiles' dW / db in query order, the partials are summed in block order
BWD_BLOCKS = 264
# the forward's fixed grid, two blocks per SM, walking units of fwd_tile(K)
# queries (csrc ``cross_tail_kernel``)
FWD_BLOCKS = 264
_FWD_ROWS = 128       # pair rows a chunk (csrc kFRows), in whole row groups of 8
_FWD_COLS = 64        # output channels a pass (csrc kFCols)
# the wide route's fixed grid, eight blocks of 128 threads per SM
WIDE_BLOCKS = 1056
# the wide backward's fixed grid, one block per SM, each walking groups of
# BWD_WIDE_QUERIES queries (csrc kBQ) and summing its dW / db partial
BWD_WIDE_BLOCKS = 132
BWD_WIDE_QUERIES = 4


def _tail_pre(rows, base, w, b):
    x = F.leaky_relu(rows + base[:, :, None, :], LEAKY_RATE)
    return F.leaky_relu(torch.matmul(x, w) + b, LEAKY_RATE)


def _tail(rows, base, w, b):
    return _tail_pre(rows, base, w, b).amax(dim=2)


def argmax_dtype(K: int) -> torch.dtype:
    """The forward's argmax type: one byte an entry while K <= 255."""
    return torch.uint8 if K <= 255 else torch.int32


def cross_tail_plain(tab, idx, base, w, b):
    """max_j leaky(leaky(tab[idx[n, j]] + base[n]) @ w + b): (B, N, C2)."""
    return _tail(_lib.group_rows(tab, idx), base, w, b)


def cross_tail_argmax_plain(tab, idx, base, w, b):
    """The first j attaining each max of :func:`cross_tail_plain`, (B, N, C2)
    of :func:`argmax_dtype` (K)."""
    h = _tail_pre(_lib.group_rows(tab, idx), base, w, b)
    return torch.argmax(h, dim=2).to(argmax_dtype(idx.shape[2]))


def cross_tail_bwd_plain(tab, idx, base, w, b, dout):
    """(d_rows (B, N, K, C), d_base, dw, db) of :func:`cross_tail_plain` by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (_lib.group_rows(tab, idx), base, w, b)]
        return torch.autograd.grad(_tail(*leaves), leaves, dout)


def fwd_tile(K: int) -> int:
    """Queries a forward unit: as many as 128 pair rows hold, K padded to 8
    (one, in chunks of 128 rows, past that; csrc ``fwd_tile``)."""
    kp = -(-K // 8) * 8
    return 1 if kp >= _FWD_ROWS else _FWD_ROWS // kp


def fwd_grid(B: int, N: int, K: int) -> int:
    """The forward's blocks: one a unit, at most ``FWD_BLOCKS``."""
    return min(FWD_BLOCKS, -(-B * N // fwd_tile(K)))


def _fwd_smem(K, C, C2):
    """The forward's shared memory (csrc ``fwd_smem_floats``): W and b padded
    to whole passes, x transposed, a chunk's staged rows, the unit's base
    rows, the row groups' maxima and the running maxima."""
    c2p = -(-C2 // _FWD_COLS) * _FWD_COLS
    s = -(-C // 4) * 4
    stride = s if (s // 4) % 2 else s + 4
    floats = (c2p * C + C * (_FWD_ROWS + 4) + _FWD_ROWS * stride
              + -(-fwd_tile(K) * C // 4) * 4 + c2p + 2 * (_FWD_ROWS // 8) * _FWD_COLS + 2 * c2p)
    return floats * 4


def _bwd_smem(K, C, C2):
    """The backward's shared memory at its smallest tile, one query
    (csrc/cross_tail.cu ``bwd_smem_floats``)."""
    return (2 * K * C + 2 * C * C2 + C2 + C + 2 * C2) * 4


def _bwd_wide_smem(K, C, C2):
    """The wide backward's shared memory (csrc ``bwd_wide_smem_floats``): a
    group's rows by C, then its gradients and argmax by C2."""
    return BWD_WIDE_QUERIES * (K * C + 2 * C2) * 4


def _wide_smem(K, C):
    """The wide route's shared memory: x of K rows padded to 8 by C padded
    to 4."""
    return (-(-C // 4) * 4) * (-(-K // 8) * 8) * 4


def fwd_route(K: int, C: int, C2: int) -> str:
    """The forward's entry point for (K, C, C2): the tiled ``cross_tail``
    where its shared memory fits, else ``cross_tail_wide``; raises, before
    any launch, where neither fits."""
    if _fwd_smem(K, C, C2) <= _MAX_SMEM:
        return "cross_tail"
    if _wide_smem(K, C) <= _MAX_SMEM:
        return "cross_tail_wide"
    raise ValueError(f"cross_tail kernel: C={C}, C2={C2}, K={K} exceed shared memory")


def bwd_route(K: int, C: int, C2: int) -> str:
    """The backward's entry point for (K, C, C2): the tiled ``cross_tail_bwd``
    where its shared memory fits, else ``cross_tail_bwd_wide``; raises,
    before any launch, where neither fits."""
    if _bwd_smem(K, C, C2) <= _MAX_SMEM:
        return "cross_tail_bwd"
    if _bwd_wide_smem(K, C, C2) <= _MAX_SMEM:
        return "cross_tail_bwd_wide"
    raise ValueError(f"cross_tail backward: C={C}, C2={C2}, K={K} exceed shared memory")


def _check(tab, idx, base, w):
    _lib.check_cuda("cross_tail tab", tab, torch.float32, 3)
    _lib.check_cuda("cross_tail idx", idx, torch.int32, 3)
    _lib.check_cuda("cross_tail base", base, torch.float32, 3)
    _lib.check_cuda("cross_tail w", w, torch.float32, 2)
    B, M, C = tab.shape
    N, K = idx.shape[1], idx.shape[2]
    C2 = w.shape[1]
    if idx.shape[0] != B or base.shape != (B, N, C) or w.shape[0] != C:
        raise ValueError("cross_tail: inconsistent shapes")
    return B, M, N, K, C, C2


def _check_argmax(argmax, B, N, K, C2):
    if argmax.dtype != argmax_dtype(K) or argmax.shape != (B, N, C2):
        raise ValueError(f"cross_tail argmax: expected {argmax_dtype(K)} {(B, N, C2)}, got "
                         f"{argmax.dtype} {tuple(argmax.shape)}")
    _lib.check_cuda("cross_tail argmax", argmax, argmax_dtype(K), 3)


def cross_tail_fwd(tab, idx, base, w, b, argmax=None):
    """Kernel forward, (B, N, C2); fills ``argmax`` ((B, N, C2) of
    :func:`argmax_dtype` (K)) with the first j at each max when given."""
    B, M, N, K, C, C2 = _check(tab, idx, base, w)
    route = fwd_route(K, C, C2)
    _lib.check_cuda("cross_tail b", b, torch.float32, 1)
    if b.shape != (C2,):
        raise ValueError("cross_tail: inconsistent shapes")
    if argmax is not None:
        _check_argmax(argmax, B, N, K, C2)
    out = torch.empty((B, N, C2), dtype=torch.float32, device=tab.device)
    nblk = fwd_grid(B, N, K) if route == "cross_tail" else min(WIDE_BLOCKS, B * N)
    _lib.launch(route, tab.data_ptr(), idx.data_ptr(), base.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), 0 if argmax is None else argmax.data_ptr(),
                B, M, N, K, C, C2, nblk, _lib.stream(tab))
    return out


def cross_tail_bwd(tab, idx, base, w, out, argmax, dout):
    """Kernel backward from the forward's ``out`` (its sign gives leaky' at
    the max) and ``argmax``: (d_rows (B, N, K, C), d_base, dw, db)."""
    B, M, N, K, C, C2 = _check(tab, idx, base, w)
    route = bwd_route(K, C, C2)
    _check_argmax(argmax, B, N, K, C2)
    _lib.check_cuda("cross_tail out", out, torch.float32, 3)
    _lib.check_cuda("cross_tail dout", dout, torch.float32, 3)
    if out.shape != (B, N, C2) or dout.shape != (B, N, C2):
        raise ValueError("cross_tail: inconsistent shapes")
    dev = tab.device
    d_rows = torch.empty((B, N, K, C), dtype=torch.float32, device=dev)
    d_base = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    dwb = torch.empty(C * C2 + C2, dtype=torch.float32, device=dev)
    if route == "cross_tail_bwd":
        nblk = min(BWD_BLOCKS, B * N)     # a block with no tile writes zero partials
        work = torch.empty(nblk * (C * C2 + C2), dtype=torch.float32, device=dev)
    else:
        # every block takes a group, so every partial is written; W
        # transposed before the partials
        nblk = min(BWD_WIDE_BLOCKS, -(-B * N // BWD_WIDE_QUERIES))
        work = torch.empty(C * C2 + nblk * (C * C2 + C2), dtype=torch.float32, device=dev)
    _lib.launch(route, tab.data_ptr(), idx.data_ptr(), base.data_ptr(),
                w.data_ptr(), out.data_ptr(), argmax.data_ptr(), dout.data_ptr(),
                d_rows.data_ptr(), d_base.data_ptr(), dwb.data_ptr(), work.data_ptr(),
                B, M, N, K, C, C2, nblk, _lib.stream(tab))
    return d_rows, d_base, dwb[:C * C2].view(C, C2), dwb[C * C2:]


class _CrossTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tab, idx, base, w, b, grad):
        ctx.cpu = _lib.dispatch_device(tab, idx, base, w, b) == "cpu"
        if ctx.cpu:
            ctx.save_for_backward(tab, idx, base, w, b)
            return cross_tail_plain(tab, idx, base, w, b)
        argmax = None
        if grad:
            # a backward that no route can take is refused before the forward
            bwd_route(idx.shape[2], tab.shape[2], w.shape[1])
            argmax = torch.empty((idx.shape[0], idx.shape[1], w.shape[1]),
                                 dtype=argmax_dtype(idx.shape[2]), device=tab.device)
        out = cross_tail_fwd(tab, idx, base, w, b, argmax)
        # the backward reads out's sign (leaky' at the max) and the argmax
        ctx.save_for_backward(tab, idx, base, w, out, argmax)
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.cpu:
            tab, idx, base, w, b = ctx.saved_tensors
            d_rows, d_base, dw, db = cross_tail_bwd_plain(tab, idx, base, w, b, dout)
        else:
            tab, idx, base, w, out, argmax = ctx.saved_tensors
            d_rows, d_base, dw, db = cross_tail_bwd(tab, idx, base, w, out, argmax,
                                                    dout.contiguous())
        B, N, K, C = d_rows.shape
        d_tab = gather_backward(d_rows.reshape(B, N * K, C), idx.reshape(B, N * K),
                                tab.shape[1])
        return d_tab, None, d_base, dw, db, None


def cross_tail(tab, idx, base, w, b):
    """tab (B, M, C), idx (B, N, K) int32, base (B, N, C), w (C, C2), b (C2)
    -> (B, N, C2); the kernels on CUDA, the twins on the CPU; differentiable
    in tab, base, w and b (the forward kernel saves its argmax only then)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (tab, base, w, b))
    return _CrossTail.apply(tab, idx, base, w, b, grad)
