"""Training attention with dropout: CUDA ``csrc/attention_train.cu`` and its twin.

Replaces ``mocopci_tpu/ops/pallas/attention_train.py``: ``attention_train``
(:160), forward (:181) and backward (:206).  The dropout mask is a counter
hash, a pure function of (seed, group, row, column), rebuilt bit for bit by
the forward kernel, the backward kernel and the twin; the twin computes it
in int64 masked to 32 bits, as PyTorch has little uint32 arithmetic.  The
counter of pair (row, col) is ``(row << s) ^ col`` with ``s =
row_shift(M)``, max(12, ceil(log2 M)): up to 4096 keys s = 12 and the mask
is the TPU kernel's ``_keep_mask`` (:46-64) bit for bit; past 4096 keys
(where JAX takes its chunked XLA path, whose mask is drawn otherwise) the
shift grows so that no two pairs share a counter.  Operations bound it.

Each direction has two routes, each its own counted entry point, picked by
the head dim D alone.  The forward: D <= ``MAX_FWD_D`` takes
``attention_train_fwd`` (one pass over the keys, streamed through shared
memory, with an online softmax), wider heads (the ``CrossFrameBlock``'s D =
256) ``attention_train_fwd_wide`` (one pass over tiles of 64 keys, both
products on ``mma.sync`` at float32 grade).  The backward, both routes one
pass over the pairs (each pair computed once) between a dot prologue and a
dq epilogue: D <= ``MAX_BWD_D`` takes ``attention_train_bwd`` (FMAs), wider
heads ``attention_train_bwd_wide`` (the five products on the tensor cores
at float32 grade).  Both routes of a direction return the same (out, lse) or
(dq, dk, dv).
"""
from __future__ import annotations

import numpy as np
import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/attention_train.cu"
REPLACES = "mocopci_tpu/ops/pallas/attention_train.py:181"      # forward pallas_call
REPLACES_BWD = "mocopci_tpu/ops/pallas/attention_train.py:206"  # backward pallas_call

# keys a call takes: the counter's shift is 14 there, unique up to 2^18 queries
MAX_SEQ = 16384
MAX_D = 2048
MAX_FWD_D = 64      # the one-pass forward's widest head (csrc kMaxFwdD)
MAX_BWD_D = 64      # the one-pass backward's widest head (csrc kMaxBwdD)
BWD_KEYS = 64       # its keys per block (csrc kBwdKeys): dq partials per key tile
WIDE_KEYS = 32      # the wide route's keys per block (csrc kWKeys)
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finaliser on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_constants(rate: float):
    """(threshold, keep scale) exactly as the TPU kernel forms them."""
    return int(np.int32(rate * (1 << 24))), float(np.float32(1.0 / (1.0 - rate)))


def row_shift(M: int) -> int:
    """The counter's row shift for M keys, max(12, ceil(log2 M)) (csrc
    ``row_shift``): 12, the TPU kernel's, up to 4096 keys."""
    return max(12, (M - 1).bit_length())


def dropout_counter(N: int, M: int, device=None) -> torch.Tensor:
    """(N, M) int64 counters ``(row << row_shift(M)) ^ col``, unique while
    N <= 2^(32 - row_shift(M))."""
    rows = torch.arange(N, dtype=torch.int64, device=device)[:, None] << row_shift(M)
    return rows ^ torch.arange(M, dtype=torch.int64, device=device)[None, :]


def keep_mask_plain(seed: int, G: int, N: int, M: int, rate: float,
                    device=None) -> torch.Tensor:
    """(G, N, M) f32 keep factors: 1/(1-rate) where kept, 0 where dropped."""
    thr, kscale = dropout_constants(rate)
    g = torch.arange(G, dtype=torch.int64, device=device)
    gseed = _fmix32(g ^ (int(seed) & _M32))                       # (G,)
    h = _fmix32(dropout_counter(N, M, device)[None] ^ gseed[:, None, None])
    keep = (h & 0xFFFFFF) >= thr
    return torch.where(keep, torch.tensor(kscale, device=device),
                       torch.tensor(0.0, device=device))


def attention_train_plain(q, k, v, seed: int, scale: float, rate: float) -> torch.Tensor:
    """(G, N, D), (G, M, D), (G, M, D) -> (G, N, D): softmax, then the mask, then v."""
    attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * scale, dim=-1)
    if rate > 0.0:
        attn = attn * keep_mask_plain(seed, q.shape[0], q.shape[1], k.shape[1], rate, q.device)
    return torch.matmul(attn, v)


def attention_train_bwd_plain(q, k, v, seed, scale, rate, dout):
    """(dq, dk, dv) of :func:`attention_train_plain` by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_train_plain(*leaves, seed, scale, rate)
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.check_cuda(f"attention_train {name}", t, torch.float32, 3)
    G, N, D = q.shape
    M = k.shape[1]
    if k.shape != (G, M, D) or v.shape != (G, M, D):
        raise ValueError(f"attention_train: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not 1 <= M <= MAX_SEQ or D > MAX_D or N > 2 ** (32 - row_shift(M)):
        raise ValueError(f"attention_train kernel covers M <= {MAX_SEQ}, D <= {MAX_D}, "
                         f"N <= 2^(32 - row_shift(M)); got N={N}, M={M}, D={D}")


def _check_seed(seed, q):
    _lib.check_cuda("attention_train seed", seed, torch.int32, 1)
    if seed.numel() != 1 or seed.device != q.device:
        raise ValueError("attention_train: seed must be one int32 on the inputs' device")


def attention_train_fwd(q, k, v, seed, scale, rate):
    """Kernel forward: (out (G, N, D), lse (G, N)) on the card, by
    ``attention_train_fwd`` for D <= MAX_FWD_D and ``attention_train_fwd_wide``
    above; seed a (1,) int32 tensor on the card (read there, so drawing it
    costs no sync)."""
    _check(q, k, v)
    _check_seed(seed, q)
    G, N, D = q.shape
    thr, kscale = dropout_constants(rate)
    out = torch.empty_like(q)
    lse = torch.empty((G, N), dtype=torch.float32, device=q.device)
    _lib.launch("attention_train_fwd" if D <= MAX_FWD_D else "attention_train_fwd_wide",
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), G, N, k.shape[1], D, float(scale),
                seed.data_ptr(), thr, kscale, _lib.stream(q))
    return out, lse


def _padded_dim(D: int) -> int:
    """The one-pass backward's head dim: D padded with zeros to 8, 16, 32 or 64."""
    return next(p for p in (8, 16, 32, 64) if D <= p)


def attention_train_bwd(q, k, v, out, lse, dout, seed, scale, rate):
    """Kernel backward: (dq, dk, dv) on the card, by ``attention_train_bwd``
    for D <= MAX_BWD_D and ``attention_train_bwd_wide`` above."""
    _check(q, k, v)
    _check_seed(seed, q)
    _lib.check_cuda("attention_train dout", dout, torch.float32, 3)
    G, N, D = q.shape
    M = k.shape[1]
    thr, kscale = dropout_constants(rate)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv)]
    wide = D > MAX_BWD_D
    # the dq partials (G, key tiles, N, D, padded on the one-pass route), then dot (G, N)
    keys, dp = (WIDE_KEYS, D) if wide else (BWD_KEYS, _padded_dim(D))
    work = torch.empty(G * -(-M // keys) * N * dp + G * N, dtype=torch.float32,
                       device=q.device)
    _lib.launch("attention_train_bwd_wide" if wide else "attention_train_bwd", *ptrs,
                work.data_ptr(), G, N, M, D, float(scale), seed.data_ptr(), thr, kscale,
                _lib.stream(q))
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, scale, rate):
        ctx.consts = (scale, rate)
        if _lib.dispatch_device(q, k, v, seed) == "cpu":
            ctx.save_for_backward(q, k, v, seed)
            return attention_train_plain(q, k, v, int(seed), scale, rate)
        out, lse = attention_train_fwd(q, k, v, seed, scale, rate)
        ctx.save_for_backward(q, k, v, seed, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        scale, rate = ctx.consts
        saved = ctx.saved_tensors
        if len(saved) == 4:
            q, k, v, seed = saved
            grads = attention_train_bwd_plain(q, k, v, int(seed), scale, rate, dout)
        else:
            q, k, v, seed, out, lse = saved
            grads = attention_train_bwd(q, k, v, out, lse, dout.contiguous(), seed, scale, rate)
        return (*grads, None, None, None)


def attention_train(q, k, v, seed: torch.Tensor, scale: float, rate: float) -> torch.Tensor:
    """softmax(q kᵀ · scale) · keep-mask · v with a backward; the kernels on
    CUDA, the twin on the CPU.  ``seed``: a (1,) int32 tensor on the inputs'
    device (negative seeds wrap to uint32, as in the TPU kernel)."""
    return _AttentionTrain.apply(q, k, v, seed.reshape(1), float(scale), float(rate))
