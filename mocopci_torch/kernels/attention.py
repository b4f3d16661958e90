"""Softmax attention: CUDA kernels ``csrc/attention.cu`` and their plain twin.

Replaces ``mocopci_tpu/ops/pallas/attention.py``: ``fused_attention_pallas``
(:60).  f32 softmax over at most ``MAX_SEQ`` keys (the Pallas kernel's 4096,
lifted to the training attention's cap: with no dropout no counter bounds
it), in one pass over the keys under an online softmax (the training
attention's forward bodies without dropout or log-sum-exp).  Two routes,
each its own counted entry point, picked by the head dim D alone:
``attention`` up to ``MAX_ONE_PASS_D`` (FMAs), ``attention_wide`` above
(the products on the tensor cores at float32 grade).  Operations bound
both.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/attention.cu"
REPLACES = "mocopci_tpu/ops/pallas/attention.py:60"

MAX_SEQ = 16384     # as kernels/attention_train.py MAX_SEQ
MAX_ONE_PASS_D = 64     # the one-pass route's widest head (csrc kMaxFwdD)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(G, N, D), (G, M, D), (G, M, D) -> (G, N, D) f32."""
    attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * scale, dim=-1)
    return torch.matmul(attn, v)


def route(D: int) -> str:
    """The entry point that takes head dim D."""
    return "attention" if D <= MAX_ONE_PASS_D else "attention_wide"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q kᵀ · scale) v, eval only; the kernel on CUDA, the twin on the
    CPU.  The kernel has no backward, so on CUDA it refuses inputs that would
    need one (training takes ``attention_train``)."""
    if _lib.dispatch_device(q, k, v) == "cpu":
        return attention_plain(q, k, v, scale)
    _lib.refuse_grad("attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.check_cuda(f"attention {name}", t, torch.float32, 3)
    G, N, D = q.shape
    M = k.shape[1]
    if k.shape != (G, M, D) or v.shape != (G, M, D):
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not 1 <= M <= MAX_SEQ:
        raise ValueError(f"attention kernel covers 1 <= M <= {MAX_SEQ}, got {M}")
    out = torch.empty_like(q)
    _lib.launch(route(D), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                G, N, M, D, float(scale), _lib.stream(q))
    return out
