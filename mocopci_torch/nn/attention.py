"""Attention modules (port of ``mocopci_tpu/nn/attention.py``).

  - ``CrossAttention`` / ``Injector`` / ``Extractor`` / ``EICrossformer``:
    the extrapolation+injection fusion.
  - ``CrossFrameBlock``: heads-as-frames one-shot frame synthesis at L3.
  - ``MultiFrameBlock``: the L2/L1 time-token decoder stage against the
    time-reversed token sequence.

Eval softmax attention runs in the ``attention`` kernel on the card up to
its ``MAX_SEQ`` keys, and in its twin on the CPU up to ``PLAIN_MAX_SEQ``
(4096, where JAX's Pallas path stops); longer sequences use the plain
query-chunked form.  In train mode (``train=True``) every attention runs in
the ``attention_train`` kernel with its backward (its twin on the CPU), up
to its ``MAX_SEQ`` keys, with the dropout seed drawn per call from ``rng``
(rate 0 and seed 0 without one).  Past 4096 keys JAX trains through its
chunked XLA path (``_chunked_mha_dropout``), whose mask is drawn by
``jax.random`` and not by the kernel's counter hash: there the two packages
agree at rate 0 only.
"""
from __future__ import annotations

import torch
from torch import nn

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels import attention as attention_kernel
from mocopci_torch.kernels import attention_train
from mocopci_torch.kernels.attention import MAX_SEQ
from mocopci_torch.nn.basic import Dense, EasyMlp, FrameBatchNorm, Mlp, MlpT, drop_path, dropout

# above this many entries per (batch, frame, head) the long-sequence path
# chunks the queries
_DENSE_ATTN_LIMIT = 8 * 1024 * 1024
# the eval twin's keys on the CPU (the Pallas kernel's MAX_SEQ); above, the
# plain query-chunked form, as JAX's dense einsum and chunked map
PLAIN_MAX_SEQ = 4096


def _eval_fused(q, M: int) -> bool:
    """Whether eval attention over M keys takes the ``attention`` entry: the
    kernel on the card up to ``MAX_SEQ`` keys, its twin on the CPU up to
    ``PLAIN_MAX_SEQ``."""
    return M <= (MAX_SEQ if _lib.dispatch_device(q) == "cuda" else PLAIN_MAX_SEQ)


def _to_g(x, L, D):
    """(..., L, H, D) -> (G, L, D), G = (...)·H, the TPU kernels' group order."""
    return x.movedim(-2, -3).reshape(-1, L, D).float().contiguous()


def _fused_sdpa(q, k, v, scale):
    """Softmax attention in (..., N, H, D) layout through the kernel."""
    lead = q.shape[:-3]
    N, H, D = q.shape[-3:]
    M = k.shape[-3]
    out = attention_kernel(_to_g(q, N, D), _to_g(k, M, D), _to_g(v, M, D), scale)
    return out.reshape(lead + (H, N, D)).movedim(-3, -2)


def _dropout_seed(rate: float, rng, device) -> torch.Tensor:
    """The int32 seed of one train attention call, drawn on the device (0 when
    there is no dropout), as ``_dropout_seed`` draws it per call in JAX."""
    if rate <= 0.0 or rng is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=rng, device=device,
                         dtype=torch.int32)


def _sdpa_train(q, k, v, scale, rate, rng):
    """Train attention with dropout on the softmax matrix, (..., N, H, D)
    layout, through the ``attention_train`` kernel and its backward."""
    lead = q.shape[:-3]
    N, H, D = q.shape[-3:]
    M = k.shape[-3]
    if rng is None:
        rate = 0.0
    seed = _dropout_seed(rate, rng, q.device)
    out = attention_train(_to_g(q, N, D), _to_g(k, M, D), _to_g(v, M, D), seed, scale, rate)
    return out.reshape(lead + (H, N, D)).movedim(-3, -2)


def _dense_mha(q, k, v, scale):
    """Plain softmax attention in (..., N, H, D) layout (past the fused cap)."""
    attn = torch.softmax(torch.einsum("...nhd,...mhd->...hnm", q, k) * scale, dim=-1)
    return torch.einsum("...hnm,...mhd->...nhd", attn, v)


def _chunked_mha(q, k, v, scale):
    """Memory-bounded exact attention over query chunks, (B, F, N, H, D)."""
    N = q.shape[2]
    chunk = max(_DENSE_ATTN_LIMIT // k.shape[2], 128)
    if N <= chunk:
        return _dense_mha(q, k, v, scale)
    return torch.cat([_dense_mha(q[:, :, s:s + chunk], k, v, scale)
                      for s in range(0, N, chunk)], dim=2)


class CrossAttention(nn.Module):
    """Multi-head cross attention: queries x (B, N, C), context c (B, M, C)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=False)
        self.kv = Dense(dim, 2 * dim, bias=False)
        self.proj = Dense(dim, dim)

    def forward(self, x, c, train: bool = False):
        """The EI attention has no dropout (rate 0 in the reference)."""
        B, N, C = x.shape
        M = c.shape[1]
        H = self.num_heads
        hd = C // H
        kv = self.kv(c).reshape(B, M, 2, H, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        q = self.q(x).reshape(B, N, H, hd)
        if train:
            out = _sdpa_train(q, k, v, hd ** -0.5, 0.0, None)
        else:
            sdpa = _fused_sdpa if _eval_fused(q, M) else _dense_mha
            out = sdpa(q, k, v, hd ** -0.5)
        return self.proj(out.reshape(B, N, C))


class Injector(nn.Module):
    """LayerNorm'd cross attention scaled by a learnable ``gamma``."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = CrossAttention(dim, num_heads)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, query, feat, train: bool = False):
        return self.gamma * self.attn(self.query_norm(query), self.feat_norm(feat), train)


class Extractor(nn.Module):
    """Cross attention + FFN; returns the FFN output only."""

    def __init__(self, dim: int, num_heads: int = 8, cffn_ratio: float = 0.25):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = CrossAttention(dim, num_heads)
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = Mlp(dim, int(dim * cffn_ratio), dim)

    def forward(self, x1, x2, train: bool = False):
        query = x1 + self.attn(self.query_norm(x1), self.feat_norm(x2), train)
        return self.ffn(self.ffn_norm(query))


class EICrossformer(nn.Module):
    """Extrapolation+injection fusion producing one shared (B, N, C) feature."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.injector = Injector(dim, num_heads)
        self.extractor = Extractor(dim, num_heads)
        self.pj = Dense(2 * dim, dim, bias=False)

    def forward(self, x1, x2, train: bool = False):
        res1 = self.injector(x1, x2, train)
        res2 = self.extractor(x2, x1, train)
        return self.pj(torch.cat([res1, res2], dim=-1))


class CrossFrameBlock(nn.Module):
    """L3 one-shot frame synthesis: xs (B, 2, N, C) -> (feats (B, 3, N, C),
    frames (B, 3, N, 3)); 4 full-width heads whose outputs, summed over the
    two input frames, become 4 candidate frames, head 0 dropped."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: float = 4.0,
                 drop: float = 0.05, attn_drop: float = 0.05):
        super().__init__()
        self.num_heads = num_heads
        self.drop = drop
        self.attn_drop = attn_drop
        self.norm1 = FrameBatchNorm(dim)
        self.attn_q = Dense(dim, dim * num_heads, init_std=0.02)
        self.attn_kv = Dense(dim, 2 * dim * num_heads, init_std=0.02)
        self.attn_proj = Dense(dim, dim, init_std=0.02)
        self.trans_block_2 = EasyMlp(dim, int(dim * mlp_ratio), dim, drop)
        self.mapping_xyz = Dense(dim, 3, init_std=0.02)

    def forward(self, xs, train: bool = False, rng=None):
        B, F, N, C = xs.shape
        H = self.num_heads
        x = self.norm1(xs, train)
        x_rev = torch.flip(x, dims=(1,))
        M = x_rev.shape[2]
        q = self.attn_q(x).reshape(B, F, N, H, C)
        kv = self.attn_kv(x_rev).reshape(B, F, M, 2, H, C)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
        if train:
            out = _sdpa_train(q, k, v, C ** -0.5, self.attn_drop, rng)
        else:
            sdpa = _fused_sdpa if _eval_fused(q, M) else _dense_mha
            out = sdpa(q, k, v, C ** -0.5)                 # (B, F, N, H, C)
        out = out.sum(dim=1).transpose(1, 2)               # (B, H, N, C)
        out = dropout(self.attn_proj(out), self.drop, rng)
        feats = self.trans_block_2(out, rng)
        frames = self.mapping_xyz(feats)
        return feats[:, 1:], frames[:, 1:]


class MultiFrameBlock(nn.Module):
    """L2/L1 time-token stage: xs (B, 5, N, C) -> (feats (B, 3, N, latent),
    frames (B, 3, N, 3)) for the middle tokens."""

    def __init__(self, dim: int, latent: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 drop: float = 0.05, attn_drop: float = 0.05, drop_path: float = 0.04):
        super().__init__()
        self.num_heads = num_heads
        self.drop = drop
        self.attn_drop = attn_drop
        self.drop_path = drop_path
        self.norm1 = FrameBatchNorm(dim)
        self.attn_q = Dense(dim, dim, init_std=0.02)
        self.attn_kv = Dense(dim, 2 * dim, init_std=0.02)
        self.attn_proj = Dense(dim, dim, init_std=0.02)
        self.norm2 = FrameBatchNorm(dim)
        self.mlp = MlpT(dim, int(dim * mlp_ratio), dim, drop)
        self.trans_block = MlpT(dim, int(dim * mlp_ratio), latent, drop)
        self.mapping_xyz = Dense(latent, 3, init_std=0.02)

    def forward(self, xs, train: bool = False, rng=None):
        B, F, N, C = xs.shape
        H = self.num_heads
        hd = C // H
        x_norm = self.norm1(xs, train)
        x_rev = torch.flip(x_norm, dims=(1,))
        M = x_rev.shape[2]
        q = self.attn_q(x_norm).reshape(B, F, N, H, hd)
        kv = self.attn_kv(x_rev).reshape(B, F, M, 2, H, hd)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
        if train:
            out = _sdpa_train(q, k, v, hd ** -0.5, self.attn_drop, rng)
        elif _eval_fused(q, M):
            out = _fused_sdpa(q, k, v, hd ** -0.5)
        elif N * M > _DENSE_ATTN_LIMIT:
            out = _chunked_mha(q, k, v, hd ** -0.5)
        else:
            out = _dense_mha(q, k, v, hd ** -0.5)
        out = dropout(self.attn_proj(out.reshape(B, F, N, C)), self.drop, rng)
        x_norm = x_norm + drop_path(out, self.drop_path, rng)
        x_back = drop_path(self.mlp(self.norm2(x_norm, train), rng), self.drop_path, rng)
        x = xs + x_back                                    # residual on the raw input
        x_f = self.trans_block(x, rng)
        frames = self.mapping_xyz(x_f)
        return x_f[:, 1:-1], frames[:, 1:-1]
