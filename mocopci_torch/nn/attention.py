"""Attention modules, eval branches (port of ``mocopci_tpu/nn/attention.py``).

  - ``CrossAttention`` / ``Injector`` / ``Extractor`` / ``EICrossformer``:
    the extrapolation+injection fusion.
  - ``CrossFrameBlock``: heads-as-frames one-shot frame synthesis at L3.
  - ``MultiFrameBlock``: the L2/L1 time-token decoder stage against the
    time-reversed token sequence.

Softmax attention with at most ``MAX_SEQ`` keys runs in the ``attention``
kernel (CUDA) or its twin (CPU); longer sequences use the plain
query-chunked form.  Dropout and stochastic depth are identities in eval.
"""
from __future__ import annotations

import torch
from torch import nn

from mocopci_torch.kernels import attention as attention_kernel
from mocopci_torch.kernels.attention import MAX_SEQ
from mocopci_torch.nn.basic import Dense, EasyMlp, FrameBatchNorm, Mlp, MlpT

# above this many entries per (batch, frame, head) the long-sequence path
# chunks the queries
_DENSE_ATTN_LIMIT = 8 * 1024 * 1024


def _fused_sdpa(q, k, v, scale):
    """Softmax attention in (..., N, H, D) layout through the kernel."""
    lead = q.shape[:-3]
    N, H, D = q.shape[-3:]
    M = k.shape[-3]

    def to_g(x, L):
        return x.movedim(-2, -3).reshape(-1, L, D).float().contiguous()

    out = attention_kernel(to_g(q, N), to_g(k, M), to_g(v, M), scale)
    return out.reshape(lead + (H, N, D)).movedim(-3, -2)


def _dense_mha(q, k, v, scale):
    """Plain softmax attention in (..., N, H, D) layout (M > MAX_SEQ)."""
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

    def forward(self, x, c):
        B, N, C = x.shape
        M = c.shape[1]
        H = self.num_heads
        hd = C // H
        kv = self.kv(c).reshape(B, M, 2, H, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        q = self.q(x).reshape(B, N, H, hd)
        sdpa = _fused_sdpa if M <= MAX_SEQ else _dense_mha
        out = sdpa(q, k, v, hd ** -0.5).reshape(B, N, C)
        return self.proj(out)


class Injector(nn.Module):
    """LayerNorm'd cross attention scaled by a learnable ``gamma``."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = CrossAttention(dim, num_heads)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, query, feat):
        return self.gamma * self.attn(self.query_norm(query), self.feat_norm(feat))


class Extractor(nn.Module):
    """Cross attention + FFN; returns the FFN output only."""

    def __init__(self, dim: int, num_heads: int = 8, cffn_ratio: float = 0.25):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = CrossAttention(dim, num_heads)
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = Mlp(dim, int(dim * cffn_ratio), dim)

    def forward(self, x1, x2):
        query = x1 + self.attn(self.query_norm(x1), self.feat_norm(x2))
        return self.ffn(self.ffn_norm(query))


class EICrossformer(nn.Module):
    """Extrapolation+injection fusion producing one shared (B, N, C) feature."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.injector = Injector(dim, num_heads)
        self.extractor = Extractor(dim, num_heads)
        self.pj = Dense(2 * dim, dim, bias=False)

    def forward(self, x1, x2):
        res1 = self.injector(x1, x2)
        res2 = self.extractor(x2, x1)
        return self.pj(torch.cat([res1, res2], dim=-1))


class CrossFrameBlock(nn.Module):
    """L3 one-shot frame synthesis: xs (B, 2, N, C) -> (feats (B, 3, N, C),
    frames (B, 3, N, 3)); 4 full-width heads whose outputs, summed over the
    two input frames, become 4 candidate frames, head 0 dropped."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = FrameBatchNorm(dim)
        self.attn_q = Dense(dim, dim * num_heads, init_std=0.02)
        self.attn_kv = Dense(dim, 2 * dim * num_heads, init_std=0.02)
        self.attn_proj = Dense(dim, dim, init_std=0.02)
        self.trans_block_2 = EasyMlp(dim, int(dim * mlp_ratio), dim)
        self.mapping_xyz = Dense(dim, 3, init_std=0.02)

    def forward(self, xs):
        B, F, N, C = xs.shape
        H = self.num_heads
        x = self.norm1(xs)
        x_rev = torch.flip(x, dims=(1,))
        M = x_rev.shape[2]
        q = self.attn_q(x).reshape(B, F, N, H, C)
        kv = self.attn_kv(x_rev).reshape(B, F, M, 2, H, C)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
        sdpa = _fused_sdpa if M <= MAX_SEQ else _dense_mha
        out = sdpa(q, k, v, C ** -0.5)                     # (B, F, N, H, C)
        out = out.sum(dim=1).transpose(1, 2)               # (B, H, N, C)
        feats = self.trans_block_2(self.attn_proj(out))
        frames = self.mapping_xyz(feats)
        return feats[:, 1:], frames[:, 1:]


class MultiFrameBlock(nn.Module):
    """L2/L1 time-token stage: xs (B, 5, N, C) -> (feats (B, 3, N, latent),
    frames (B, 3, N, 3)) for the middle tokens."""

    def __init__(self, dim: int, latent: int, num_heads: int = 8, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = FrameBatchNorm(dim)
        self.attn_q = Dense(dim, dim, init_std=0.02)
        self.attn_kv = Dense(dim, 2 * dim, init_std=0.02)
        self.attn_proj = Dense(dim, dim, init_std=0.02)
        self.norm2 = FrameBatchNorm(dim)
        self.mlp = MlpT(dim, int(dim * mlp_ratio), dim)
        self.trans_block = MlpT(dim, int(dim * mlp_ratio), latent)
        self.mapping_xyz = Dense(latent, 3, init_std=0.02)

    def forward(self, xs):
        B, F, N, C = xs.shape
        H = self.num_heads
        hd = C // H
        x_norm = self.norm1(xs)
        x_rev = torch.flip(x_norm, dims=(1,))
        M = x_rev.shape[2]
        q = self.attn_q(x_norm).reshape(B, F, N, H, hd)
        kv = self.attn_kv(x_rev).reshape(B, F, M, 2, H, hd)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
        if M <= MAX_SEQ:
            out = _fused_sdpa(q, k, v, hd ** -0.5)
        elif N * M > _DENSE_ATTN_LIMIT:
            out = _chunked_mha(q, k, v, hd ** -0.5)
        else:
            out = _dense_mha(q, k, v, hd ** -0.5)
        out = self.attn_proj(out.reshape(B, F, N, C))
        x_norm = x_norm + out
        x = xs + self.mlp(self.norm2(x_norm))              # residual on the raw input
        x_f = self.trans_block(x)
        frames = self.mapping_xyz(x_f)
        return x_f[:, 1:-1], frames[:, 1:-1]
