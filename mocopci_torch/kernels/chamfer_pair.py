"""Bidirectional 1-NN Chamfer keys: CUDA kernel ``csrc/chamfer_pair.cu`` and
its plain twin, plus the exact recompute around them.

Replaces the forward of ``mocopci_tpu/ops/pallas/chamfer_pair.py``:
``_pair_keys`` (:126) under ``chamfer_pair`` (:169).  One distance sweep gives
per query the least key over the reference cloud (``k12``) and per reference
point the least key over the queries (``k21``); a key is the squared
distance's float bits with the low ``bit_length(max(N, M) - 1)`` bits replaced
by the index.  The distance is ``fma(dz, dz, fma(dx, dx, dy * dy))``: the
contraction XLA's CPU compiler gives the Pallas kernel body, so the keys equal
the interpret-mode reference's bit for bit.  The twin emulates each fused
multiply-add in float64 (the product is exact there).  The kernel walks a
span of the reference cloud a block, the number of spans chosen to fill the
card at the call's G (:func:`launch_grid`).  Outside the kernel the
selected neighbour is gathered and its distance recomputed exactly, as in JAX.
Operations bound it.  The backward (:class:`_ChamferPair`) scatters through the
``scatter_add`` kernel at N, M % 128 == 0 and the ``onehot_scatter`` kernel
otherwise, as the JAX VJP does.
"""
from __future__ import annotations

import functools

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.scatter_add import scatter_add
from mocopci_torch.kernels.scatter_onehot import onehot_scatter_rows

SOURCE = "mocopci_torch/csrc/chamfer_pair.cu"
REPLACES = "mocopci_tpu/ops/pallas/chamfer_pair.py:126"

TQ, TM = 256, 1024      # the Pallas kernel's query and reference tiles
TS = TO = 512           # its backward's scatter tiles (source, output)
INF_KEY = 0x7F7FFFFF    # f32 max bit pattern
INT_MAX = 0x7FFFFFFF
# the kernel's tiling: queries a thread, threads a block (at most), reference
# points a chunk; an H100's SMs, and the threads an SM runs at once at the
# kernel's registers (86 a thread: one block of 512, two of 256)
QUERIES, MAX_THREADS, CHUNK = 8, 512, 64
SMS, SM_THREADS = 132, 512
# distance-matrix entries per chunk of the plain version
_CHUNK = 1 << 22


def supported(n: int, m: int) -> bool:
    """True when (N=n, M=m) clouds tile onto the Pallas kernel's grid; the JAX
    package (and so the port) takes two directed 1-NN queries otherwise."""
    for size, tile in ((n, TQ), (m, TM), (n, TS), (m, TS), (n, TO), (m, TO)):
        t = min(tile, size)
        if size % t or t % 8:
            return False
    return min(TM, m) % 128 == 0


def index_bits(n: int, m: int) -> int:
    return max((max(n, m) - 1).bit_length(), 1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c): the product is exact in float64, one rounding
    there, one to float32 (differs from a true fma only on a float64 result
    exactly halfway between two floats)."""
    return (a.double() * b.double() + c.double()).float()


def pair_distances(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """(G, N, M) squared distances as the kernel computes them."""
    dx, dy, dz = (pc1[:, :, None, c] - pc2[:, None, :, c] for c in range(3))
    return _fma(dz, dz, _fma(dx, dx, dy * dy))


def chamfer_pair_keys_plain(pc1: torch.Tensor, pc2: torch.Tensor):
    """(G, N, 3) x (G, M, 3) -> packed argmin keys (k12 (G, N), k21 (G, M))."""
    G, N, _ = pc1.shape
    M = pc2.shape[1]
    mask = (1 << index_bits(N, M)) - 1
    cols = torch.arange(M, dtype=torch.int32, device=pc1.device)
    k21 = torch.full((G, M), INF_KEY, dtype=torch.int32, device=pc1.device)
    k12 = []
    rows = max(1, _CHUNK // max(M, 1))
    for s in range(0, N, rows):
        hi = pair_distances(pc1[:, s:s + rows], pc2).view(torch.int32) & ~mask
        k12.append((hi | cols).amin(-1))
        qid = torch.arange(s, s + hi.shape[1], dtype=torch.int32, device=pc1.device)
        k21 = torch.minimum(k21, (hi | qid[:, None]).amin(1))
    return torch.cat(k12, dim=1), k21


@functools.lru_cache(maxsize=64)
def launch_grid(G: int, N: int, M: int, queries: int = QUERIES, max_threads: int = MAX_THREADS,
                sm_threads: int = SM_THREADS):
    """(threads, span, spans, query_blocks) of the kernel: a block holds
    ``queries`` queries a thread, up to ``queries`` x ``max_threads``
    (query_blocks of them cover N), and walks ``span`` chunks of 64 reference
    points, ``spans`` spans covering M.  The span is the one that minimises
    waves x (span + 1/2): the waves of the blocks the card holds at once
    (``sm_threads`` threads an SM), each as long as its longest span plus
    about half a chunk for a block's queries, first chunk and merges; the
    longest of equals (fewer spans, fewer merges of k12)."""
    threads = min(max_threads, 32 * -(-N // (32 * queries)))
    query_blocks = -(-N // (threads * queries))
    resident = SMS * (sm_threads // threads)
    chunks = -(-M // CHUNK)
    best = None
    for span in range(chunks, 0, -1):
        spans = -(-chunks // span)
        cost = -(-query_blocks * G * spans // resident) * (2 * span + 1)
        if best is None or cost < best[0]:
            best = (cost, span, spans)
    return threads, best[1], best[2], query_blocks


def chamfer_pair_keys(pc1: torch.Tensor, pc2: torch.Tensor):
    """Packed argmin keys; the kernel on CUDA, the twin on the CPU."""
    if _lib.dispatch_device(pc1, pc2) == "cpu":
        return chamfer_pair_keys_plain(pc1, pc2)
    _lib.check_cuda("chamfer_pair pc1", pc1, torch.float32, 3)
    _lib.check_cuda("chamfer_pair pc2", pc2, torch.float32, 3)
    G, N, C = pc1.shape
    M = pc2.shape[1]
    if C != 3 or pc2.shape[0] != G or pc2.shape[2] != 3 or N < 1 or M < 1:
        raise ValueError(f"chamfer_pair: shapes {tuple(pc1.shape)} vs {tuple(pc2.shape)}")
    threads, span, spans, query_blocks = launch_grid(G, N, M)
    # an output more than one block writes is merged by atomicMin: filled first
    dev = pc1.device
    k12 = (torch.full((G, N), INT_MAX, dtype=torch.int32, device=dev) if spans > 1
           else torch.empty((G, N), dtype=torch.int32, device=dev))
    k21 = (torch.full((G, M), INF_KEY, dtype=torch.int32, device=dev) if query_blocks > 1
           else torch.empty((G, M), dtype=torch.int32, device=dev))
    _lib.launch("chamfer_pair", pc1.data_ptr(), pc2.data_ptr(), G, N, M, index_bits(N, M),
                threads, span, k12.data_ptr(), k21.data_ptr(), _lib.stream(pc1))
    return k12, k21


class _ChamferPair(torch.autograd.Function):
    """The VJP of ``mocopci_tpu/ops/pallas/chamfer_pair.py`` (:180-232): with
    v12 = 2·g12·diff12 and v21 = 2·g21·diff21, d_pc1 = v12 − scatter(v21 → i21)
    and d_pc2 = v21 − scatter(v12 → i12), each scatter deterministic: the
    ``scatter_add`` kernel at N, M % 128 == 0 (the JAX package's
    ``bucket_scatter_add``), else ``onehot_scatter_rows`` (its one-hot
    scatter, :224-228)."""

    @staticmethod
    def forward(ctx, pc1, pc2):
        k12, k21 = chamfer_pair_keys(pc1, pc2)
        mask = (1 << index_bits(pc1.shape[1], pc2.shape[1])) - 1
        i12, i21 = k12 & mask, k21 & mask
        diff12 = pc1 - _lib.group_rows(pc2, i12)
        diff21 = pc2 - _lib.group_rows(pc1, i21)
        ctx.save_for_backward(diff12, diff21, i12, i21)
        return (diff12 * diff12).sum(-1), (diff21 * diff21).sum(-1)

    @staticmethod
    def backward(ctx, g12, g21):
        diff12, diff21, i12, i21 = ctx.saved_tensors
        v12 = (2.0 * g12)[..., None] * diff12
        v21 = (2.0 * g21)[..., None] * diff21
        N, M = diff12.shape[1], diff21.shape[1]
        v12, v21 = v12.contiguous(), v21.contiguous()
        if N % 128 == 0 and M % 128 == 0:
            return v12 - scatter_add(v21, i21, N), v21 - scatter_add(v12, i12, M)
        s21 = onehot_scatter_rows(v21, i21, N)               # (G, 3, N)
        s12 = onehot_scatter_rows(v12, i12, M)               # (G, 3, M)
        return v12 - s21.transpose(1, 2), v21 - s12.transpose(1, 2)


def chamfer_pair(pc1: torch.Tensor, pc2: torch.Tensor):
    """Both directed per-point min squared distances (d12 (G, N), d21 (G, M)),
    exact for the selected neighbours (near ties within the key quantisation
    may select a marginally farther one, as in JAX); differentiable."""
    return _ChamferPair.apply(pc1.float().contiguous(), pc2.float().contiguous())
