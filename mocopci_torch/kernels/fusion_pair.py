"""Fusion head pair kernel: CUDA ``csrc/fusion_pair.cu`` and its plain twin.

One kernel replaces three TPU kernels: ``gather_planes.py``
``bucket_gather_pair_planes`` (:87), the ``fusion_planes.py``
``build_pair_planes`` forward (:148) and ``fusion_head.py``
``fusion_head_pallas`` (:66).  Pairs are k-major, p = j·N + n.  BatchNorm is
folded into the dense weights on the host (:func:`fold_bn_dense`).
Operations bound it: the kernel runs the train head's layer chain on the
tensor cores at float32 grade (``csrc/fusion_head.cuh``), a fixed grid of
blocks (chosen in the C entry) walking units of 128 queries × up to 8
neighbour slots, each unit gathering its own pair rows.  The train path
takes the planes alone (:func:`fusion_pair_planes`, the same gather stage as
a second entry of the source; bytes bound it) and scores them with
``fusion_head_train``.

:func:`build_pair_planes` is ``mocopci_tpu/ops/pallas/fusion_planes.py``
``build_pair_planes`` on rows the caller has gathered, differentiable: the
``pair_planes_rows`` entry for its forward (:148) and ``pair_planes_bwd`` for
its own backward kernel (:112, :165), both bound by bytes.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.scatter_add import scatter_add

SOURCE = "mocopci_torch/csrc/fusion_pair.cu"
REPLACES = "mocopci_tpu/ops/pallas/gather_planes.py:87; mocopci_tpu/ops/pallas/fusion_planes.py:148; mocopci_tpu/ops/pallas/fusion_head.py:66"
REPLACES_PLANES = "mocopci_tpu/ops/pallas/gather_planes.py:87"
REPLACES_ROWS = "mocopci_tpu/ops/pallas/fusion_planes.py:148"
REPLACES_BWD = "mocopci_tpu/ops/pallas/fusion_planes.py:165"

EPS = 1e-20  # under the sqrt, as the JAX package
WIDTHS = (4, 64, 64, 128)


def fold_bn_dense(weight, bias, scale, bn_bias, mean, var, eps):
    """Fold eval BatchNorm into the preceding dense layer; weight is (in, out).

    ((x W + b) - mean) * rsqrt(var + eps) * scale + bn_bias
      = x (W s) + ((b - mean) s + bn_bias),  s = scale * rsqrt(var + eps)
    """
    s = scale * torch.rsqrt(var + eps)
    return weight * s[None, :], (bias - mean) * s + bn_bias


def pair_planes(points2, idx, points1):
    """(G, N2, 3), (G, N, K2), (G, N, 3) -> (G, 4, N·K2) [resi_xyz, dist] planes."""
    G, N, K2 = idx.shape
    off = torch.arange(G, device=idx.device).view(G, 1, 1) * points2.shape[1]
    flat = (idx.long() + off).transpose(1, 2).reshape(-1)             # k-major
    nbr = points2.reshape(-1, 3)[flat].reshape(G, K2 * N, 3).transpose(1, 2)
    resi = nbr - points1.transpose(1, 2).repeat(1, 1, K2)
    dist = torch.sqrt(torch.sum(resi * resi, dim=1, keepdim=True) + EPS)
    return torch.cat([resi, dist], dim=1)


def fusion_pair_plain(points2, idx, points1, w1, b1, w2, b2, w3, b3):
    """Returns (planes (G, 4, P), logits (G, P)), P = N·K2."""
    planes = pair_planes(points2, idx, points1)
    h = planes
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = torch.relu(torch.einsum("gcp,cd->gdp", h, w) + b[:, None])
    return planes, h.amax(dim=1)


def _check_points(points2, idx, points1, name):
    _lib.check_cuda(f"{name} points2", points2, torch.float32, 3)
    _lib.check_cuda(f"{name} idx", idx, torch.int32, 3)
    _lib.check_cuda(f"{name} points1", points1, torch.float32, 3)
    G, N, K2 = idx.shape
    N2 = points2.shape[1]
    if points2.shape != (G, N2, 3) or points1.shape != (G, N, 3):
        raise ValueError(f"{name}: inconsistent shapes")
    return G, N, N2, K2


def fusion_pair_planes_kernel(points2, idx, points1):
    """The planes-only kernel entry: (G, 4, N·K2) on the card."""
    G, N, N2, K2 = _check_points(points2, idx, points1, "fusion_pair_planes")
    planes = torch.empty((G, 4, N * K2), dtype=torch.float32, device=points2.device)
    _lib.launch("fusion_pair_planes", points2.data_ptr(), idx.data_ptr(), points1.data_ptr(),
                planes.data_ptr(), G, N, N2, K2, _lib.stream(points2))
    return planes


class _PairPlanes(torch.autograd.Function):
    """The train path's planes with the backward of ``_gpp_bwd``
    (``mocopci_tpu/ops/pallas/fusion_planes.py:253-267``): d_resi = dx[0:3] +
    dx[3]·resi/dist, d_points2 through the ``scatter_add`` kernel (plane
    form), d_points1 = −Σ_j d_resi over the k-major neighbour slots."""

    @staticmethod
    def forward(ctx, points2, idx, points1):
        if _lib.dispatch_device(points2, idx, points1) == "cpu":
            planes = pair_planes(points2, idx, points1)
        else:
            planes = fusion_pair_planes_kernel(points2, idx, points1)
        ctx.save_for_backward(planes, idx)
        ctx.n2 = points2.shape[1]
        return planes

    @staticmethod
    def backward(ctx, dx):
        planes, idx = ctx.saved_tensors
        G, N, K2 = idx.shape
        d_resi = dx[:, 0:3] + dx[:, 3:4] * (planes[:, 0:3] / planes[:, 3:4])   # (G, 3, P)
        idx_km = idx.transpose(1, 2).reshape(G, K2 * N).contiguous()
        d_p2 = scatter_add(d_resi.contiguous(), idx_km, ctx.n2, planes=True)
        d_p1 = -d_resi.reshape(G, 3, K2, N).sum(dim=2).transpose(1, 2)
        return d_p2, None, d_p1


def fusion_pair_planes(points2, idx, points1):
    """(G, N2, 3), (G, N, K2) int32, (G, N, 3) -> (G, 4, N·K2) [resi, dist]
    planes, k-major; the kernel on CUDA, the twin on the CPU; differentiable
    in both clouds."""
    return _PairPlanes.apply(points2, idx, points1)


def fusion_pair(points2, idx, points1, w1, b1, w2, b2, w3, b3):
    """Eval only (BatchNorm folded): the kernel on CUDA, the twin on the CPU.
    The kernel has no backward, so on CUDA it refuses inputs that would need one."""
    weights = (w1, b1, w2, b2, w3, b3)
    if _lib.dispatch_device(points2, idx, points1, *weights) == "cpu":
        return fusion_pair_plain(points2, idx, points1, *weights)
    _lib.refuse_grad("fusion_pair", points2, points1, *weights)
    G, N, N2, K2 = _check_points(points2, idx, points1, "fusion_pair")
    for i, t in enumerate(weights):
        layer = i // 2
        want = (WIDTHS[layer], WIDTHS[layer + 1]) if i % 2 == 0 else (WIDTHS[layer + 1],)
        _lib.check_cuda(f"fusion_pair weight {i}", t, torch.float32, len(want))
        if tuple(t.shape) != want:
            raise ValueError(f"fusion_pair kernel is built for widths {WIDTHS}; "
                             f"weight {i} is {tuple(t.shape)}")
    P = N * K2
    planes = torch.empty((G, 4, P), dtype=torch.float32, device=points2.device)
    logits = torch.empty((G, P), dtype=torch.float32, device=points2.device)
    _lib.launch("fusion_pair", points2.data_ptr(), idx.data_ptr(), points1.data_ptr(),
                *(t.data_ptr() for t in weights), planes.data_ptr(), logits.data_ptr(),
                G, N, N2, K2, _lib.stream(points2))
    return planes, logits


def build_pair_planes_plain(nbr, p1t):
    """(G, P, 3) k-major neighbour rows + (G, 3, N) query planes -> (G, 4, P)
    ``[resi, dist]`` planes (``build_pair_planes_xla``, fusion_planes.py:273)."""
    k2 = nbr.shape[1] // p1t.shape[2]
    resi = nbr.transpose(1, 2) - p1t.repeat(1, 1, k2)
    dist = torch.sqrt(torch.sum(resi * resi, dim=1, keepdim=True) + EPS)
    return torch.cat([resi, dist], dim=1)


def build_pair_planes_bwd_plain(nbr, p1t, dx):
    """The VJP of :func:`build_pair_planes_plain` as the TPU backward kernel
    forms it: (d_nbr (G, P, 3), d_p1t (G, 3, N))."""
    G, _, N = p1t.shape
    x = build_pair_planes_plain(nbr, p1t)
    d_resi = dx[:, 0:3] + dx[:, 3:4] * (x[:, 0:3] / x[:, 3:4])            # (G, 3, P)
    return d_resi.transpose(1, 2), -d_resi.reshape(G, 3, -1, N).sum(dim=2)


def _check_rows(nbr, p1t):
    G, P, _ = nbr.shape
    N = p1t.shape[2]
    if N % 128 != 0:
        raise ValueError(f"build_pair_planes needs N % 128 == 0, got N={N}; "
                         "use build_pair_planes_plain for tiny shapes")
    if nbr.shape[2] != 3 or p1t.shape[:2] != (G, 3) or P % N:
        raise ValueError(f"build_pair_planes: nbr {tuple(nbr.shape)}, p1t {tuple(p1t.shape)}")
    return G, N, P // N


def pair_planes_rows_kernel(nbr, p1t):
    """The forward entry on the card: (G, 4, P) planes."""
    G, N, K2 = _check_rows(nbr, p1t)
    _lib.check_cuda("pair_planes_rows nbr", nbr, torch.float32, 3)
    _lib.check_cuda("pair_planes_rows p1t", p1t, torch.float32, 3)
    planes = torch.empty((G, 4, N * K2), dtype=torch.float32, device=nbr.device)
    _lib.launch("pair_planes_rows", nbr.data_ptr(), p1t.data_ptr(), planes.data_ptr(), G, N, K2,
                _lib.stream(nbr))
    return planes


def pair_planes_bwd_kernel(nbr, p1t, dx):
    """The backward entry on the card: (d_nbr (G, P, 3), d_p1t (G, 3, N))."""
    G, N, K2 = _check_rows(nbr, p1t)
    for name, t in (("nbr", nbr), ("p1t", p1t), ("dx", dx)):
        _lib.check_cuda(f"pair_planes_bwd {name}", t, torch.float32, 3)
    if dx.shape != (G, 4, N * K2):
        raise ValueError(f"pair_planes_bwd: dx {tuple(dx.shape)} for nbr {tuple(nbr.shape)}")
    d_nbr = torch.empty_like(nbr)
    d_p1t = torch.empty_like(p1t)
    _lib.launch("pair_planes_bwd", nbr.data_ptr(), p1t.data_ptr(), dx.data_ptr(),
                d_nbr.data_ptr(), d_p1t.data_ptr(), G, N, K2, _lib.stream(nbr))
    return d_nbr, d_p1t


class _BuildPairPlanes(torch.autograd.Function):
    """``build_pair_planes`` with the TPU kernel's own backward (``_bpp_bwd``,
    fusion_planes.py:165-182): the kernels on the card, the plain versions on
    the CPU."""

    @staticmethod
    def forward(ctx, nbr, p1t):
        _check_rows(nbr, p1t)
        ctx.save_for_backward(nbr, p1t)
        if _lib.dispatch_device(nbr, p1t) == "cpu":
            return build_pair_planes_plain(nbr, p1t)
        return pair_planes_rows_kernel(nbr, p1t)

    @staticmethod
    def backward(ctx, dx):
        nbr, p1t = ctx.saved_tensors
        if _lib.dispatch_device(nbr, p1t, dx) == "cpu":
            return build_pair_planes_bwd_plain(nbr, p1t, dx)
        return pair_planes_bwd_kernel(nbr, p1t, dx.float().contiguous())


def build_pair_planes(nbr, p1t):
    """(G, P, 3) k-major neighbour rows + (G, 3, N) query planes -> (G, 4, P)
    ``[resi, dist]`` pair planes, differentiable in both; N % 128 == 0."""
    return _BuildPairPlanes.apply(nbr.float().contiguous(), p1t.float().contiguous())
