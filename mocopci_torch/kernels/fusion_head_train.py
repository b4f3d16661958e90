"""Train-mode fusion head: CUDA ``csrc/fusion_head_train_{fwd,bwd}.cu`` and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/fusion_head_train.py``: ``fusion_head_train``
(:319) with its stats (:356), output (:371) and backward (:408) sweeps.  Per
pair the MLP 4 -> 64 -> 64 -> 128 with train-mode BatchNorm (batch statistics
per frame group, eps 1e-3) and ReLU, then the max over channels; returns the
(G, P) logits and each layer's per-group (mean, biased var) for the running
statistics.  The kernel recomputes the layer chain in every sweep and stores
no (G, C, P) activation; its group and weight sums are reduced in a fixed
order.  The kernel forms the variance as E[z²] − mean² (in float64 on the
host, from float32 sums, as the TPU kernel does in float32); the twin as the
mean of squared deviations, as JAX's CPU path.  Operations bound it.  Both
the forward sweeps (``SOURCE``, warpgroup products: ``wgmma``) and the
backward sweeps (``SOURCE_BWD``, warp products: ``mma.sync``) run their
products on the tensor cores at float32 grade.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/fusion_head_train_fwd.cu"   # forward sweeps
SOURCE_BWD = "mocopci_torch/csrc/fusion_head_train_bwd.cu"   # backward sweeps
REPLACES = "mocopci_tpu/ops/pallas/fusion_head_train.py:319"
REPLACES_BWD = "mocopci_tpu/ops/pallas/fusion_head_train.py:408"   # backward sweeps

WIDTHS = (4, 64, 64, 128)
BLOCKS = 132          # every sweep: one 8-warp block per SM of an H100 (a fixed
                      # grid, which fixes the summation order)
_OFF = (0, 64, 128)   # each layer's column in the kernel's (F, 2, 256) stat rows
_MAX_SMEM = 227 * 1024


def _param_shapes():
    shapes = []
    for cin, c in zip(WIDTHS[:-1], WIDTHS[1:]):
        shapes += [(cin, c), (c,), (c,), (c,)]
    return shapes


def fusion_head_train_plain(x, params, n_groups: int, eps: float = 1e-3):
    """x (G, 4, P) frame-major planes, params (W1, b1, γ1, β1, ..., W3, b3, γ3, β3)
    with W (in, out) -> (o (G, P), ((mean, var) (F, C) per layer))."""
    h, stats, _ = fusion_head_train_channels(x, params, n_groups, eps)
    return h.amax(dim=1), stats


def fusion_head_train_channels(x, params, n_groups: int, eps: float = 1e-3):
    """The twin before its channel max: (h3 (G, 128, P), per-layer stats, and
    per pair the least |pre-activation| of the hidden layers (G, P), its
    distance from a ReLU kink)."""
    G, _, P = x.shape
    F, Bg = n_groups, G // n_groups
    h, stats, kink = x, [], None
    for layer in range(3):
        w, b, gamma, beta = params[4 * layer:4 * layer + 4]
        z = torch.einsum("gcp,cd->gdp", h, w) + b[:, None]
        C = z.shape[1]
        zg = z.reshape(F, Bg, C, P)
        mean = zg.mean(dim=(1, 3))
        var = ((zg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
        zh = (zg - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + eps)
        pre = (zh * gamma[:, None] + beta[:, None]).reshape(G, C, P)
        if layer < 2:
            m = pre.detach().abs().amin(dim=1)
            kink = m if kink is None else torch.minimum(kink, m)
        h = torch.relu(pre)
        stats.append((mean.detach(), var.detach()))
    return h, tuple(stats), kink


def fusion_head_train_bwd_plain(x, params, n_groups, eps, d_o):
    """(dx, 12 parameter grads) of :func:`fusion_head_train_plain` by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        o, _ = fusion_head_train_plain(leaves[0], leaves[1:], n_groups, eps)
        return torch.autograd.grad(o, leaves, d_o)


def _fwd_smem(F: int) -> int:
    """Bytes of shared memory of the largest forward sweep (sweep 2): the
    vectors (1024 floats), W2 and W3 split into hi and lo TF32 planes
    (24576), the (F, 2, 256) stat rows and 8 warps' (F, 2, 128) group sums."""
    return (1024 + 24576 + 2 * F * 256 + 8 * F * 2 * 128) * 4


def _bwd_smem(F: int) -> int:
    """Bytes of the largest backward sweep: the vectors (1024 floats), the
    weights with padded rows split into TF32 parts (three planes of 13312 in
    sweep 4; (hi, lo) pairs in sweeps 5-7, 25600), the stat and [Sa | Sb] rows,
    8 warps' group sums (128 wide in sweep 4, 64 in 5-6) and, in sweeps 5-7,
    two (128, 72) pair tiles."""
    sweep4 = 3 * 13312 + 8 * F * 2 * 128
    sweep56 = 25600 + 8 * F * 2 * 64 + 2 * 128 * 72
    return (1024 + 4 * F * 256 + max(sweep4, sweep56)) * 4


def _check(x, params, n_groups):
    _lib.check_cuda("fusion_head_train x", x, torch.float32, 3)
    for i, (t, want) in enumerate(zip(params, _param_shapes())):
        _lib.check_cuda(f"fusion_head_train param {i}", t, torch.float32, len(want))
        if tuple(t.shape) != want:
            raise ValueError(f"fusion_head_train kernel is built for widths {WIDTHS}; "
                             f"param {i} is {tuple(t.shape)}")
    G, C, P = x.shape
    if C != 4 or G % n_groups:
        raise ValueError(f"fusion_head_train: x {tuple(x.shape)} with {n_groups} groups")
    if max(_fwd_smem(n_groups), _bwd_smem(n_groups)) > _MAX_SMEM:
        raise ValueError(f"fusion_head_train kernel: {n_groups} groups exceed shared memory")
    return G, P


def _sweep(name, mode, x, packed, stats, extra, out, F, n_red):
    G, _, P = x.shape
    red = torch.empty(max(n_red, 1), dtype=torch.float32, device=x.device)
    partial = torch.empty(BLOCKS * max(n_red, 1), dtype=torch.float32, device=x.device)
    out_ptr = out.data_ptr() if out is not None else 0
    _lib.launch(name, x.data_ptr(), packed.data_ptr(), stats.data_ptr(),
                *(t.data_ptr() for t in extra), out_ptr, partial.data_ptr(), red.data_ptr(),
                mode, G, F, P, BLOCKS, _lib.stream(x))
    return red


def fusion_head_train_fwd(x, params, n_groups: int, eps: float = 1e-3):
    """Kernel forward: (o (G, P), per-layer (mean, var), stat rows for the backward)."""
    G, P = _check(x, params, n_groups)
    F = n_groups
    n = (G // F) * P
    packed = torch.cat([p.reshape(-1) for p in params])
    stats = torch.zeros((F, 2, 256), dtype=torch.float32, device=x.device)
    out_stats = []
    for layer, C in enumerate(WIDTHS[1:]):
        sums = _sweep("fusion_head_train_fwd", layer, x, packed, stats, (), None, F,
                      F * 2 * C).view(F, 2, C).double()
        mean = sums[:, 0] / n
        var = torch.clamp(sums[:, 1] / n - mean * mean, min=0.0)
        c0 = _OFF[layer]
        stats[:, 0, c0:c0 + C] = mean.float()
        stats[:, 1, c0:c0 + C] = torch.rsqrt(var + eps).float()
        out_stats.append((mean.float(), var.float()))
    o = torch.empty((G, P), dtype=torch.float32, device=x.device)
    _sweep("fusion_head_train_fwd", 3, x, packed, stats, (), o, F, 0)
    return o, tuple(out_stats), (packed, stats)


def fusion_head_train_bwd(x, params, n_groups, packed, stats, d_o):
    """Kernel backward: (dx, 12 parameter grads)."""
    G, P = _check(x, params, n_groups)
    F = n_groups
    bsum = torch.zeros((F, 2, 256), dtype=torch.float32, device=x.device)
    # each pair's routing (channel-max and ReLU masks, tie count), written by
    # the first backward sweep and read by the others
    route = torch.empty(G * P * 8, dtype=torch.int32, device=x.device)
    grads = [None] * 12
    dW = {}
    for layer, mode in ((2, 4), (1, 5), (0, 6)):
        C = WIDTHS[layer + 1]
        n_red = F * 2 * C + (0 if mode == 4 else WIDTHS[layer + 2] * C + WIDTHS[layer + 2])
        red = _sweep("fusion_head_train_bwd", mode, x, packed, stats, (bsum, d_o, route), None,
                     F, n_red)
        a, b_ = red[:F * 2 * C].view(F, 2, C).unbind(1)       # Σ dpre, Σ dpre·zh per group
        gamma = params[4 * layer + 2]
        c0 = _OFF[layer]
        bsum[:, 0, c0:c0 + C] = a * gamma
        bsum[:, 1, c0:c0 + C] = b_ * gamma
        grads[4 * layer + 2] = b_.sum(0)
        grads[4 * layer + 3] = a.sum(0)
        if mode != 4:
            nxt = layer + 1
            rest = red[F * 2 * C:]
            Cin, Cout = WIDTHS[nxt], WIDTHS[nxt + 1]
            dW[nxt] = (rest[:Cin * Cout].view(Cin, Cout), rest[Cin * Cout:])
    dx = torch.empty_like(x)
    red = _sweep("fusion_head_train_bwd", 7, x, packed, stats, (bsum, d_o, route), dx, F,
                 4 * 64 + 64)
    dW[0] = (red[:256].view(4, 64), red[256:])
    for layer in range(3):
        grads[4 * layer], grads[4 * layer + 1] = dW[layer]
    return (dx, *grads)


class _FusionHeadTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_groups, eps, *params):
        cpu = _lib.dispatch_device(x, *params) == "cpu"
        ctx.cpu, ctx.n_groups, ctx.eps = cpu, n_groups, eps
        if cpu:
            o, stats = fusion_head_train_plain(x, params, n_groups, eps)
            ctx.save_for_backward(x, *params)
        else:
            o, stats, (packed, st) = fusion_head_train_fwd(x, params, n_groups, eps)
            ctx.save_for_backward(x, *params, packed, st)
        flat = [t for pair in stats for t in pair]
        ctx.mark_non_differentiable(*flat)
        return (o, *flat)

    @staticmethod
    def backward(ctx, d_o, *_):
        saved = ctx.saved_tensors
        if ctx.cpu:
            x, *params = saved
            grads = fusion_head_train_bwd_plain(x, params, ctx.n_groups, ctx.eps, d_o)
        else:
            x, *params, packed, st = saved
            grads = fusion_head_train_bwd(x, params, ctx.n_groups, packed, st,
                                          d_o.contiguous())
        return (grads[0], None, None, *grads[1:])


def fusion_head_train(x, params, n_groups: int, eps: float = 1e-3):
    """(o (G, P), ((mean (F, C), var (F, C)) for each layer)); differentiable
    in x and the 12 params through o; the statistics carry no gradient."""
    o, *flat = _FusionHeadTrain.apply(x, int(n_groups), float(eps), *params)
    return o, tuple((flat[2 * i], flat[2 * i + 1]) for i in range(3))
