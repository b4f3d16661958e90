"""Farthest point sampling: CUDA kernel ``csrc/fps.cu`` and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/fps.py``: ``farthest_point_sample_pallas``
(:419) and ``farthest_point_sample_pyramid_pallas`` (:477).  One block per
cloud; the step chain, not bytes or flops, bounds it (see the source note).
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/fps.cu"
REPLACES = "mocopci_tpu/ops/pallas/fps.py:477; mocopci_tpu/ops/pallas/fps.py:419"

MAX_N = 8192


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32: index 0 first, min-distance init 1e10,
    first argmax on ties; squared distance as ((dx*dx + dy*dy) + dz*dz)."""
    B, N, _ = xyz.shape
    x = xyz.float()
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    mind = torch.full((B, N), 1e10, dtype=torch.float32, device=x.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=x.device)
    last = torch.zeros((B, 1), dtype=torch.long, device=x.device)
    for s in range(1, npoint):
        dx = px - px.gather(1, last)
        dy = py - py.gather(1, last)
        dz = pz - pz.gather(1, last)
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(mind, dim=1, keepdim=True)   # first max on ties
        out[:, s] = last[:, 0].to(torch.int32)
    return out


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (B, npoint) int32; the kernel on CUDA, the twin on the CPU."""
    if _lib.dispatch_device(xyz) == "cpu":
        return fps_plain(xyz, npoint)
    _lib.check_cuda("fps xyz", xyz, torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3:
        raise ValueError(f"fps: expected (B, N, 3), got {tuple(xyz.shape)}")
    if not 1 <= npoint <= N or N > MAX_N:
        raise ValueError(f"fps: need 1 <= npoint <= N <= {MAX_N}, got {npoint}, {N}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    _lib.launch("fps", xyz.data_ptr(), B, N, npoint, out.data_ptr(), _lib.stream(xyz))
    return out
