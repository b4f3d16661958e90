"""Farthest point sampling: CUDA kernels ``csrc/fps.cu`` and their plain twins.

Replaces ``mocopci_tpu/ops/pallas/fps.py``: ``farthest_point_sample_pallas``
(:419) by :func:`fps`, and ``farthest_point_sample_pyramid_pallas`` (:477) by
:func:`fps_pyramid`, every level in one launch with the level subsets kept in
shared memory.  One block per cloud up to ``BLOCK_MAX_N`` points; the step
chain, not bytes or flops, bounds both (see the source note), and a step
takes one block barrier.  Above ``BLOCK_MAX_N`` points, up to ``MAX_N``,
level 0 runs across a thread-block cluster of ``CLUSTER`` blocks (the
declared routes ``fps_cluster`` and ``fps_pyramid_cluster``): at a step
each warp pushes its winner into every block's shared memory with
``st.async``, and each block waits on its own ``mbarrier``, which those
stores complete, with no cluster barrier inside the step loop; a
pyramid's later levels, at most ``BLOCK_MAX_N`` points each, run on the
cluster's first block.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/fps.cu"
REPLACES = "mocopci_tpu/ops/pallas/fps.py:419"
REPLACES_PYRAMID = "mocopci_tpu/ops/pallas/fps.py:477"

BLOCK_MAX_N = 8192    # one block: 32 points a thread, 256 threads
# blocks a cluster, the portable most: chosen by scripts/fps_cluster_timing.py
# on the card with the mbarrier exchange, 8 blocks at the stress sizes 16384
# (fps_cluster 0.581 µs a step against 0.588 at 4 and 0.818 at 2) and 32768
# (0.687 against 0.836 at 4)
CLUSTER = 8
MAX_N = CLUSTER * BLOCK_MAX_N
MAX_LEVELS = 8


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


def fps_pyramid_plain(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Cascaded :func:`fps_plain`: level l samples ``npoints[l]`` of level
    l-1's points (gathered), its indices addressing them."""
    idxs, pc = [], xyz.detach().float()
    for n in npoints:
        i = fps_plain(pc, n)
        pc = _lib.group_rows(pc, i)
        idxs.append(i)
    return tuple(idxs)


def _check_cloud(name: str, xyz: torch.Tensor) -> Tuple[int, int]:
    _lib.check_cuda(f"{name} xyz", xyz, torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3:
        raise ValueError(f"{name}: expected (B, N, 3), got {tuple(xyz.shape)}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"{name}: need 1 <= N <= {MAX_N}, got {N}")
    return B, N


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (B, npoint) int32; the kernel on CUDA (one block a cloud up
    to ``BLOCK_MAX_N`` points, a cluster above), the twin on the CPU."""
    if _lib.dispatch_device(xyz) == "cpu":
        return fps_plain(xyz, npoint)
    B, N = _check_cloud("fps", xyz)
    if not 1 <= npoint <= N:
        raise ValueError(f"fps: need 1 <= npoint <= N = {N}, got {npoint}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if N <= BLOCK_MAX_N:
        _lib.launch("fps", xyz.data_ptr(), B, N, npoint, out.data_ptr(), _lib.stream(xyz))
    else:
        _lib.launch("fps_cluster", xyz.data_ptr(), B, N, npoint, CLUSTER, out.data_ptr(),
                    _lib.stream(xyz))
    return out


def fps_pyramid(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """One (B, npoints[l]) int32 index tensor per level, level l addressing
    level l-1's sampled points (level 0 ``xyz``); one launch on CUDA (above
    ``BLOCK_MAX_N`` points level 0 over a cluster, and every later level on
    at most ``BLOCK_MAX_N`` points), the twin on the CPU."""
    npoints = tuple(int(n) for n in npoints)
    if _lib.dispatch_device(xyz) == "cpu":
        return fps_pyramid_plain(xyz, npoints)
    B, N = _check_cloud("fps_pyramid", xyz)
    if not 1 <= len(npoints) <= MAX_LEVELS:
        raise ValueError(f"fps_pyramid: 1 to {MAX_LEVELS} levels, got {len(npoints)}")
    for l, (n, n_in) in enumerate(zip(npoints, (N,) + npoints)):
        if not 1 <= n <= n_in:
            raise ValueError(f"fps_pyramid: level {l} takes {n} of {n_in} points; a level "
                             "samples 1 to all of the points of the level before")
    if max(npoints[:-1], default=0) > BLOCK_MAX_N:
        raise ValueError(f"fps_pyramid: a level after the first runs on one block, at most "
                         f"{BLOCK_MAX_N} points; got levels {npoints}")
    out = torch.empty(B * sum(npoints), dtype=torch.int32, device=xyz.device)
    levels = torch.tensor(npoints, dtype=torch.int32)        # read on the host
    if N <= BLOCK_MAX_N:
        _lib.launch("fps_pyramid", xyz.data_ptr(), B, N, levels.data_ptr(), len(npoints),
                    out.data_ptr(), _lib.stream(xyz))
    else:
        _lib.launch("fps_pyramid_cluster", xyz.data_ptr(), B, N, levels.data_ptr(),
                    len(npoints), CLUSTER, out.data_ptr(), _lib.stream(xyz))
    return tuple(part.view(B, n) for part, n in zip(out.split([B * n for n in npoints]),
                                                    npoints))
