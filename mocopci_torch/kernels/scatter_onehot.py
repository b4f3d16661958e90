"""One-hot scatter of xyz rows into planes: CUDA kernel ``csrc/scatter_onehot.cu``
and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/scatter.py``: ``onehot_scatter_rows`` (:63).
``out[g, c, o] = Σ_s v[g, s, c]·1[idx[g, s] == o]`` for (G, S, 3) rows and
(G, S) int32 targets, out-of-range targets dropped; the kernel sums each
column in a fixed order, so a run repeats its bits.  The sizes must tile as
the TPU kernel's: S % min(512, S) == 0 and out_size % min(512, out_size) ==
0.  Bytes bound it.  The Chamfer VJP takes it where N or M % 128 != 0
(``mocopci_tpu/ops/pallas/chamfer_pair.py:224-228``).
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.scatter_add import scatter_add_plain

SOURCE = "mocopci_torch/csrc/scatter_onehot.cu"
REPLACES = "mocopci_tpu/ops/pallas/scatter.py:63"

TO = TS = 512   # the TPU kernel's output and source tiles


def _check_tiles(S: int, out_size: int) -> None:
    if S % min(TS, S) or out_size % min(TO, out_size):
        raise ValueError(f"onehot_scatter_rows: sizes must tile by 512, got S={S}, "
                         f"out_size={out_size}")


def onehot_scatter_rows_plain(v: torch.Tensor, idx: torch.Tensor, out_size: int) -> torch.Tensor:
    """(G, S, 3) rows + (G, S) targets -> (G, 3, out_size): ``index_add_``
    into rows, transposed to planes."""
    _check_tiles(v.shape[1], out_size)
    return scatter_add_plain(v, idx, out_size).transpose(1, 2).contiguous()


def onehot_scatter_rows(v: torch.Tensor, idx: torch.Tensor, out_size: int) -> torch.Tensor:
    """The kernel on CUDA (one launch, the output its only allocation), the
    twin on the CPU."""
    if _lib.dispatch_device(v, idx) == "cpu":
        return onehot_scatter_rows_plain(v, idx, out_size)
    _lib.check_cuda("onehot_scatter v", v, torch.float32, 3)
    _lib.check_cuda("onehot_scatter idx", idx, torch.int32, 2)
    G, S, C = v.shape
    if C != 3 or idx.shape != (G, S):
        raise ValueError(f"onehot_scatter_rows: v {tuple(v.shape)}, idx {tuple(idx.shape)}")
    _check_tiles(S, out_size)
    out = torch.empty((G, 3, out_size), dtype=torch.float32, device=v.device)
    _lib.launch("onehot_scatter", v.data_ptr(), idx.data_ptr(), out.data_ptr(), G, S, out_size,
                _lib.stream(v))
    return out
