"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

A wrapper runs the twin for tensors on the CPU and launches the kernel for
CUDA tensors (or raises); it never falls back.  A kernel with a backward is a
``torch.autograd.Function`` whose backward is a kernel too (the twin's
backward on the CPU is autograd through the twin).  ``LAUNCHES`` counts kernel
launches per kernel name; ``reset_launches()`` zeroes them.
"""
from mocopci_torch.kernels._lib import LAUNCHES, reset_launches
from mocopci_torch.kernels.attention import attention, attention_plain
from mocopci_torch.kernels.attention_train import attention_train, attention_train_plain
from mocopci_torch.kernels.chamfer_pair import (
    chamfer_pair,
    chamfer_pair_keys,
    chamfer_pair_keys_plain,
)
from mocopci_torch.kernels.cross_tail import cross_tail, cross_tail_plain
from mocopci_torch.kernels.fps import fps, fps_plain, fps_pyramid, fps_pyramid_plain
from mocopci_torch.kernels.fusion_head_train import fusion_head_train, fusion_head_train_plain
from mocopci_torch.kernels.fusion_pair import (
    fold_bn_dense,
    fusion_pair,
    fusion_pair_plain,
    build_pair_planes,
    build_pair_planes_plain,
    fusion_pair_planes,
    pair_planes,
)
from mocopci_torch.kernels.knn import knn_exact, knn_plain
from mocopci_torch.kernels.knn_approx import knn_approx, knn_approx_plain
from mocopci_torch.kernels.scatter_add import scatter_add, scatter_add_plain
from mocopci_torch.kernels.scatter_onehot import onehot_scatter_rows, onehot_scatter_rows_plain
from mocopci_torch.kernels.select_k import select_min_k, select_min_k_plain
from mocopci_torch.kernels.transformer_tail import transformer_tail, transformer_tail_plain

__all__ = [
    "LAUNCHES", "reset_launches",
    "attention", "attention_plain",
    "attention_train", "attention_train_plain",
    "chamfer_pair", "chamfer_pair_keys", "chamfer_pair_keys_plain",
    "cross_tail", "cross_tail_plain",
    "fps", "fps_plain", "fps_pyramid", "fps_pyramid_plain",
    "fusion_head_train", "fusion_head_train_plain",
    "build_pair_planes", "build_pair_planes_plain",
    "fold_bn_dense", "fusion_pair", "fusion_pair_plain", "fusion_pair_planes", "pair_planes",
    "knn_exact", "knn_plain",
    "knn_approx", "knn_approx_plain",
    "onehot_scatter_rows", "onehot_scatter_rows_plain",
    "scatter_add", "scatter_add_plain",
    "select_min_k", "select_min_k_plain",
    "transformer_tail", "transformer_tail_plain",
]
