"""Build, load and launch the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The build happens at first use, into
``build/mocopci_torch_kernels/`` beside the package, keyed by a hash of the
sources and flags so a stale library is never loaded.  A failed build raises;
there is no fallback.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and counts the
launch in :data:`LAUNCHES`, the only place a kernel launch is counted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mocopci_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "fps": [_P, _I, _I, _I, _P, _P],
    "fps_pyramid": [_P, _I, _I, _P, _I, _P, _P],
    "fps_cluster": [_P, _I, _I, _I, _I, _P, _P],
    "fps_pyramid_cluster": [_P, _I, _I, _P, _I, _I, _P, _P],
    "knn": [_P, _P] + [_I] * 9 + [_P] * 4,
    "attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "attention_wide": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "cross_tail": [_P] * 7 + [_I] * 7 + [_P],
    "cross_tail_wide": [_P] * 7 + [_I] * 7 + [_P],
    "transformer_tail": [_P] * 13 + [_I] * 6 + [_P],
    "transformer_tail_general": [_P] * 13 + [_I] * 5 + [_P],
    "fusion_pair": [_P] * 11 + [_I, _I, _I, _I, _P],
    "knn_approx": [_P, _P, _P] + [_I] * 12 + [_P, _P],
    "chamfer_pair": [_P, _P] + [_I] * 6 + [_P, _P, _P],
    "scatter_add": [_P] * 4 + [_I] * 5 + [_P],
    "attention_train_fwd": [_P] * 5 + [_I] * 4 + [_F, _P, _I, _F, _P],
    "attention_train_fwd_wide": [_P] * 5 + [_I] * 4 + [_F, _P, _I, _F, _P],
    "attention_train_bwd": [_P] * 10 + [_I] * 4 + [_F, _P, _I, _F, _P],
    "attention_train_bwd_wide": [_P] * 10 + [_I] * 4 + [_F, _P, _I, _F, _P],
    "cross_tail_bwd": [_P] * 11 + [_I] * 7 + [_P],
    "cross_tail_bwd_wide": [_P] * 11 + [_I] * 7 + [_P],
    "transformer_tail_bwd": [_P] * 18 + [_I] * 6 + [_P],
    "transformer_tail_bwd_general": [_P] * 18 + [_I] * 6 + [_P],
    "fusion_pair_planes": [_P] * 4 + [_I] * 4 + [_P],
    "fusion_head_train_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "fusion_head_train_bwd": [_P] * 9 + [_I] * 5 + [_P],
    "select_min_k": [_P] * 3 + [_I] * 3 + [_P],
    "onehot_scatter": [_P] * 3 + [_I] * 3 + [_P],
    "pair_planes_rows": [_P] * 3 + [_I] * 3 + [_P],
    "pair_planes_bwd": [_P] * 5 + [_I] * 3 + [_P],
}

# launches per kernel since the last reset_launches()
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if needed and return the library's path."""
    out = BUILD_DIR / f"libmocopci_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    errors = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {src.name} (rc {proc.returncode})\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, f"mocopci_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mocopci_error_string.argtypes = [ctypes.c_int]
        lib.mocopci_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call ``mocopci_<name>`` and raise on a launch error; counts the launch."""
    lib = load()
    rc = getattr(lib, f"mocopci_{name}")(*args)
    if rc != 0:
        msg = lib.mocopci_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    LAUNCHES[name] += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Device, dtype, rank and contiguity checks before a pointer is passed."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A forward-only kernel must not hand back an output with no ``grad_fn``
    where autograd expects one: raise instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only; call it under "
                           "torch.no_grad() or on inputs that do not require grad")


def group_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (B, M, C) x (B, ...) int -> (B, ..., C), batch folded into
    the index (one flat index_select)."""
    B, M, C = table.shape
    off = torch.arange(B, device=table.device).view((B,) + (1,) * (idx.dim() - 1)) * M
    flat = (idx.long() + off).reshape(-1)
    return table.reshape(B * M, C).index_select(0, flat).reshape(*idx.shape, C)


def dispatch_device(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {kinds}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind}")
    return kind
