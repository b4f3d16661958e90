#!/usr/bin/env python3
"""FPS above 8192 points on one GPU: the cluster routes at each cluster size.

    python3 scripts/fps_cluster_timing.py [--other TREE]

Builds ``mocopci_torch/csrc/fps.cu`` alone (with ``-Xptxas -v``), then times
``fps_cluster`` and ``fps_pyramid_cluster`` at each cluster size that holds
the cloud (2, 4 and 8 blocks, in turns 2, 4, 8, 8, 4, 2) at the stress
forward's calls, the refine head's (3, n) -> n/4 and the encoder's pyramid
(2, n) -> n/4, n/16, n/32, n/128, for n in 12288, 16384 and 32768, by CUDA
events and by profiler device time, in µs a step (device time over the
steps of every level), beside the one-block route at 8192 points.  The
card tests (``tests/test_torch_cuda.py``) hold every size bit for bit
against the plain versions.

``--other TREE`` (another
checkout, for example the parent commit from ``git archive``) builds that
tree's ``fps.cu`` too, compares its one-block kernels' SASS with this tree's
(the first differing lines printed) and times its ``fps`` and
``fps_pyramid`` at 8192 points beside this tree's, in turns (there, here,
here, there).  The size chosen is ``CLUSTER`` in
``mocopci_torch/kernels/fps.py``.
"""
import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocopci_torch.kernels import _lib  # noqa: E402

fps_mod = importlib.import_module("mocopci_torch.kernels.fps")
ENTRIES = ("fps", "fps_pyramid", "fps_cluster", "fps_pyramid_cluster")


def build(tree=ROOT, tag="here"):
    """That tree's fps.cu and common.cu into a library of their own:
    (the loaded library, its path)."""
    out_dir = os.path.join(ROOT, "build", "fps_cluster")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"libfps_{tag}.so")
    csrc = os.path.join(tree, "mocopci_torch", "csrc")
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", csrc, "-o", out,
           os.path.join(csrc, "fps.cu"), os.path.join(csrc, "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line or "error" in line:
            print(f"{tag}: {line}", flush=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    lib = ctypes.CDLL(out)
    for name in ENTRIES if tag == "here" else ENTRIES[:2]:
        fn = getattr(lib, f"mocopci_{name}")
        fn.argtypes, fn.restype = _lib.SIGNATURES[name], ctypes.c_int
    lib.mocopci_error_string.argtypes = [ctypes.c_int]
    lib.mocopci_error_string.restype = ctypes.c_char_p
    return lib, out


def one_block_sass(path):
    """kernel name -> its SASS lines (the function's header line dropped,
    whitespace collapsed), for the one-block kernels of the library at
    ``path``."""
    text = subprocess.run([os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump"), "-sass",
                           path], capture_output=True, text=True, check=True).stdout
    kernels = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = part.split("\n", 1)
        for k in ("fps_pyramid_kernel", "fps_kernel"):
            if re.search(rf"\d{k}E", name):
                # cuobjdump aligns its columns to the file's longest line
                kernels[k] = [" ".join(line.split()) for line in body.splitlines()
                              if line.strip()]
    return kernels


def compare_other(tree, dev) -> None:
    """That tree's one-block kernels against this tree's: SASS, then device
    time at 8192 points in turns."""
    other, path = build(tree, "other")
    here = one_block_sass(os.path.join(ROOT, "build", "fps_cluster", "libfps_here.so"))
    there = one_block_sass(path)
    for k in ("fps_kernel", "fps_pyramid_kernel"):
        a, b = there.get(k, []), here.get(k, [])
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        print(f"sass {k}: {len(a)} lines there, {len(b)} here, {len(diff)} differ", flush=True)
        for x, y in diff[:10]:
            print(f"  there: {x}\n  here:  {y}", flush=True)
    g = torch.Generator(device=dev).manual_seed(5)
    xyz6 = torch.randn(6, 8192, 3, generator=g, device=dev) * 10
    xyz2 = xyz6[:2].contiguous()
    lv = (2048, 512, 256, 64)
    st = torch.cuda.current_stream().cuda_stream

    def fps_there(xyz, n):
        out = torch.empty((xyz.shape[0], n), dtype=torch.int32, device=dev)
        assert other.mocopci_fps(xyz.data_ptr(), xyz.shape[0], 8192, n, out.data_ptr(), st) == 0
        return out

    def pyramid_there(xyz):
        out = torch.empty(xyz.shape[0] * sum(lv), dtype=torch.int32, device=dev)
        levels = torch.tensor(lv, dtype=torch.int32)
        assert other.mocopci_fps_pyramid(xyz.data_ptr(), xyz.shape[0], 8192, levels.data_ptr(),
                                         len(lv), out.data_ptr(), st) == 0
        return out

    same = (torch.equal(fps_there(xyz6, 2048), fps_mod.fps(xyz6, 2048)) and torch.equal(
        pyramid_there(xyz2), torch.cat([t.reshape(-1) for t in fps_mod.fps_pyramid(xyz2, lv)])))
    print(f"other tree's one-block FPS bit-equal to this tree's: {same}", flush=True)
    for what, there_fn, here_fn in (
            ("fps (6, 8192) -> 2048", lambda: fps_there(xyz6, 2048),
             lambda: fps_mod.fps(xyz6, 2048)),
            (f"fps_pyramid (2, 8192) -> {lv}", lambda: pyramid_there(xyz2),
             lambda: fps_mod.fps_pyramid(xyz2, lv))):
        us = [cs.device_us(f) for f in (there_fn, here_fn, here_fn, there_fn)]
        print(f"time {what}: device us there {us[0]} / {us[3]}, here {us[1]} / {us[2]}, in turns",
              flush=True)


def stress_levels(n):
    return (n // 4, n // 16, n // 32, n // 128)


def sizes(N):
    return [c for c in (2, 4, 8) if -(-N // c) <= fps_mod.BLOCK_MAX_N]


def fps_over(xyz, npoint, c):
    """The ``fps_cluster`` entry at a cluster of ``c`` blocks."""
    out = torch.empty((xyz.shape[0], npoint), dtype=torch.int32, device=xyz.device)
    _lib.launch("fps_cluster", xyz.data_ptr(), xyz.shape[0], xyz.shape[1], npoint, c,
                out.data_ptr(), _lib.stream(xyz))
    return out


def fps_pyramid_over(xyz, levels, c):
    """The ``fps_pyramid_cluster`` entry at a cluster of ``c`` blocks."""
    out = torch.empty(xyz.shape[0] * sum(levels), dtype=torch.int32, device=xyz.device)
    lv = torch.tensor(levels, dtype=torch.int32)
    _lib.launch("fps_pyramid_cluster", xyz.data_ptr(), xyz.shape[0], xyz.shape[1],
                lv.data_ptr(), len(levels), c, out.data_ptr(), _lib.stream(xyz))
    return out


def time_all(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(4)

    def line(what, fn, steps):
        ms = cs.median_ms(fn)
        us = cs.device_us(fn)
        per = f"{float(us) / steps:.4f}" if us != "not measured" else "not measured"
        print(f"time {what}: {ms:.4f} ms by CUDA events ({1e3 * ms / steps:.4f} us a step), "
              f"device us {us} ({per} us a step over {steps} steps)", flush=True)

    xyz3 = torch.randn(3, 8192, 3, generator=g, device=dev) * 10
    xyz2 = torch.randn(2, 8192, 3, generator=g, device=dev) * 10
    line("fps one block (3, 8192) -> 2048", lambda: fps_mod.fps(xyz3, 2048), 2047)
    lv = stress_levels(8192)
    line(f"fps_pyramid one block (2, 8192) -> {lv}", lambda: fps_mod.fps_pyramid(xyz2, lv),
         sum(n - 1 for n in lv))
    for N in (12288, 16384, 32768):
        xyz3 = torch.randn(3, N, 3, generator=g, device=dev) * 10
        xyz2 = torch.randn(2, N, 3, generator=g, device=dev) * 10
        lv = stress_levels(N)
        order = sizes(N) + sizes(N)[::-1]
        for c in order:
            line(f"fps_cluster c{c} (3, {N}) -> {N // 4}",
                 lambda: fps_over(xyz3, N // 4, c), N // 4 - 1)
        for c in order:
            line(f"fps_pyramid_cluster c{c} (2, {N}) -> {lv}",
                 lambda: fps_pyramid_over(xyz2, lv, c), sum(n - 1 for n in lv))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", metavar="TREE", help="another checkout whose one-block FPS "
                    "kernels are compared (SASS) and timed beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fps_cluster_timing: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    _lib._lib = build()[0]
    dev = torch.device("cuda")
    if args.other:
        compare_other(args.other, dev)
    time_all(dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
