#!/usr/bin/env python3
"""The cost-volume tail's wide backward on one GPU, each launch's device time.

    python3 scripts/cross_tail_bwd_split.py [--tree TREE ...] [--reps 20]

Builds each tree's ``mocopci_torch/csrc/cross_tail.cu`` alone with
``-Xptxas -v`` (the builds started together; default: this checkout) and
prints the wide backward's registers and spills.  At cross3 of the
32768-point train step, (B, N, K, C, C2) = (1, 1024, 32, 256, 256), from
the plain forward's output and first argmax, it calls each tree's C entry
``mocopci_cross_tail_bwd_wide`` with its outputs and scratch allocated as
that tree's wrapper allocates them (``chip_smoke.bwd_wide_call``): d_rows
and d_base held bit-equal to the first tree's, the calls timed in turns by
CUDA events (first, second, ..., second, first; median of ``--reps``),
then each launch's device µs by kernel name over ``--reps`` profiled
calls, and the ``torch.empty`` of the scratch by CUDA events.
"""
import argparse
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocopci_torch.kernels import _lib  # noqa: E402

SHAPE = (1, 1024, 32, 256, 256)      # (B, N, K, C, C2), M = N


def _module(tree, name, tag):
    spec = importlib.util.spec_from_file_location(
        f"{tag}_{name}", os.path.join(tree, "mocopci_torch", "kernels", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Tree:
    """A checkout's wide backward: its ``cross_tail.cu`` built alone, its C
    entry and its wrapper module (``ct``)."""

    def __init__(self, tree, tag):
        self.tree, self.tag = os.path.abspath(tree), tag
        csrc = os.path.join(self.tree, "mocopci_torch", "csrc")
        self.path = os.path.join(ROOT, "build", "split", tag, "libsplit.so")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", csrc, "-o",
               self.path, os.path.join(csrc, "cross_tail.cu")]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)

    def finish(self):
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise SystemExit(f"{self.tag}: {self.tree}'s cross_tail.cu did not build:\n{log}")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d+(cross_tail_bwd_wide\w*?_kernel)(I\w)?", line)
                kernel = m and m.group(1) + (f"<{m.group(2)[1]}>" if m.group(2) else "")
            elif kernel and ("registers" in line or "spill" in line):
                print(f"{self.tag} {kernel}: {line.split(':', 1)[-1].strip()}")
        self.ct = _module(self.tree, "cross_tail", self.tag)
        lib = ctypes.CDLL(self.path)
        cs.bind_entries(lib, _module(self.tree, "_lib", self.tag).SIGNATURES,
                        ("cross_tail_bwd_wide",))
        self.entry = lib.mocopci_cross_tail_bwd_wide


def split(fn, reps):
    """{kernel name: device µs a call of ``fn``} over ``reps`` profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / reps
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", help="a checkout (repeatable; default: this one)")
    ap.add_argument("--reps", type=int, default=cs.REPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(cs.card_line())
    trees = [Tree(t, f"t{i}") for i, t in enumerate(args.tree or [ROOT])]
    for t in trees:
        t.finish()

    B, N, K, C, C2 = SHAPE
    M, dev = N, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tab = torch.randn(B, M, C, generator=gen, device=dev)
    base = torch.randn(B, N, C, generator=gen, device=dev)
    w = torch.randn(C, C2, generator=gen, device=dev) * C ** -0.5
    b = torch.randn(C2, generator=gen, device=dev) * 0.1
    idx = torch.randint(0, M, (B, N, K), generator=gen, device=dev, dtype=torch.int32)
    dout = torch.randn(B, N, C2, generator=gen, device=dev)
    ct = trees[0].ct
    out = ct.cross_tail_plain(tab, idx, base, w, b)
    amax = ct.cross_tail_argmax_plain(tab, idx, base, w, b)
    calls = [lambda t=t: cs.bwd_wide_call(t.entry, t.ct, tab, idx, base, w, out, amax, dout)
             for t in trees]
    first = calls[0]()
    for t, call in zip(trees, calls):
        got = call()
        parts, floats = cs.bwd_wide_sizes(t.ct, B, N, K, C, C2)
        gap = max(float((a - f).abs().max()) / (1 + float(f.abs().max()))
                  for a, f in zip(got[2:], first[2:]))
        print(f"{t.tag} {t.tree}: {parts} partials, scratch {floats} floats "
              f"({floats * 4 / 2 ** 20:.2f} MiB); d_rows, d_base bit-equal to the first tree's "
              f"{cs.bits_equal(got[:2], first[:2])}; dW, db within {gap:.3e} (1 + max)")
    turns = list(range(len(trees))) + list(reversed(range(len(trees))))
    times = {i: [] for i in range(len(trees))}
    for i in turns:
        times[i].append(cs.median_ms(calls[i], args.reps))
    for i, t in enumerate(trees):
        per = split(calls[i], args.reps)
        floats = cs.bwd_wide_sizes(t.ct, B, N, K, C, C2)[1]
        alloc = cs.median_ms(lambda: torch.empty(floats, device=dev), args.reps)
        print(f"{t.tag} entry: {' / '.join(f'{x:.4f}' for x in times[i])} ms in turns; device "
              f"us {sum(per.values()):.3f}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1]))
              + f"; torch.empty of the scratch {alloc:.4f} ms")
    print(f"shape (B, N, K, C, C2) {SHAPE}, M = {M}; bound "
          f"{cs.bound(*cs.cross_bwd_work(B, M, N, K, C, C2))[0]:.5f} ms (bytes)")


if __name__ == "__main__":
    main()
