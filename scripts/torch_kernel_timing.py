#!/usr/bin/env python3
"""Build the port's kernels on one GPU and check and time the train kernels.

    python3 scripts/torch_kernel_timing.py [--ptxas SOURCE ...] [--other TREE]
                                           [--parent TREE] [--skip-scatter]

A short card run for work on one kernel, instead of the whole
``chip_smoke.py``: it prints the card's name and power limit, compiles the
named ``mocopci_torch/csrc`` sources once more with ``-Xptxas -v`` (registers,
shared memory and spills of each kernel; by default ``scatter_add.cu`` and
``fusion_head_train_bwd.cu``) beside the library build, then runs
``chip_smoke.check_train_kernels``: every train kernel against its plain
version at the B=2 train step's shapes, twice for bit-equal repeats, with its
time, its plain version's, the library call's and its bound (with
``--parent``, another checkout's cost-volume tail forward and backward
beside this tree's, as ``chip_smoke.py --parent``).  Then
the scatter-add on the inputs of one train step at ``ModelConfig()``, B=2: the
device time of each of its shapes, beside one ``index_add_`` and, with
``--other``, beside the ``scatter_add.cu`` of another checkout (for example
the parent commit unpacked with ``git archive`` into ``outputs/``), whose
results must equal this one's bit for bit; and the device time of each sweep
of the train fusion head's backward.  The skewed-bucket checks are the card
tests of ``tests/test_torch_card_scatter.py``.  Exits non-zero on any failed
check.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report(sources):
    """Start one nvcc -Xptxas -v per source; returns the running processes."""
    from mocopci_torch.kernels import _lib

    out_dir = os.path.join(ROOT, "build", "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in sources:
        src = os.path.join(ROOT, "mocopci_torch", "csrc", name)
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_lib.CSRC), "-c", src,
               "-o", os.path.join(out_dir, name + ".o")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    return procs


def other_scatter(tree):
    """The scatter-add entry point of another checkout (its
    ``mocopci_torch/csrc/scatter_add.cu``, built alone into its own library),
    called with a zeroed work buffer large enough for any of its versions."""
    import ctypes

    from mocopci_torch.kernels import _lib

    csrc = os.path.join(tree, "mocopci_torch", "csrc")
    out = os.path.join(ROOT, "build", "other_scatter", "libscatter.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", csrc, "-o", out,
                    os.path.join(csrc, "scatter_add.cu")], check=True)
    fn = ctypes.CDLL(out).mocopci_scatter_add
    fn.argtypes, fn.restype = _lib.SIGNATURES["scatter_add"], ctypes.c_int

    def run(v, idx, n, planes):
        G = v.shape[0]
        C, S = (v.shape[1], v.shape[2]) if planes else (v.shape[2], v.shape[1])
        o = torch.empty((G, n, C), device=v.device)
        work = torch.zeros(G * (3 * n + 1 + 2 * S), dtype=torch.int32, device=v.device)
        if fn(v.data_ptr(), idx.data_ptr(), o.data_ptr(), work.data_ptr(), G, S, C, n,
              int(planes), torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the other tree's scatter_add failed")
        return o
    return run


def step_scatters(dev):
    """The inputs of every scatter-add launch of one train step at
    ``ModelConfig()``, B=2 (synthetic pairs, seed 2), one per distinct shape,
    with the number of launches of that shape."""
    from mocopci_torch import ModelConfig
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import SyntheticInterpolationDataset, batches
    from mocopci_torch.training import create_train_state, train_step

    mod = importlib.import_module("mocopci_torch.kernels.scatter_add")
    orig, seen = mod.scatter_add, {}

    def spy(v, idx, n, planes=False):
        key = (tuple(v.shape), n, planes)
        if key not in seen:
            seen[key] = [v.clone(), idx.clone(), 0]
        seen[key][2] += 1
        return orig(v, idx, n, planes=planes)

    users = [m for name, m in sys.modules.items()
             if name.startswith("mocopci_torch") and getattr(m, "scatter_add", None) is orig]
    cfg, tcfg = ModelConfig(), TrainConfig()
    data = SyntheticInterpolationDataset(length=tcfg.batch_size, num_points=cfg.npoints, seed=2)
    batch = next(iter(batches(data, tcfg.batch_size, shuffle=False)))
    _, state = create_train_state(cfg, tcfg, steps_per_epoch=1, device=dev)
    for m in users:
        m.scatter_add = spy
    try:
        train_step(state, batch, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        for m in users:
            m.scatter_add = orig
    del state
    return seen


def device_us(fn, reps=10):
    """Device time of one call of ``fn`` (all its kernels and memsets, in
    microseconds, mean of ``reps``; torch.profiler) and per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {e.key[:40]: e.self_device_time_total / reps for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return sum(per.values()), per


def scatter_on_the_step(dev, other):
    """The scatter-add at each of the train step's shapes, on the step's own
    inputs: device time of this tree's kernel, of ``other`` (another tree's,
    when given) and of one ``index_add_``, the per-step sums, and bits equal
    to the other tree and on repeat (both sum in ascending source position)."""
    mod = importlib.import_module("mocopci_torch.kernels.scatter_add")
    totals = {"scatter_add": 0.0, "other": 0.0, "index_add_": 0.0}
    for (shape, n, planes), (v, idx, count) in step_scatters(dev).items():
        G = v.shape[0]
        C = v.shape[1] if planes else v.shape[2]
        rows = (v.transpose(1, 2) if planes else v).reshape(-1, C).contiguous()
        keep = (idx >= 0) & (idx < n)
        flat = torch.where(keep, idx.long() + torch.arange(G, device=dev)[:, None] * n,
                           G * n).reshape(-1)
        sizes = torch.stack([torch.bincount(i[(i >= 0) & (i < n)].long(), minlength=n)
                             for i in idx])
        big = {f">{b}": int((sizes > b).sum()) for b in (32, 256, 4096, 16384)}
        print(f"scatter on the step: {shape} -> {n} rows: bucket sizes max {int(sizes.max())}, "
              f"rows {big}, a source's bucket on average "
              f"{float((sizes.double() ** 2).sum() / sizes.sum()):.1f}", flush=True)
        got = mod.scatter_add(v, idx, n, planes=planes)
        same = torch.equal(got.view(torch.int32),
                           mod.scatter_add(v, idx, n, planes=planes).view(torch.int32))
        us, per = device_us(lambda: mod.scatter_add(v, idx, n, planes=planes))
        lib_us, _ = device_us(lambda: torch.zeros(G * n + 1, C, device=dev).index_add_(
            0, flat, rows))
        line = (f"scatter on the step: {shape} planes={planes} -> {n} rows, {count} a step: "
                f"device us {us:.2f} {json.dumps({k: round(x, 2) for k, x in per.items()})}; "
                f"index_add_ {lib_us:.2f}; repeat bit-equal {same}")
        totals["scatter_add"] += count * us
        totals["index_add_"] += count * lib_us
        if other is not None:
            o_us, _ = device_us(lambda: other(v, idx, n, planes))
            equal = torch.equal(got.view(torch.int32), other(v, idx, n, planes).view(torch.int32))
            line += f"; other tree {o_us:.2f} us, bit-equal {equal}"
            totals["other"] += count * o_us
            same &= equal
        print(line, flush=True)
        if not same:
            raise SystemExit("scatter_add: a run did not repeat, or the trees disagree")
    print(f"scatter on the step: device us per step {json.dumps({k: round(x, 2) for k, x in totals.items()})}",
          flush=True)


def profile_fusion_head_bwd(dev, reps=3):
    """Device time per sweep kernel of the train fusion head's backward at the
    B=2 train shape ((6, 4, 524288) planes, 3 groups), over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fht = importlib.import_module("mocopci_torch.kernels.fusion_head_train")
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(6, 4, 524288, generator=g, device=dev) * 10.0
    params, cin = [], 4
    for c in fht.WIDTHS[1:]:
        params += [torch.randn(cin, c, generator=g, device=dev) * cin ** -0.5,
                   torch.randn(c, generator=g, device=dev) * 0.1,
                   1 + torch.randn(c, generator=g, device=dev) * 0.1,
                   torch.randn(c, generator=g, device=dev) * 0.1]
        cin = c
    _, _, (packed, st) = fht.fusion_head_train_fwd(x, params, 3)
    d_o = torch.randn(6, 524288, generator=g, device=dev)
    fht.fusion_head_train_bwd(x, params, 3, packed, st, d_o)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fht.fusion_head_train_bwd(x, params, 3, packed, st, d_o)
        torch.cuda.synchronize()
    per = {e.key[:60]: round(e.self_device_time_total / reps / 1e3, 3) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    print(f"profile fusion_head_train_bwd: device ms per call {per}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", nargs="*", default=["scatter_add.cu", "fusion_head_train_bwd.cu"])
    ap.add_argument("--skip-train", action="store_true",
                    help="leave out chip_smoke.check_train_kernels")
    ap.add_argument("--other", metavar="TREE",
                    help="a checkout whose scatter_add.cu is timed beside this one's")
    ap.add_argument("--parent", metavar="TREE",
                    help="a checkout whose cost-volume tail kernels are timed beside this "
                         "one's")
    ap.add_argument("--skip-scatter", action="store_true",
                    help="leave out the scatter-add on the train step's inputs")
    ap.add_argument("--skip-fusion-head", action="store_true",
                    help="leave out the backward sweeps' profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mocopci_torch import ModelConfig, kernels
    from mocopci_torch.kernels import _lib

    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    procs = ptxas_report(args.ptxas)
    finish_parent = chip_smoke.build_parent(args.parent) if args.parent else None
    _lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    parent = finish_parent() if finish_parent else None
    failed = False
    for name, proc in procs:
        log, _ = proc.communicate()
        lines = [ln for ln in log.splitlines()
                 if any(w in ln for w in ("Used", "spill", "Compiling entry", "error", "warning",
                                        "Performance"))]
        print(f"--- ptxas {name} (rc {proc.returncode})\n" + "\n".join(lines), flush=True)
        failed |= proc.returncode != 0
    if failed:
        raise SystemExit("nvcc -Xptxas -v failed")
    dev = torch.device("cuda")
    rows = []
    if not args.skip_train:
        chip_smoke.check_train_kernels(kernels, ModelConfig(), dev, rows, parent)
    if not args.skip_scatter:
        scatter_on_the_step(dev, other_scatter(args.other) if args.other else None)
    if not args.skip_fusion_head:
        profile_fusion_head_bwd(dev)
    for r in rows:
        print({k: r[k] for k in ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                 "max_abs_err")}, flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
