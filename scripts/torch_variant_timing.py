#!/usr/bin/env python3
"""Time design variants of the transformer tail's forward, ``chamfer_pair`` and the wide cost-volume tail on one GPU.

    python3 scripts/torch_variant_timing.py [--reps 20] [--only tail|chamfer|wide]
    python3 scripts/torch_variant_timing.py --card-checks all_3xtf32

Each variant is this tree's ``mocopci_torch/csrc`` source with a few lines
replaced (``TAIL_VARIANTS``, ``CHAMFER_VARIANTS``: a Chamfer variant with
the tiling it is launched on; ``WIDE_VARIANTS`` of ``cross_tail.cu``'s wide
route), or the shipped kernel launched with other spans (``CHAMFER_SPANS``)
or grids (``WIDE_GRIDS``).  Every source variant is
built alone (one nvcc each, all started together) into
``build/variants/<name>/`` and called through the same C entry point at the
main path's shapes: the tail forward at the eval's (3, 2048, 16, 64) and the
train step's (6, 2048, 16, 64), the Chamfer keys at the loss's (30, 8192,
8192), the eval's (3, 8192, 8192) and the loss's (12, 2048, 2048), the
wide route at cross3 of the 32768-point stress forward, (1, 1024, 32) at C =
C2 = 256.  A tail variant's output is held within 1e-4 (1 + max |out|) of
the plain version and compared bit for bit with the shipped kernel's; a
Chamfer variant's keys, and a wide variant's output and argmax, must equal
the shipped kernel's.  Each is timed by torch.profiler device µs
(its kernel alone: outputs allocated and filled once), twice, in turns over
the variants.  Prints the card's name and power limit first, then each
variant kernel's registers and spills (``-Xptxas -v``); exits non-zero on a
failed build or check.  ``--card-checks NAME`` instead runs the card tests
of the tail and the tiny model and ``chip_smoke.py`` on a copy of this tree
with the tail variant NAME in place (``card_checks``).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

def _replace(old, new):
    def edit(src: str) -> str:
        if src.count(old) != 1:
            raise SystemExit(f"variant edit does not match once: {old!r}")
        return src.replace(old, new)
    return edit


# The shipped forward's chain (every D x D product at 3xTF32 from registers,
# the softmax by shuffles) and its output from registers, as they begin and end
_TAIL_CHAIN = "    const float* bias = sm + kOffBias;\n    float rel[2][3], x[8][4], y[8][4];\n"
_TAIL_SOFTMAX_END = "    __syncwarp();           // every lane is done with w\n"
_TAIL_OUT = "    // out: the lanes of each query's first row"
_TAIL_KERNEL_END = "      }\n    }\n  }\n}\n"
# a fourth [128][kLdT] buffer that a variant stages rows in (r0, r1, the
# logits), past the end of the shipped layout
_TAIL_PR = """    const int warp = threadIdx.x >> 5;
    constexpr int QW = 16 / K;
    float* PR = sm + kFOffXYZ + kBRows * 4;
"""
_TAIL_SMEM = _replace("constexpr int kFwdSmem = (kFOffXYZ + kBRows * 4) *",
                      "constexpr int kFwdSmem = (kFOffXYZ + kBRows * 4 + kBRows * kLdT) *")
# PR 1's arithmetic (the general route's, bit for bit): pos, h1 and logit on
# FMAs in k order (chain_pos, chain_gate, fma_product), the softmax a lane a
# (query, channel) in j order with expf, out written from there
_TAIL_PR1_CHAIN = _TAIL_PR + r"""    float rel[2][3], pos[4][8];
    uint32_t mask0;
    chain_pos<K>(XQs, XYZ, sm, PR, rel, mask0, pos);
    mocopci::cp_async_wait0();
    __syncwarp();           // and its v
    chain_gate<K>(Qs, sm, pos, PK, PV, PV, PR);
    __syncwarp();           // every lane is done with xyz, k (gv), q and xq
    if (next < ntiles) gather_k(next);
    {                       // logit = r1 Wg2 + bg2 on FMAs, over r1 in PR
      const int rg = lane >> 3, cg = lane & 7;
      float o[4][8];
      fma_product(PR, sm + kOffWg2, sm + kOffBias + 3 * kBD, o);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(PR + (warp * 16 + rg + 4 * i) * kLdT + 32 * h + 4 * cg) =
              make_float4(o[i][4 * h], o[i][4 * h + 1], o[i][4 * h + 2], o[i][4 * h + 3]);
    }
    __syncwarp();
    // the per-channel softmax over each query's K rows and out, a (query,
    // channel) a lane, in j order with the general route's arithmetic
    for (int it = lane; it < QW * kBD; it += 32) {
      const int qi = it / kBD, e = it % kBD;
      const float* G = PR + (warp * 16 + qi * K) * kLdT + e;
      const float* Wv = PV + (warp * 16 + qi * K) * kLdT + e;
      float m = -__int_as_float(0x7f800000);
      for (int j = 0; j < K; ++j) m = fmaxf(m, G[j * kLdT] * inv);
      float s = 0.f, acc = 0.f;
      for (int j = 0; j < K; ++j) {
        const float a = expf(G[j * kLdT] * inv - m);
        s += a;
        acc = fmaf(a, Wv[j * kLdT], acc);
      }
      const int qf = tile * QT + warp * QW + qi;
      if (qf < BN) out[static_cast<size_t>(qf) * kBD + e] = acc / s;
    }
    __syncwarp();           // every lane is done with w and the logits
    if (next < ntiles) gather_v(next);
  }
}
"""
# the first design: pos and h1 on FMAs as the backward's recompute, logit at
# 3xTF32 (chain_logit), the softmax by shuffles
_TAIL_FIRST_CHAIN = _TAIL_PR + r"""    float rel[2][3], pos[4][8], x[8][4], y[8][4];
    uint32_t mask0, mask1;
    chain_pos<K>(XQs, XYZ, sm, PR, rel, mask0, pos);
    mocopci::cp_async_wait0();
    __syncwarp();           // and its v
    chain_gate<K>(Qs, sm, pos, PK, PV, PV, PR);
    __syncwarp();           // every lane is done with xyz, k (gv), q and xq
    if (next < ntiles) gather_k(next);
    chain_logit(PR, sm, x, y, mask1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;
        float a0, a1;
        query_softmax<K>(x[nt][e] * inv, x[nt][2 + e] * inv, PV[R0 * kLdT + c],
                         PV[(R0 + 8) * kLdT + c], a0, a1, x[nt][e], x[nt][2 + e]);
      }
"""


def _tail_pr1(src: str) -> str:
    """The chain, the softmax and the output replaced by PR 1's arithmetic."""
    a = src.index(_TAIL_CHAIN)
    b = src.index(_TAIL_KERNEL_END, src.index(_TAIL_OUT)) + len(_TAIL_KERNEL_END)
    return _TAIL_SMEM(src[:a] + _TAIL_PR1_CHAIN + src[b:])


def _tail_first(src: str) -> str:
    """The chain and the softmax replaced by the first design's."""
    a = src.index(_TAIL_CHAIN)
    b = src.index(_TAIL_SOFTMAX_END)
    return _TAIL_SMEM(src[:a] + _TAIL_FIRST_CHAIN + src[b:])


# name -> edits of csrc/transformer_tail.cu
TAIL_VARIANTS = {
    "shipped": [],
    "pr1_arithmetic": [_tail_pr1],
    "first_design": [_tail_first],
}
_J_LOOP = "#pragma unroll 2\n    for (int j = 0; j < kChunk; ++j) {"
_Q16 = _replace("constexpr int kQ = 8;", "constexpr int kQ = 16;")
_UNROLL1 = _replace(_J_LOOP, _J_LOOP.replace("unroll 2", "unroll 1"))
_OR_MIN = _replace("{ return __viaddmin_s32(a, b, c); }", "{ return min(a | b, c); }")
_SHIPPED = (8, 512, 512)
# name -> (edits of csrc/chamfer_pair.cu, the launch_grid arguments of its
# tiling: queries a thread, threads a block at most, threads an SM); the
# first design held 16 queries a thread
CHAMFER_VARIANTS = {
    "shipped": ([], _SHIPPED),
    "or_min": ([_OR_MIN], _SHIPPED),
    "unroll1": ([_UNROLL1], _SHIPPED),
    "unroll1_2blocks": ([_UNROLL1, _replace("__launch_bounds__(kMaxThreads, 1)",
                                            "__launch_bounds__(kMaxThreads, 2)")], (8, 512, 1024)),
    "unroll1_1024": ([_UNROLL1, _replace("constexpr int kMaxThreads = 512;",
                                         "constexpr int kMaxThreads = 1024;")], (8, 1024, 1024)),
    "256_threads": ([], (8, 256, 512)),
    "q16_tiling": ([], (16, 512, 512)),
    "q16": ([_Q16], (16, 512, 512)),
    "q16_or_min": ([_Q16, _OR_MIN], (16, 512, 512)),
    "q16_unroll1": ([_Q16, _UNROLL1], (16, 512, 512)),
    "q16_unroll4": ([_Q16, _replace(_J_LOOP, _J_LOOP.replace("unroll 2", "unroll 4"))],
                    (16, 512, 512)),
}
# name -> edits of csrc/cross_tail.cu's wide route: output channels a thread
# (threads a block), rows of chains a pass
_WIDE_COLS = "constexpr int kWThreads = 128;\nconstexpr int kWCols = 2;"
_WIDE_ROWS = "for (; j0 + 32 <= Kp; j0 += 32)\n        wide_rows<32, kArg>"
WIDE_VARIANTS = {
    "shipped": [],
    "cols1_256": [_replace(_WIDE_COLS, "constexpr int kWThreads = 256;\n"
                                       "constexpr int kWCols = 1;")],
    "cols4_64": [_replace(_WIDE_COLS, "constexpr int kWThreads = 64;\n"
                                      "constexpr int kWCols = 4;")],
    "rows16": [_replace(_WIDE_ROWS, "for (; j0 + 16 <= Kp; j0 += 16)\n"
                                    "        wide_rows<16, kArg>")],
}
# the shipped wide kernel on other grids (blocks; WIDE_BLOCKS is shipped)
WIDE_GRIDS = (1056, 512, 264)
# the shipped kernel with other spans: name -> span in chunks of 64 points
# (None: launch_grid's); "one_span" walks the whole cloud a block, "span4"
# 256 points a block, as the kernel before this design sliced it
CHAMFER_SPANS = {"launch_grid": None, "one_span": 1 << 30, "span4": 4}


def build(variants, source, out_dir):
    """Write each variant of ``source`` and start its build; returns a
    function that waits for the builds and gives name -> CDLL."""
    from mocopci_torch.kernels import _lib

    with open(os.path.join(_lib.CSRC, source)) as f:
        base = f.read()
    procs = {}
    for name, edits in variants.items():
        d = os.path.join(out_dir, f"{source.split('.')[0]}_{name}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_lib.CSRC, d)
        src = base
        for edit in edits:
            src = edit(src)
        with open(os.path.join(d, source), "w") as f:
            f.write(src)
        lib = os.path.join(d, "lib.so")
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", d, "-o", lib,
               os.path.join(d, source), os.path.join(d, "common.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))

    def finish():
        libs = {}
        for name, (lib, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"variant {name} of {source} did not build:\n{log}")
            # ptxas: each kernel's registers and spills
            for line in log.splitlines():
                if "Compiling entry" in line:
                    kernel = line.split("'")[1][-60:]
                elif "registers" in line or "spill" in line:
                    print(f"variant {name} of {source}: {kernel}: {line.strip()}", flush=True)
            libs[name] = ctypes.CDLL(lib)
        return libs
    return finish


def device_us(fn, reps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA) / reps
    return f"{us:.3f}" if us > 0 else "not measured"


def in_turns(calls, reps):
    """name -> (device us, device us), the names timed in turns, then in
    reverse order."""
    first = {name: device_us(fn, reps) for name, fn in calls.items()}
    second = {name: device_us(fn, reps) for name, fn in reversed(list(calls.items()))}
    return {name: (first[name], second[name]) for name in calls}


def time_tail(libs, dev, reps):
    from mocopci_torch.kernels import _lib
    from mocopci_torch.kernels.transformer_tail import fwd_grid, transformer_tail_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B in (3, 6):
        N = M = 2048
        K, D = 16, 64
        table = torch.randn(B, M, 3 + 2 * D, generator=gen, device=dev)
        xq = torch.randn(B, N, 3, generator=gen, device=dev)
        q = torch.randn(B, N, D, generator=gen, device=dev)
        ws = []
        for ci in (3, D, D, D):
            ws += [torch.randn(ci, D, generator=gen, device=dev) * ci ** -0.5,
                   torch.randn(D, generator=gen, device=dev) * 0.1]
        idx = torch.randint(0, M, (B, N, K), generator=gen, device=dev, dtype=torch.int32)
        want = transformer_tail_plain(table, idx, xq, q, *ws)
        calls, outs = {}, {}
        for name, lib in libs.items():
            fn = lib.mocopci_transformer_tail
            fn.argtypes, fn.restype = _lib.SIGNATURES["transformer_tail"], ctypes.c_int
            out = torch.empty(B, N, D, device=dev)

            def call(fn=fn, out=out):
                if fn(table.data_ptr(), idx.data_ptr(), xq.data_ptr(), q.data_ptr(),
                      *(t.data_ptr() for t in ws), out.data_ptr(), B, M, N, K, D,
                      fwd_grid(B, N, K), stream):
                    raise RuntimeError("launch failed")
            call()
            torch.cuda.synchronize()
            outs[name], calls[name] = out.clone(), call
        # the general route at the same (K, D): PR 1's kernel, PR 1's bits
        general = libs["shipped"].mocopci_transformer_tail_general
        general.argtypes = _lib.SIGNATURES["transformer_tail_general"]
        general.restype = ctypes.c_int
        pr1 = torch.empty(B, N, D, device=dev)
        if general(table.data_ptr(), idx.data_ptr(), xq.data_ptr(), q.data_ptr(),
                   *(t.data_ptr() for t in ws), pr1.data_ptr(), B, M, N, K, D, stream):
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        tol = 1e-4 * (1 + float(want.abs().max()))
        for name, (a, b) in in_turns(calls, reps).items():
            err = float((outs[name] - want).abs().max())
            same = torch.equal(outs[name].view(torch.int32), outs["shipped"].view(torch.int32))
            same1 = torch.equal(outs[name].view(torch.int32), pr1.view(torch.int32))
            print(f"tail fwd variant {name} (B, N, K, D) {(B, N, K, D)}: device us {a} / {b}; "
                  f"max_abs_err {err:.3e} (tol {tol:.1e}), bit-equal to the shipped kernel {same}, "
                  f"to the general route's (PR 1's kernel) {same1}", flush=True)
            if err > tol:
                raise SystemExit(f"tail variant {name} disagrees with the plain version")


def time_chamfer(libs, dev, reps):
    from mocopci_torch.kernels import _lib
    from mocopci_torch.kernels.chamfer_pair import CHUNK, INF_KEY, INT_MAX, index_bits, launch_grid

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for G, N, M in ((30, 8192, 8192), (3, 8192, 8192), (12, 2048, 2048)):
        p1 = torch.randn(G, N, 3, generator=gen, device=dev) * 10.0
        p2 = torch.randn(G, M, 3, generator=gen, device=dev) * 10.0
        chunks = -(-M // CHUNK)
        threads, span0, _, _ = launch_grid(G, N, M)
        runs = [(name, "shipped", threads, span0 if s is None else min(s, chunks))
                for name, s in CHAMFER_SPANS.items()]
        for name, (_, tiling) in CHAMFER_VARIANTS.items():
            if name != "shipped":
                t, sp, _, _ = launch_grid(G, N, M, *tiling)
                runs.append((name, name, t, sp))
        calls, keys = {}, {}
        for name, lib_name, threads_r, span in runs:
            fn = libs[lib_name].mocopci_chamfer_pair
            fn.argtypes, fn.restype = _lib.SIGNATURES["chamfer_pair"], ctypes.c_int
            # filled for any merge: plain stores overwrite, atomicMin merges
            k12 = torch.full((G, N), INT_MAX, dtype=torch.int32, device=dev)
            k21 = torch.full((G, M), INF_KEY, dtype=torch.int32, device=dev)

            def call(fn=fn, threads_r=threads_r, span=span, k12=k12, k21=k21):
                if fn(p1.data_ptr(), p2.data_ptr(), G, N, M, index_bits(N, M), threads_r, span,
                      k12.data_ptr(), k21.data_ptr(), stream):
                    raise RuntimeError("launch failed")
            call()
            torch.cuda.synchronize()
            keys[name], calls[name] = (k12.clone(), k21.clone()), call
        ref = keys["launch_grid"]
        for name, (a, b) in in_turns(calls, reps).items():
            same = all(torch.equal(x, y) for x, y in zip(keys[name], ref))
            threads_r, span = {n: (t, sp) for n, _, t, sp in runs}[name]
            print(f"chamfer_pair variant {name} (G, N, M) {(G, N, M)}, threads {threads_r}, span "
                  f"{span} chunks: device us {a} / {b}; keys equal to the shipped launch's {same}",
                  flush=True)
            if not same:
                raise SystemExit(f"chamfer variant {name} gives other keys")


def time_wide(libs, dev, reps):
    from mocopci_torch.kernels import _lib
    from mocopci_torch.kernels.cross_tail import WIDE_BLOCKS, cross_tail_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    B, N, K, C = 1, 1024, 32, 256
    tab = torch.randn(B, N, C, generator=gen, device=dev)
    base = torch.randn(B, N, C, generator=gen, device=dev)
    w = torch.randn(C, C, generator=gen, device=dev) * C ** -0.5
    b = torch.randn(C, generator=gen, device=dev) * 0.1
    idx = torch.randint(0, N, (B, N, K), generator=gen, device=dev, dtype=torch.int32)
    want = cross_tail_plain(tab, idx, base, w, b)
    calls, outs = {}, {}
    runs = [(name, WIDE_BLOCKS) for name in libs] + [("shipped", g) for g in WIDE_GRIDS
                                                    if g != WIDE_BLOCKS]
    for name, grid in runs:
        fn = libs[name].mocopci_cross_tail_wide
        fn.argtypes, fn.restype = _lib.SIGNATURES["cross_tail_wide"], ctypes.c_int
        out = torch.empty(B, N, C, device=dev)
        amax = torch.empty(B, N, C, dtype=torch.uint8, device=dev)

        def call(fn=fn, out=out, grid=grid, amax=None):
            if fn(tab.data_ptr(), idx.data_ptr(), base.data_ptr(), w.data_ptr(), b.data_ptr(),
                  out.data_ptr(), 0 if amax is None else amax.data_ptr(), B, N, N, K, C, C,
                  grid, stream):
                raise RuntimeError("launch failed")
        call(amax=amax)
        torch.cuda.synchronize()
        key = f"{name} grid {grid}"
        outs[key], calls[key] = (out.clone(), amax.clone()), call
    ref = outs[f"shipped grid {WIDE_BLOCKS}"]
    tol = 1e-4 * (1 + float(want.abs().max()))
    for key, (a, b_) in in_turns(calls, reps).items():
        err = float((outs[key][0] - want).abs().max())
        same = (torch.equal(outs[key][0].view(torch.int32), ref[0].view(torch.int32))
                and torch.equal(outs[key][1], ref[1]))
        print(f"wide cross tail variant {key} (B, N, K, C, C2) {(B, N, K, C, C)}: device us "
              f"{a} / {b_}; max_abs_err {err:.3e} (tol {tol:.1e}), output and argmax "
              f"bit-equal to the shipped kernel's {same}", flush=True)
        if err > tol or not same:
            raise SystemExit(f"wide variant {key} disagrees")


def card_checks(name):
    """This tree copied with the tail variant ``name`` in place of
    ``csrc/transformer_tail.cu``; there, the card tests of the tail and the
    tiny model and a whole ``chip_smoke.py`` run (the forward's CD to the
    CPU in both kNN modes, every kernel row).  Returns non-zero if any
    failed."""
    d = os.path.join(ROOT, "build", "variants", f"tree_{name}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT, d, ignore=shutil.ignore_patterns(
        ".git", "build", "outputs", "chiprun_out", "__pycache__", ".jax_cache*"))
    src = os.path.join(d, "mocopci_torch", "csrc", "transformer_tail.cu")
    with open(src) as f:
        text = f.read()
    for edit in TAIL_VARIANTS[name]:
        text = edit(text)
    with open(src, "w") as f:
        f.write(text)
    tests = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                            "tests/test_torch_cuda.py", "-k", "tiny or transformer_tail"],
                           cwd=d, capture_output=True, text=True)
    print(f"card checks of {name}: the tail and tiny-model card tests rc {tests.returncode}:\n"
          + "\n".join(line for line in tests.stdout.splitlines()
                      if "passed" in line or "failed" in line or "Error" in line), flush=True)
    smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d, capture_output=True, text=True)
    keep = ("transformer_tail", "CD card vs cpu", "train parity: loss", "SystemExit", "Error")
    lines = (smoke.stdout + smoke.stderr).splitlines()
    print(f"card checks of {name}: chip_smoke.py rc {smoke.returncode}:\n"
          + "\n".join(line[:400] for line in lines if any(k in line for k in keep))
          + "\n" + "\n".join(line[:300] for line in lines[-2:]), flush=True)
    return tests.returncode or smoke.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("tail", "chamfer", "wide"))
    ap.add_argument("--card-checks", metavar="TAIL_VARIANT", choices=sorted(TAIL_VARIANTS),
                    help="instead of timing: the card tests and chip_smoke.py on a copy of "
                         "this tree with that tail variant in place")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_variant_timing: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.card_checks:
        return 1 if card_checks(args.card_checks) else 0
    out_dir = os.path.join(ROOT, "build", "variants")
    dev = torch.device("cuda")
    tail = (build(TAIL_VARIANTS, "transformer_tail.cu", out_dir)
            if args.only in (None, "tail") else None)
    chamfer = (build({name: edits for name, (edits, _) in CHAMFER_VARIANTS.items()},
                     "chamfer_pair.cu", out_dir) if args.only in (None, "chamfer") else None)
    wide = (build(WIDE_VARIANTS, "cross_tail.cu", out_dir)
            if args.only in (None, "wide") else None)
    if tail is not None:
        time_tail(tail(), dev, args.reps)
    if chamfer is not None:
        time_chamfer(chamfer(), dev, args.reps)
    if wide is not None:
        time_wide(wide(), dev, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
