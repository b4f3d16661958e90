#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MoCoPCI on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --parent TREE   # and another checkout's kernels beside

Phases, each fatal on failure:
  1. probe: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build every kernel from ``mocopci_torch/csrc`` (one nvcc per source);
  3. each kernel against its plain PyTorch twin on the card, at the shapes of
     the main path, with median times (CUDA events) and the least time the
     card could take (bytes over 3.35 TB/s or operations over 67 TFLOP/s f32,
     or for products on the tensor cores at float32 grade over 495 / 3
     TFLOP/s, whichever is larger; H100 SXM data sheet);
  4. the forward, once per kNN mode (approx, the default, then exact):
     ``interpolate`` at the production ``ModelConfig()`` on 3 synthetic frame
     pairs, the launch counts read, the Chamfer distance to the same model
     run with ``device="cpu"`` (the plain twins), the median forward time and
     peak memory; one profiled forward in approx mode (device time per
     kernel, the device's busy share, each FPS launch's shape and device ms,
     each ``knn_approx``, eval attention, cost-volume tail and transformer
     tail call's shape, device ms, bound and lost time, the SM clock before
     and after), and one in exact mode (each exact ``knn`` call's shape,
     route, device ms, bound and lost time, sums by route, and the queries
     that took its overflow route);
  5. the eval path: ``eval_step`` (forward, CD, EMD) on one sample, its
     metrics against the CPU's, the times of its parts, then the eval CLI
     ``python -m mocopci_torch.cli.test --synthetic 3`` in-process;
  6. the stress path: the eval forward at ``stress_model_config(16384)`` and
     ``(32768)``, B=1, on ``bench.py``'s stress inputs (paths
     ``stress_16384``, ``stress_32768``; FPS above 8192 points on its
     cluster routes): launches, every FPS call bit-equal to its plain
     version on the same inputs, the median of 3 forwards and their peak
     memory, one profiled forward (busy share, each FPS launch and FPS's
     share, the other kernels' device ms), the attention kernel's launches
     over more than 4096 keys; at 16384 the forward against the
     CPU (CD <= 1e-4 a frame) and in exact mode, at 32768 ``eval_step`` once;
  7. the train path: ``create_train_state`` at ``ModelConfig()`` (seed 0) and
     6 ``train_step``s at B=2 on synthetic pairs (finite losses, launches,
     median step time of the last 5, peak memory, one profiled step with
     each train attention backward's shape, route and device ms, each FPS
     launch's shape and device ms, and each attention forward's,
     ``knn_approx``'s, cost-volume tail forward's, ``chamfer_pair``'s and
     transformer tail's (both directions) shape, device ms, bound and lost
     time); one
     step at ``tiny_model_config(4096)`` on the card against the CPU (loss
     components within rel 1e-4, the whole gradient within rel L2 1e-3, each
     leaf within 5e-2: see ``run_train_parity``);
     one train step at ``refine_k = 8`` (the tail's general routes);
     the train CLI for one epoch, then ``--resume`` to a second;
     the dense-stress train step (paths ``stress_train_16384`` and
     ``stress_train_32768``): ``create_train_state`` at
     ``stress_model_config(n)``, ``TrainConfig(batch_size=1)``, and 4
     ``train_step``s at B=1 on synthetic pairs, approx kNN, dropout on
     (finite losses, every train kernel launched with FPS on its cluster
     routes, the attention launches over more than 4096 keys, at 32768 the
     cost-volume tail's wide routes both ways, the median of the last 3
     steps, peak memory, one profiled step with its busy share and top
     device ops); remat (path ``train_remat``: ``loss_and_grads`` at
     ``ModelConfig()``, B=2, dropout on, with and without remat from the same
     weights and generator seed: the loss bit-equal, the gradients within
     relative L2 1e-6 and each leaf within 1e-4, the running statistics and
     the generator's state equal, every forward kernel of the four stages
     launched again by the recompute; then 5 ``train_step``s each, their
     median and peak memory; path ``stress_train_32768_remat``: the 32768
     stress step with remat, 3 steps, median and peak memory); data
     parallelism over NCCL at world size 1 in ``torchrun``'s environment
     (path ``train_dp1``: ``dp_train_step`` bit-equal to ``train_step``
     with dropout off, both under PyTorch's deterministic algorithms, a
     second ``train_step`` repeating the first's bits; one DP step with
     dropout on, finite; path ``train_cli_dp``: the train CLI with
     ``--dp_impl shard_map --remat --grad_accum 2 --multihost`` for one
     epoch, then ``--resume``); each new path's seconds logged;
  8. the op paths that reach the last four kernels (path "ops"): approx
     selection (``_topk_min_indices``) on the fusion query's distances at B=2,
     exact ``ops.knn`` over a 131072-point sweep (the blocked route), the
     Chamfer VJP between 64-point and 8192-point clouds (the one-hot
     scatter), ``build_pair_planes`` forward and backward at the fusion shape;
     each result against its plain route or the CPU;
  9. the summary lines: the card, the per-kernel JSON line, the contract line.
The train kernels (scatter-add, train attention forward and backward, the two
tails' backwards, the train fusion head forward and backward, the fusion
planes) are checked in phase 3 at the train step's shapes, each run twice to
show it repeats its bits; the attention backward on both its routes (one
pass up to head dim 64 and the wide route at the CrossFrameBlock's 256,
each with and without dropout, beside SDPA's float32 backward without
dropout); the cost-volume tail's forward with its argmax against the twin's
first argmax, and its backward from that argmax.  The eval attention at
the eval forward's six call shapes, on both its routes (one pass up to head
dim 64, ``attention_wide`` above), each within 1e-5 of its plain version with
its bits repeated.  FPS at the train step's
(6, 8192) -> 2048 and the encoder's pyramid (2, 8192) -> 2048/512/256/64 in
one launch, each bit-equal to its plain version; above 8192 points FPS's
cluster routes at the stress forwards' calls, (2, n) -> n/4, n/16, n/32,
n/128 and (3, n) -> n/4 for n = 32768 and 16384, bit-equal, each timed
in µs a step beside the one-block route at 8192 (and, with
``--parent``, beside that tree's FPS at 8192); the cost-volume tail's wide
route ``cross_tail_wide`` at cross3 of the 32768-point forward, (1, 1024)
queries of K = 32 over C = C2 = 256, within 1e-4 (1 + max |out|) of its
plain version, and its wide backward ``cross_tail_bwd_wide`` there against
``cross_tail_bwd_plain`` (after the scatter, within 1e-4 over max(1,
|value|)), its bits repeated, its grid, shared memory and partials logged
(with ``--parent``, d_rows and d_base bit-equal to that tree's wide
backward, the two timed in turns), its general form at (K, C, C2) = (32,
128, 512) against the plain version, and forced at C = C2 = 64 against the
tiled backward (d_rows and d_base bit-equal, dW and db within 1e-5 (1 +
max)) at (1, 1024, 32) and at the 8192-point step's (6, 2048, 32), timed
there beside the tiled route in turns; the
train attention (forward and backward, rate 0.05 and 0) and the eval
attention at the 32768-point calls over 8192 keys, (8 and 40, 8192, 8192,
8), their bits repeated and their first 2 groups against the plain
versions, each timed beside its bound and the plain version on those
groups (``keys_8192`` in the kernel rows).  ``knn_approx`` also at the
train step's largest call, (12, 8192, 8192, 3) k=32, and its cosine calls,
(2, 2048, 2048, 64) k=16; the wide attention forward at rate 0.05 and 0, its
bits repeated; the transformer tail on both routes of both directions (the
tiled routes at refine_k 16, the general routes at 8), the forward within
1e-4 (1 + max |out|) of its plain version with its bits repeated;
``chamfer_pair`` at the eval's (3, 8192, 8192) and at the train step's four
calls, its keys bit-equal to the plain version's, beside its f32 bound and
its issue floor (``chamfer_floor``).  Exact ``knn`` at the fusion query,
its indices equal to the plain version's, with the queries that took its
overflow route; ``fusion_pair`` at the eval's (3, 8192, 64) and a ragged (3,
400, 8), its planes within 1e-5 of ``pair_planes``' and bit-equal to the
planes entry's, its logits within 1e-4 (1 + max |logit|) of the plain
version, its bound at 3xTF32 with the f32 one beside.  With ``--parent TREE``
(another checkout, for example the parent commit unpacked with ``git
archive``) that tree's ``PARENT_SOURCES`` are built alone and timed beside
this tree's at the same shapes, in turns (its pyramid as that tree samples
it: a launch a level and the gathers between, where it has no pyramid
entry; the wide attention forward beside SDPA too; the eval attention at
its six shapes beside SDPA; the cost-volume tail's forward at the eval's
(3, 2048, 32) and, with its argmax, the step's (6, 2048, 32), its output
and argmax held bit-equal to that tree's; the transformer tail's forward on
both routes at the eval's 3 and the step's 6 frames (its general route
bit-equal to that tree's), ``chamfer_pair`` at each of its shapes, its keys
bit-equal to that tree's, the tail's backward bit-equal to that
tree's, exact ``knn``'s indices equal to that tree's, ``fusion_pair``'s and
``fusion_pair_planes``' planes and the train fusion head forward's output
and statistics bit-equal to that tree's; where that tree has the wide route
of the cost-volume tail, it at cross3, bit-equal to that tree's).  The op kernels (select_min_k, the one-hot scatter,
the pair planes' rows forward and backward) at the shapes of phase 8; the
one-hot scatter beside ``torch.zeros(...).index_add_`` at both its shapes,
by CUDA events and by device time under torch.profiler.
Every path runs with the launch counts set to 0 just before it and read just
after; every kernel must launch on at least one path.
Exits non-zero, printing no result, without a card or without the package.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
PEAK_F32_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3   # float32-grade products on the tensor cores (3xTF32)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
REPS = 20
F32, I32 = 4, 4


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps=REPS) -> float:
    """Median of ``reps`` timings of ``fn`` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_us(fn, reps=REPS):
    """Mean device time of one call of ``fn`` in µs, every kernel it launches
    summed, over ``reps`` calls under torch.profiler; "not measured" when the
    profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA) / reps
    return f"{us:.3f}" if us > 0 else "not measured"


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS, tc_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and the operations'
    time, ``flops`` / ``peak`` plus ``tc_flops`` (products on the tensor cores
    at float32 grade beside them) / 495 / 3 TFLOP/s."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / peak + tc_flops / PEAK_3XTF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def add_row(rows, name, source, replaces, launch, plain, library, nbytes, flops, err, tol,
            reps=REPS, peak=PEAK_F32_FLOPS, tc_flops=0.0):
    """Time a kernel, its plain version and the library call; one JSON row.
    Fails when the kernel's error against its plain version exceeds ``tol``."""
    ms, plain_ms = median_ms(launch, reps), median_ms(plain, max(3, reps // 4))
    lib_ms = median_ms(library, reps) if library is not None else None
    b_ms, b_by = bound(nbytes, flops, peak, tc_flops)
    log(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:.1e}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {lib_ms} bound_ms {b_ms:.5f} ({b_by})")
    if not err <= tol:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})


def beside(parent_fn, fn, reps=REPS):
    """The parent's call against this tree's, in turns (parent, here, here,
    parent) by CUDA events, then each one's device µs under the profiler (no
    host time between launches)."""
    a, b, c, d = (median_ms(f, reps) for f in (parent_fn, fn, fn, parent_fn))
    return (f"the parent's {a:.4f} / {d:.4f} ms against {b:.4f} / {c:.4f} ms here, in turns; "
            f"device us {device_us(parent_fn, reps)} against {device_us(fn, reps)}")


def fps_steps(row, npoints):
    """The µs a step of an FPS row: its ms over the steps of its levels."""
    row["us_per_step"] = 1e3 * row["ms"] / max(1, sum(n - 1 for n in npoints))
    log(f"kernel {row['name']}: {row['us_per_step']:.4f} us a step over "
        f"{sum(n - 1 for n in npoints)} steps")


def frames(dataset, index, dev):
    inputs, _ = dataset[index]
    return [torch.from_numpy(f).to(dev) for f in inputs]


def check_kernels(kernels, cfg, dataset, dev, parent=None):
    """Every kernel against its twin at the main path's shapes for ``cfg``;
    returns the per-kernel JSON rows (launch counts filled in later);
    ``parent`` (a :class:`Parent`), when given, its FPS and cost-volume tail
    forward timed beside this tree's."""
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.ops.distance import _normalise

    mods = {name: importlib.import_module(f"mocopci_torch.kernels.{name}")
            for name in ("fps", "knn", "knn_approx", "attention", "cross_tail",
                         "transformer_tail", "fusion_pair", "chamfer_pair")}
    c0, c1, c2, c3, _ = cfg.enc_channels
    n0, (n1, n2, n3, _) = cfg.npoints, cfg.pyramid
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    f = frames(dataset, 0, dev)                      # 4 frames (n0, 3)
    rows = []

    def row(name, module, launch, plain, library, nbytes, flops, err, tol):
        add_row(rows, name, module.SOURCE, module.REPLACES, launch, plain, library, nbytes,
                flops, err, tol)

    # fps: the refine head's and the loss's sampling in the train step, the
    # B=2 step's 3 frames each, n0 -> refine_npoint; then the encoder's
    # pyramid on both clouds of an eval pair, n0 -> cfg.pyramid, in one launch
    G, npt = TrainConfig().batch_size * cfg.n_frames, cfg.refine_npoint
    xyz = torch.stack([f[1], f[2], f[3]] * 2).contiguous()
    mism = int((kernels.fps(xyz, npt) != kernels.fps_plain(xyz, npt)).sum())
    log(f"fps {tuple(xyz.shape)} -> {npt}: index mismatches {mism}")
    row("fps", mods["fps"], lambda: kernels.fps(xyz, npt),
        lambda: kernels.fps_plain(xyz, npt), None, xyz.numel() * F32 + G * npt * I32,
        9.0 * G * (npt - 1) * n0, float(mism), 0.0)
    fps_steps(rows[-1], [npt])
    pair = xyz[:2].contiguous()
    level0 = median_ms(lambda: kernels.fps(pair, n1))
    log(f"fps {tuple(pair.shape)} -> {n1} (the encoder's level 0 alone): {level0:.4f} ms, "
        f"{1e3 * level0 / (n1 - 1):.4f} us a step")
    levels = tuple(cfg.pyramid)
    got = kernels.fps_pyramid(pair, levels)
    mism = sum(int((a != b).sum()) for a, b in zip(got, kernels.fps_pyramid_plain(pair, levels)))
    log(f"fps_pyramid {tuple(pair.shape)} -> {levels}: index mismatches {mism}")
    add_row(rows, "fps_pyramid", mods["fps"].SOURCE, mods["fps"].REPLACES_PYRAMID,
            lambda: kernels.fps_pyramid(pair, levels),
            lambda: kernels.fps_pyramid_plain(pair, levels), None,
            pair.numel() * F32 + 2 * sum(levels) * I32,
            9.0 * 2 * sum((n - 1) * m for n, m in zip(levels, (n0,) + levels)), float(mism), 0.0)
    fps_steps(rows[-1], levels)
    if parent is not None:
        same = all(torch.equal(a, b) for a, b in zip(parent.fps_pyramid(pair, levels), got))
        same1 = torch.equal(parent.fps(xyz, npt), kernels.fps(xyz, npt))
        log(f"fps_pyramid {tuple(pair.shape)} -> {levels} (indices equal {same}): "
            + beside(lambda: parent.fps_pyramid(pair, levels),
                     lambda: kernels.fps_pyramid(pair, levels)))
        log(f"fps {tuple(xyz.shape)} -> {npt} (indices equal {same1}): "
            + beside(lambda: parent.fps(xyz, npt), lambda: kernels.fps(xyz, npt)))
        if not (same and same1):
            raise SystemExit("fps: the parent's indices differ from this tree's")

    # knn: the fusion head's batched self + cross query, 2 x 3 frames
    k = cfg.fusion_k
    p1 = torch.stack([f[1], f[1], f[2]] * 2).contiguous()
    p2 = (p1 + rnd(*p1.shape, scale=0.05)).contiguous()
    got = kernels.knn_exact(p1, p2, k, "euclidean")
    mism = int((got != kernels.knn_plain(p1, p2, k, "euclidean")).sum())
    # cosine half of the up_1 cost volume, features of width c1
    kc = cfg.flow_nei // 2
    fq, fr = (_normalise(rnd(1, n1, c1)).contiguous() for _ in range(2))
    cg, cw = kernels.knn_exact(fq, fr, kc, "cosine"), kernels.knn_plain(fq, fr, kc, "cosine")
    d = mods["knn"].distances(fq.double(), fr.double(), "cosine")
    gap = float((d.gather(2, cg.long()) - d.gather(2, cw.long())).abs().max())
    log(f"knn euclidean {tuple(p1.shape)} k={k}: index mismatches {mism}; cosine "
        f"{tuple(fq.shape)} k={kc}: mismatches {int((cg != cw).sum())}, "
        f"max distance gap {gap:.3e}")
    if mism:
        raise SystemExit("knn: Euclidean indices differ from the plain version")
    mods["knn"].reset_overflows()
    row("knn_exact", mods["knn"],
        lambda: kernels.knn_exact(p1, p2, k, "euclidean"),
        lambda: kernels.knn_plain(p1, p2, k, "euclidean"),
        lambda: torch.topk(torch.cdist(p1, p2), k, dim=-1, largest=False),
        2 * p1.numel() * F32 + p1.shape[0] * n0 * k * I32,
        8.0 * p1.shape[0] * n0 * n0, gap, 1e-6)
    # the queries that took the overflow route over the row's runs (none expected here)
    rows[-1]["overflow_queries"] = mods["knn"].overflows()
    log(f"kernel knn_exact: {rows[-1]['overflow_queries']} queries took the overflow route "
        f"over the row's runs")
    if parent is not None:
        same = torch.equal(parent.knn(p1, p2, k, "euclidean"), got)
        log(f"knn exact {tuple(p1.shape)} x {tuple(p2.shape)} k={k} (indices equal to the "
            f"parent's {same}): " + beside(lambda: parent.knn(p1, p2, k, "euclidean"),
                                           lambda: kernels.knn_exact(p1, p2, k, "euclidean")))
        # the dot route (the cosine half of up_1's cost volume), its spans merged
        same_c = torch.equal(parent.knn(fq, fr, kc, "cosine"), cg)
        log(f"knn exact cosine {tuple(fq.shape)} k={kc} (indices equal to the parent's "
            f"{same_c}; bound_ms {call_bound('knn', 1, n1, n1, c1, k=kc):.5f}): "
            + beside(lambda: parent.knn(fq, fr, kc, "cosine"),
                     lambda: kernels.knn_exact(fq, fr, kc, "cosine")))
        if not (same and same_c):
            raise SystemExit("knn: the exact indices differ from the parent's")

    # knn_approx: the same fusion query (the fold is engaged: M > 1024), then
    # the cosine half of the up_1 cost volume
    got_a = kernels.knn_approx(p1, p2, k, "euclidean")
    mism = int((got_a != kernels.knn_approx_plain(p1, p2, k, "euclidean")).sum())
    cg, cw = kernels.knn_approx(fq, fr, kc, "cosine"), kernels.knn_approx_plain(fq, fr, kc, "cosine")
    gap = float((d.gather(2, cg.long()) - d.gather(2, cw.long())).abs().max())
    recall = float((got_a[..., :, None] == got[..., None, :]).any(-1).float().mean())
    # a key keeps 23 - idx_bits mantissa bits: kernel and twin sum the dot in
    # another order, so a swap may span two quantisation steps of d <= 2
    qtol = 4.0 * 2.0 ** (mods["knn_approx"].tiling(n1, kc)[1] - 23)
    log(f"knn_approx euclidean {tuple(p1.shape)} k={k}: index mismatches {mism}, recall "
        f"against knn_exact {recall:.5f}; cosine {tuple(fq.shape)} k={kc}: mismatches "
        f"{int((cg != cw).sum())}, max distance gap {gap:.3e} (tol {qtol:.1e})")
    if mism:
        raise SystemExit("knn_approx: Euclidean indices differ from the plain version")
    row("knn_approx", mods["knn_approx"],
        lambda: kernels.knn_approx(p1, p2, k, "euclidean"),
        lambda: kernels.knn_approx_plain(p1, p2, k, "euclidean"),
        lambda: torch.topk(torch.cdist(p1, p2), k, dim=-1, largest=False),
        2 * p1.numel() * F32 + p1.shape[0] * n0 * k * I32,
        8.0 * p1.shape[0] * n0 * n0, gap, qtol)
    check_knn_approx_step(kernels, cfg, p1, p2, rnd, parent)

    # attention: the eval forward's six call shapes (G, N, M, D), each called
    # twice a forward (its profiled forward logs them): 5 frames x 8 heads at
    # n1 and n2, 8 heads at n1, n2 and n3, and a head of width c3 at n3 (the
    # wide route); each within 1e-5 of its plain version, its bits repeated,
    # its route counted; with a parent, timed beside that tree's kernel and
    # SDPA
    mod = mods["attention"]
    for G, N, D in ((40, n1, c1 // 8), (40, n2, c2 // 8), (8, n1, c1 // 8), (8, n2, c2 // 8),
                    (8, n3, c3 // 8), (8, n3, c3)):
        q, kk, v = rnd(G, N, D), rnd(G, N, D), rnd(G, N, D)
        s = D ** -0.5
        kernels.reset_launches()
        att = kernels.attention(q, kk, v, s)
        launched = {n: c for n, c in kernels.LAUNCHES.items() if c}
        e = float((att - kernels.attention_plain(q, kk, v, s)).abs().max())
        same = bits_equal([att], [kernels.attention(q, kk, v, s)])
        wide = D > mod.MAX_ONE_PASS_D
        b_ms = call_bound("attn", G, N, N, D, wide=wide)
        msg = (f"attention (G, N, M, D) {(G, N, N, D)}: route {mod.route(D)}, max_abs_err "
               f"{e:.3e}, repeat bit-equal {same}, bound_ms {b_ms:.5f}")
        if parent is not None:
            gap = float((parent.attention(q, kk, v, s) - att).abs().max())
            sdpa = device_us(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kk, v, scale=s))
            msg += (f"; the parent's output differs by {gap:.3e}: "
                    + beside(lambda: parent.attention(q, kk, v, s),
                             lambda: kernels.attention(q, kk, v, s))
                    + f"; SDPA device us {sdpa}")
        log(msg)
        if e > 1e-5 or not same or launched != {mod.route(D): 1}:
            raise SystemExit(f"attention {(G, N, D)}: disagrees with its plain version, does "
                             f"not repeat its bits or took another route ({launched})")
    for name, (G, N, D) in (("attention", (40, n1, c1 // 8)), ("attention_wide", (8, n3, c3))):
        q, kk, v = rnd(G, N, D), rnd(G, N, D), rnd(G, N, D)
        s = D ** -0.5
        err = float((kernels.attention(q, kk, v, s)
                     - kernels.attention_plain(q, kk, v, s)).abs().max())
        wide = name == "attention_wide"
        add_row(rows, name, mod.SOURCE, mod.REPLACES,
                lambda: kernels.attention(q, kk, v, s),
                lambda: kernels.attention_plain(q, kk, v, s),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, v, scale=s),
                4 * q.numel() * F32, G * N * N * (4 * D if wide else 4 * D + 3), err, 1e-5,
                peak=PEAK_3XTF32_FLOPS if wide else PEAK_F32_FLOPS)

    # cross_tail: bid / fe at up_1, 3 folded frames x n1 queries
    G, M, N, K, C = 3, n1, n1, cfg.flow_nei, c1
    tab, base = rnd(G, M, C), rnd(G, N, C)
    w, b = rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1)
    idx = torch.randint(0, M, (G, N, K), generator=gen, device=dev, dtype=torch.int32)
    out = kernels.cross_tail_plain(tab, idx, base, w, b)
    err = float((kernels.cross_tail(tab, idx, base, w, b) - out).abs().max())
    row("cross_tail", mods["cross_tail"],
        lambda: kernels.cross_tail(tab, idx, base, w, b),
        lambda: kernels.cross_tail_plain(tab, idx, base, w, b), None,
        (tab.numel() + base.numel() + w.numel() + b.numel() + out.numel()) * F32
        + idx.numel() * I32,
        G * N * K * (2 * C * C + 2 * C + 3 * C), err, 1e-4 * (1 + float(out.abs().max())))
    if parent is not None:      # the redesign keeps the parent's bits
        same = bits_equal([parent.cross_tail_fwd(tab, idx, base, w, b)],
                          [kernels.cross_tail(tab, idx, base, w, b)])
        log(f"cross_tail fwd {tuple(idx.shape)} (bit-equal to the parent's {same}): "
            + beside(lambda: parent.cross_tail_fwd(tab, idx, base, w, b),
                     lambda: kernels.cross_tail(tab, idx, base, w, b)))
        if not same:
            raise SystemExit("cross_tail: the forward's bits differ from the parent's")

    # transformer_tail: the refine head, 3 frames x refine_npoint queries at
    # refine_k (the tiled route), then at refine_k = 8 (the general route);
    # each within 1e-4 (1 + max |out|) of its plain version, its bits
    # repeated, its route counted; with a parent, timed beside that tree's
    # forward at the eval's 3 and the train step's 6 frames (the general
    # route bit-equal to it)
    mod = mods["transformer_tail"]
    for name, K in (("transformer_tail", cfg.refine_k), ("transformer_tail_general", 8)):
        G, M, N, D = 3, cfg.refine_npoint, cfg.refine_npoint, c1
        table, xq, qq = rnd(G, M, 3 + 2 * D), rnd(G, N, 3), rnd(G, N, D)
        ws = []
        for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
            ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
        idx = torch.randint(0, M, (G, N, K), generator=gen, device=dev, dtype=torch.int32)
        out = kernels.transformer_tail_plain(table, idx, xq, qq, *ws)
        kernels.reset_launches()
        tail = kernels.transformer_tail(table, idx, xq, qq, *ws)
        launched = {n: c for n, c in kernels.LAUNCHES.items() if c}
        err = float((tail - out).abs().max())
        same = bits_equal([tail], [kernels.transformer_tail(table, idx, xq, qq, *ws)])
        log(f"{name} (B, N, K, D) {(G, N, K, D)}: launches {launched}, max_abs_err {err:.3e}, "
            f"repeat bit-equal {same}")
        if launched != {name: 1} or not same:
            raise SystemExit(f"{name}: another route launched, or a run did not repeat its bits")
        nbytes, f32, tc = tail_fwd_work(G, M, N, K, D, name)
        add_row(rows, name, mod.SOURCE, mod.REPLACES,
                lambda: kernels.transformer_tail(table, idx, xq, qq, *ws),
                lambda: kernels.transformer_tail_plain(table, idx, xq, qq, *ws), None,
                nbytes, f32, err, 1e-4 * (1 + float(out.abs().max())), tc_flops=tc)
        if parent is None:
            continue
        for Gp in (3, 6):
            tb, xp, qp = rnd(Gp, M, 3 + 2 * D), rnd(Gp, N, 3), rnd(Gp, N, D)
            ip = torch.randint(0, M, (Gp, N, K), generator=gen, device=dev, dtype=torch.int32)
            mine = kernels.transformer_tail(tb, ip, xp, qp, *ws)
            theirs = parent.transformer_tail(tb, ip, xp, qp, *ws)
            same = bits_equal([theirs], [mine])
            err_p = float((kernels.transformer_tail_plain(tb, ip, xp, qp, *ws) - mine).abs().max())
            log(f"{name} (B, N, K, D) {(Gp, N, K, D)} (max_abs_err {err_p:.3e}; bit-equal to the "
                f"parent's {same}, apart by {float((theirs - mine).abs().max()):.3e}; bound_ms "
                f"{tail_fwd_bound(Gp, M, N, K, D, name):.5f}): "
                + beside(lambda: parent.transformer_tail(tb, ip, xp, qp, *ws),
                         lambda: kernels.transformer_tail(tb, ip, xp, qp, *ws)))
            # the general route is the parent's kernel: its bits must not move
            if err_p > 1e-4 * (1 + float(mine.abs().max())) or (
                    name == "transformer_tail_general" and not same):
                raise SystemExit(f"{name} {(Gp, N, K, D)} disagrees with its plain version or "
                                 "the parent's bits")

    # fusion_pair: 3 frames x n0 queries x 2k neighbours (the fusion kNN above),
    # then a ragged shape; the planes within 1e-5 (1 + max |plane|) of
    # pair_planes' (torch.sum may add the three squares in another order) and
    # bit-equal to the planes entry's and (with a parent) to that tree's, the
    # logits within 1e-4 (1 + max |logit|) of the plain version
    G, N, K2 = 3, n0, 2 * k
    pts1, pts2 = p1[:3], p2[3:]
    idx = torch.cat(torch.chunk(got, 2), dim=-1).contiguous()
    ws = []
    for ci, co in [(4, c1), (c1, c1), (c1, c2)]:
        ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
    for pp2, pidx, pp1 in ((pts2, idx, pts1),
                           (rnd(3, 900, 3, scale=5.0), torch.randint(
                               0, 900, (3, 400, 8), generator=gen, device=dev,
                               dtype=torch.int32), rnd(3, 400, 3, scale=5.0))):
        planes, logits = kernels.fusion_pair_plain(pp2, pidx, pp1, *ws)
        kp, kl = kernels.fusion_pair(pp2, pidx, pp1, *ws)
        err = float((kl - logits).abs().max())
        perr = float((kp - planes).abs().max())
        same = (perr <= 1e-5 * (1 + float(planes.abs().max())) and bits_equal(
            [kp], [mods["fusion_pair"].fusion_pair_planes_kernel(pp2, pidx, pp1)]))
        msg = (f"fusion_pair {tuple(pidx.shape)}: logits max_abs_err {err:.3e}, planes "
               f"max_abs_err {perr:.3e} (bit-equal to pair_planes "
               f"{bits_equal([kp], [planes])}), bit-equal to the planes entry's and within "
               f"1e-5 {same}")
        if parent is not None:
            theirs = parent.fusion_pair(pp2, pidx, pp1, *ws)
            same = same and bits_equal([theirs[0]], [kp])
            msg += (f", planes bit-equal to the parent's {bits_equal([theirs[0]], [kp])}, the "
                    f"parent's logits {float((theirs[1] - logits).abs().max()):.3e} from the "
                    "plain version: " + beside(lambda: parent.fusion_pair(pp2, pidx, pp1, *ws),
                                               lambda: kernels.fusion_pair(pp2, pidx, pp1, *ws)))
        log(msg)
        if not same or err > 1e-4 * (1 + float(logits.abs().max())):
            raise SystemExit(f"fusion_pair {tuple(pidx.shape)}: the planes moved or the "
                             "logits disagree with the plain version")
    planes, logits = kernels.fusion_pair_plain(pts2, idx, pts1, *ws)
    kp, kl = kernels.fusion_pair(pts2, idx, pts1, *ws)
    err = max(float((kp - planes).abs().max()), float((kl - logits).abs().max()))
    P = N * K2
    # the bound: the W2 and W3 products on the tensor cores at float32 grade,
    # layer 1, the biases, ReLUs, max and the planes at f32 (all at f32 beside)
    nbytes = ((pts1.numel() + pts2.numel() + sum(t.numel() for t in ws) + G * 5 * P) * F32
              + idx.numel() * I32)
    tc = G * P * 2.0 * (c1 * c1 + c1 * c2)
    f32 = G * P * (2.0 * 4 * c1 + 2 * (c1 + c1 + c2) + 9)
    add_row(rows, "fusion_pair", mods["fusion_pair"].SOURCE, mods["fusion_pair"].REPLACES,
            lambda: kernels.fusion_pair(pts2, idx, pts1, *ws),
            lambda: kernels.fusion_pair_plain(pts2, idx, pts1, *ws), None, nbytes, f32,
            err, 1e-4 * (1 + float(logits.abs().max())), tc_flops=tc)
    rows[-1]["bound_f32_ms"] = bound(nbytes, f32 + tc)[0]
    log(f"kernel fusion_pair: bound_ms {rows[-1]['bound_ms']:.5f} at 3xTF32, "
        f"{rows[-1]['bound_f32_ms']:.5f} all at f32")

    # chamfer_pair: the eval CD, 3 predicted frames against 3 ground-truth frames
    _, gts = dataset[0]
    a = torch.stack(f[1:]).contiguous()
    b = torch.stack([torch.from_numpy(x).to(dev) for x in gts]).contiguous()
    k12, k21 = kernels.chamfer_pair_keys(a, b)
    w12, w21 = kernels.chamfer_pair_keys_plain(a, b)
    mism = int((k12 != w12).sum() + (k21 != w21).sum())
    got_d = kernels.chamfer_pair(a, b)
    mask = (1 << mods["chamfer_pair"].index_bits(n0, n0)) - 1
    want_d = [((x - kernels._lib.group_rows(y, key & mask)) ** 2).sum(-1)
              for x, y, key in ((a, b, w12), (b, a, w21))]
    err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got_d, want_d))
    true12 = torch.cdist(a.double(), b.double()).pow(2).amin(2)
    tie = float((got_d[0].double() - true12).abs().max())
    log(f"chamfer_pair {tuple(a.shape)} x {tuple(b.shape)}: key mismatches {mism}, max d "
        f"error {err:.3e}; largest gap to the float64 minimum {tie:.3e}")
    if mism:
        raise SystemExit("chamfer_pair: keys differ from the plain version")
    row("chamfer_pair", mods["chamfer_pair"],
        lambda: kernels.chamfer_pair_keys(a, b),
        lambda: kernels.chamfer_pair_keys_plain(a, b),
        lambda: (lambda dm: (dm.amin(2), dm.amin(1)))(torch.cdist(a, b)),
        (a.numel() + b.numel()) * F32 + 2 * 3 * n0 * I32,
        9.0 * 3 * n0 * n0, err, 0.0)
    rows[-1]["issue_floor_ms"] = chamfer_floor(3, n0, n0)
    log(f"kernel chamfer_pair: issue floor {rows[-1]['issue_floor_ms']:.5f} ms "
        f"({CHAMFER_ISSUE} issue slots a pair)")
    if parent is not None:
        same = all(torch.equal(x, y) for x, y in zip(parent.chamfer_pair_keys(a, b), (k12, k21)))
        log(f"chamfer_pair {tuple(a.shape)} x {tuple(b.shape)} (keys equal to the parent's "
            f"{same}): " + beside(lambda: parent.chamfer_pair_keys(a, b),
                                  lambda: kernels.chamfer_pair_keys(a, b)))
        if not same:
            raise SystemExit("chamfer_pair: the parent's keys differ from this tree's")
    return rows


def check_chamfer_step(kernels, cfg, dev, parent=None):
    """``chamfer_pair`` at the train step's four calls (the loss's 5 pairs x
    B*F = 30 groups of n0 points, and 12 groups at each of the first three
    pyramid levels), on clouds from seed 6: keys bit-equal to the plain
    version's (and, with a parent, to that tree's), each call's device time
    beside its bound and issue floor (and the parent's, in turns)."""
    from mocopci_torch.config import TrainConfig

    gen = torch.Generator(device=dev).manual_seed(6)
    G1 = TrainConfig().batch_size * cfg.n_frames * 2
    for G, n in ((30, cfg.npoints), (G1, cfg.pyramid[0]), (G1, cfg.pyramid[1]),
                 (G1, cfg.pyramid[2])):
        a, b = (torch.randn(G, n, 3, generator=gen, device=dev) * 10.0 for _ in range(2))
        k12, k21 = kernels.chamfer_pair_keys(a, b)
        w12, w21 = kernels.chamfer_pair_keys_plain(a, b)
        mism = int((k12 != w12).sum() + (k21 != w21).sum())
        ms = median_ms(lambda: kernels.chamfer_pair_keys(a, b))
        msg = (f"chamfer_pair step call (G, N, M) {(G, n, n)}: key mismatches {mism}; ms "
               f"{ms:.4f}, bound_ms {call_bound('chamfer', G, n, n, 3):.5f}, issue floor "
               f"{chamfer_floor(G, n, n):.5f}")
        same = True
        if parent is not None:
            same = all(torch.equal(x, y) for x, y in zip(parent.chamfer_pair_keys(a, b),
                                                         (k12, k21)))
            msg += (f"; keys equal to the parent's {same}: "
                    + beside(lambda: parent.chamfer_pair_keys(a, b),
                             lambda: kernels.chamfer_pair_keys(a, b)))
        log(msg)
        if mism or not same:
            raise SystemExit(f"chamfer_pair {(G, n, n)}: keys differ from the plain version's "
                             "or the parent's")


def check_knn_approx_step(kernels, cfg, p1, p2, rnd, parent=None):
    """knn_approx at the train step's largest call, the B=2 fusion query over
    12 clouds of 8192 points, k = fusion_k, and at the kernel row's 6 clouds
    (bit-equal to its plain version), and at the step's cosine calls, up_1's
    cost volume at B=2, (2, 2048, 2048, 64)
    k = flow_nei / 2 (within the key quantisation, >= 99% equal); each timed
    beside its bound and, with a parent, beside that tree's kernel in turns."""
    from mocopci_torch.kernels.knn_approx import tiling
    from mocopci_torch.ops.distance import _normalise

    k, kc, n1, c1 = cfg.fusion_k, cfg.flow_nei // 2, cfg.pyramid[0], cfg.enc_channels[1]
    big_q, big_r = torch.cat([p1, p2]).contiguous(), torch.cat([p2, p1]).contiguous()
    fq, fr = (_normalise(rnd(2, n1, c1)).contiguous() for _ in range(2))
    for what, q, r, kk, metric in (("euclidean", big_q, big_r, k, "euclidean"),
                                   ("euclidean", p1, p2, k, "euclidean"),
                                   ("cosine", fq, fr, kc, "cosine")):
        B, N, C = q.shape
        M = r.shape[1]
        got = kernels.knn_approx(q, r, kk, metric)
        want = kernels.knn_approx_plain(q, r, kk, metric)
        same = torch.equal(got, kernels.knn_approx(q, r, kk, metric))
        mism = int((got != want).sum())
        gap = 0.0
        if metric == "cosine":      # the Euclidean indices must be equal
            d = kernels.knn.distances(q.double(), r.double(), metric)
            gap = float((d.gather(2, got.long()) - d.gather(2, want.long())).abs().max())
            del d
        ms = median_ms(lambda: kernels.knn_approx(q, r, kk, metric))
        b_ms = call_bound("knn", B, N, M, C, k=kk)
        msg = (f"knn_approx {what} (B, N, M, C) {(B, N, M, C)} k={kk}: index mismatches {mism} "
               f"({1 - mism / got.numel():.5f} equal), max distance gap {gap:.3e}, repeat "
               f"equal {same}; ms {ms:.4f}, bound_ms {b_ms:.5f}")
        if parent is not None:
            msg += (f"; the parent's indices differ in {int((parent.knn_approx(q, r, kk, metric) != got).sum())}: "
                    + beside(lambda: parent.knn_approx(q, r, kk, metric),
                             lambda: kernels.knn_approx(q, r, kk, metric)))
        log(msg)
        tol = 4.0 * 2.0 ** (tiling(M, kk)[1] - 23)
        if not same or (metric == "euclidean" and mism) or (metric == "cosine" and (
                gap > tol or mism > 0.01 * got.numel())):
            raise SystemExit(f"knn_approx {what}: indices differ from the plain version")


def rel_err(got, want) -> float:
    """Largest abs error of each tensor over max(1, its largest value)."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def bits_equal(a, b) -> bool:
    return all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def time_chamfer_vjp(kernels, pc1, pc2, what):
    """The Chamfer VJP's time (CUDA events, through autograd) beside its plain
    version's (the same VJP with the scatters' plain versions) and its bound:
    the two differences, the two cotangents and the two indices read, the
    two gradients written."""
    chamfer_mod = importlib.import_module("mocopci_torch.kernels.chamfer_pair")
    leaves = [pc1.clone().requires_grad_(), pc2.clone().requires_grad_()]
    d12, d21 = kernels.chamfer_pair(*leaves)
    loss = d12.sum() + d21.sum()

    def vjp():
        return torch.autograd.grad(loss, leaves, retain_graph=True)

    ms = median_ms(vjp)
    scatters = chamfer_mod.scatter_add, chamfer_mod.onehot_scatter_rows
    chamfer_mod.scatter_add = kernels.scatter_add_plain
    chamfer_mod.onehot_scatter_rows = kernels.onehot_scatter_rows_plain
    try:
        plain_ms = median_ms(vjp, 5)
    finally:
        chamfer_mod.scatter_add, chamfer_mod.onehot_scatter_rows = scatters
    G, N, M = pc1.shape[0], pc1.shape[1], pc2.shape[1]
    b_ms, b_by = bound(G * (N + M) * (3 + 1 + 3) * F32 + G * (N + M) * I32, 6.0 * G * (N + M))
    log(f"chamfer_pair bwd {what} {tuple(pc1.shape)} x {tuple(pc2.shape)}: ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms}


PARENT_SOURCES = ("cross_tail.cu", "fps.cu", "attention_train.cu", "transformer_tail.cu",
                  "knn_approx.cu", "attention.cu", "chamfer_pair.cu", "knn.cu", "fusion_pair.cu",
                  "fusion_head_train_fwd.cu", "common.cu")


def build_parent(tree):
    """Start building another checkout's cost-volume tail, FPS, train and eval
    attention, transformer tail, approximate and exact kNN, Chamfer, eval
    fusion head and train fusion forward kernels (``PARENT_SOURCES``)
    into a library of their own; returns a function that waits for the build
    and gives a :class:`Parent`."""
    from mocopci_torch.kernels import _lib

    csrc = os.path.join(tree, "mocopci_torch", "csrc")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parent",
                       "libparent.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", csrc, "-o", out,
           *(os.path.join(csrc, f) for f in PARENT_SOURCES)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log_, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"the parent's kernels did not build:\n{log_}")
        return Parent(tree, out)
    return finish


def bind_entries(lib, sig, names):
    """Give the entries ``mocopci_<name>`` of a built library (``ctypes``)
    the argument types of ``sig`` (a tree's ``_lib.SIGNATURES``), for each
    name that ``sig`` has."""
    import ctypes

    for name in names:
        if name in sig:
            fn = getattr(lib, f"mocopci_{name}")
            fn.argtypes, fn.restype = sig[name], ctypes.c_int


def launch_fps(lib, xyz, what, cluster=None):
    """One FPS launch through a built library's C entries on the current
    stream: ``what`` a count gives ``fps`` (``fps_cluster`` over ``cluster``
    blocks) as (B, what) indices; a tuple of level sizes gives
    ``fps_pyramid`` (``fps_pyramid_cluster``), the levels one after the other
    as one flat tensor."""
    B, N, _ = xyz.shape
    c = [] if cluster is None else [cluster]
    if isinstance(what, tuple):
        name = "fps_pyramid"
        out = torch.empty(B * sum(what), dtype=torch.int32, device=xyz.device)
        levels = torch.tensor(what, dtype=torch.int32)
        args = (xyz.data_ptr(), B, N, levels.data_ptr(), len(what), *c, out.data_ptr())
    else:
        name = "fps"
        out = torch.empty((B, what), dtype=torch.int32, device=xyz.device)
        args = (xyz.data_ptr(), B, N, what, *c, out.data_ptr())
    name += "" if cluster is None else "_cluster"
    if getattr(lib, f"mocopci_{name}")(*args, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError(f"{name} failed to launch")
    return out


def _bwd_blocks(tree, module):
    """``BWD_BLOCKS`` of another checkout's ``mocopci_torch/kernels/<module>.py``."""
    with open(os.path.join(tree, "mocopci_torch", "kernels", f"{module}.py")) as f:
        return int(re.search(r"^BWD_BLOCKS = (\d+)", f.read(), re.M).group(1))


def bwd_wide_sizes(ct, B, N, K, C, C2):
    """(partials, scratch floats) of a tree's wide backward as that tree's
    wrapper (its module ``ct``) sizes them: its ``bwd_wide_scratch`` where it
    has one, else blocks walking groups of ``BWD_WIDE_QUERIES`` with W
    transposed ahead of their partials."""
    if hasattr(ct, "bwd_wide_scratch"):
        return ct.bwd_wide_scratch(B, N, C, C2, K)
    last = min(ct.BWD_WIDE_BLOCKS, -(-B * N // ct.BWD_WIDE_QUERIES))
    return last, C * C2 + last * (C * C2 + C2)


def bwd_wide_call(entry, ct, tab, idx, base, w, out, amax, dout):
    """(d_rows, d_base, dw, db) from a tree's wide backward C entry, its
    outputs and scratch allocated as that tree's wrapper allocates them
    (:func:`bwd_wide_sizes`)."""
    B, M, C = tab.shape
    N, K, C2 = idx.shape[1], idx.shape[2], w.shape[1]
    dev = tab.device
    last, work = bwd_wide_sizes(ct, B, N, K, C, C2)
    d_rows = torch.empty((B, N, K, C), device=dev)
    d_base = torch.empty((B, N, C), device=dev)
    dwb = torch.empty(C * C2 + C2, device=dev)
    scratch = torch.empty(work, device=dev)
    if entry(tab.data_ptr(), idx.data_ptr(), base.data_ptr(), w.data_ptr(), out.data_ptr(),
             amax.data_ptr(), dout.data_ptr(), d_rows.data_ptr(), d_base.data_ptr(),
             dwb.data_ptr(), scratch.data_ptr(), B, M, N, K, C, C2, last,
             torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("cross_tail_bwd_wide failed to launch")
    return d_rows, d_base, dwb[:C * C2].view(C, C2), dwb[C * C2:]


class Parent:
    """Another checkout's cost-volume tail (forward and backward), FPS, train
    attention forward, eval attention, transformer tail and Chamfer key kernels,
    called through their C entry points with the argument lists of that
    tree's ``_lib.SIGNATURES``: a tree without ``fps_pyramid`` samples a
    pyramid by one launch a level and a gather between levels, and its
    cross_tail backward recomputes the max from the forward's output (no
    argmax), on that tree's grid (``BWD_BLOCKS``); its cross_tail forward
    takes that tree's grid (``fwd_grid``) where its signature has one, and
    its wide backward that tree's grid and scratch.  The
    attention forward is that tree's ``attention_train_fwd`` entry, or
    ``attention_train_fwd_wide`` for the wide route; the eval attention its
    ``attention`` entry, or ``attention_wide`` above 64 head dims where it
    has one; ``knn_approx`` takes that tree's arguments (a launch grid where
    its signature has one); the transformer tail's forward and ``chamfer_pair``
    take this tree's grid where that tree's signature has one, and their
    outputs are filled as that tree's wrapper fills them; exact ``knn`` and
    ``fusion_pair`` take this tree's grid (and an overflow counter) where that
    tree's signature has them; the train fusion head's forward runs through
    this tree's wrapper with that tree's entry."""

    def __init__(self, tree, path):
        import ctypes

        spec = importlib.util.spec_from_file_location(
            "parent_lib", os.path.join(tree, "mocopci_torch", "kernels", "_lib.py"))
        plib = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(plib)
        self.sig = plib.SIGNATURES
        self.argmax = len(self.sig["cross_tail"]) >= 14
        spec = importlib.util.spec_from_file_location(
            "parent_cross_tail", os.path.join(tree, "mocopci_torch", "kernels", "cross_tail.py"))
        self.ct = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.ct)
        self.fwd_grid = self.ct.fwd_grid if len(self.sig["cross_tail"]) == 15 else None
        self.bwd_blocks, self.tail_bwd_blocks = (_bwd_blocks(tree, name)
                                                 for name in ("cross_tail", "transformer_tail"))
        with open(os.path.join(tree, "mocopci_torch", "kernels", "fps.py")) as f:
            m = re.search(r"^CLUSTER = (\d+)", f.read(), re.M)
        self.cluster = int(m.group(1)) if m else None
        self.lib = ctypes.CDLL(path)
        bind_entries(self.lib, self.sig, (
            "cross_tail", "cross_tail_bwd", "fps", "fps_pyramid", "attention_train_fwd",
            "attention_train_fwd_wide", "transformer_tail", "transformer_tail_general",
            "transformer_tail_bwd", "knn_approx", "attention", "attention_wide", "chamfer_pair",
            "knn", "fusion_pair", "fusion_pair_planes", "fusion_head_train_fwd",
            "cross_tail_wide", "fps_cluster", "fps_pyramid_cluster", "cross_tail_bwd_wide"))

    def _call(self, name, *args):
        if getattr(self.lib, f"mocopci_{name}")(*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"the parent's {name} failed")

    def fps(self, xyz, npoint):
        return launch_fps(self.lib, xyz, npoint)

    def fps_cluster(self, xyz, npoint):
        """That tree's ``fps_cluster`` at its own ``CLUSTER``."""
        return launch_fps(self.lib, xyz, npoint, self.cluster)

    def fps_pyramid_cluster(self, xyz, npoints):
        """That tree's ``fps_pyramid_cluster`` at its own ``CLUSTER``, the
        levels one after the other as one flat tensor."""
        return launch_fps(self.lib, xyz, tuple(npoints), self.cluster)

    def fps_pyramid(self, xyz, npoints):
        """That tree's pyramid: its one launch, or a launch a level with the
        row gathers between levels, as that tree's ``ops.sampling`` did."""
        from mocopci_torch.kernels._lib import group_rows

        B = xyz.shape[0]
        if "fps_pyramid" in self.sig:
            out = launch_fps(self.lib, xyz, tuple(npoints))
            return tuple(o.view(B, n) for o, n in zip(out.split([B * n for n in npoints]),
                                                      npoints))
        idxs, pc = [], xyz
        for n in npoints:
            i = self.fps(pc, n)
            pc = group_rows(pc, i).contiguous()
            idxs.append(i)
        return tuple(idxs)

    def cross_tail_fwd(self, tab, idx, base, w, b, amax=None):
        """That tree's forward; fills ``amax`` with its argmax when given."""
        B, M, C = tab.shape
        N, K, C2 = idx.shape[1], idx.shape[2], w.shape[1]
        out = torch.empty((B, N, C2), dtype=torch.float32, device=tab.device)
        arg = [0 if amax is None else amax.data_ptr()] if self.argmax else []
        grid = [self.fwd_grid(B, N, K)] if self.fwd_grid else []
        self._call("cross_tail", tab.data_ptr(), idx.data_ptr(), base.data_ptr(), w.data_ptr(),
                   b.data_ptr(), out.data_ptr(), *arg, B, M, N, K, C, C2, *grid)
        return out

    def cross_tail_wide(self, tab, idx, base, w, b, nblk):
        """That tree's wide route of the forward, on ``nblk`` blocks."""
        B, M, C = tab.shape
        N, K, C2 = idx.shape[1], idx.shape[2], w.shape[1]
        out = torch.empty((B, N, C2), dtype=torch.float32, device=tab.device)
        self._call("cross_tail_wide", tab.data_ptr(), idx.data_ptr(), base.data_ptr(),
                   w.data_ptr(), b.data_ptr(), out.data_ptr(), 0, B, M, N, K, C, C2, nblk)
        return out

    def cross_tail_bwd_wide(self, tab, idx, base, w, out, amax, dout):
        """(d_rows, d_base, dw, db) from that tree's wide backward
        (:func:`bwd_wide_call`)."""
        return bwd_wide_call(self.lib.mocopci_cross_tail_bwd_wide, self.ct, tab, idx, base, w,
                             out, amax, dout)

    def attention(self, q, k, v, scale):
        G, N, D = q.shape
        out = torch.empty_like(q)
        entry = "attention_wide" if D > 64 and "attention_wide" in self.sig else "attention"
        self._call(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), G, N,
                   k.shape[1], D, float(scale))
        return out

    def cross_tail_bwd(self, tab, idx, base, w, b, out, amax, dout):
        """(d_rows, d_base, dw, db) from that tree's backward: from ``out``
        alone where it recomputes the max, else from ``amax`` too."""
        B, M, C = tab.shape
        N, K, C2 = idx.shape[1], idx.shape[2], w.shape[1]
        dev = tab.device
        d_rows = torch.empty((B, N, K, C), device=dev)
        d_base = torch.empty((B, N, C), device=dev)
        dwb = torch.empty(C * C2 + C2, device=dev)
        nblk = min(self.bwd_blocks, B * N)
        partial = torch.empty(nblk * (C * C2 + C2), device=dev)
        lead = ((w, out, amax) if self.argmax else (w, b, out))
        self._call("cross_tail_bwd", tab.data_ptr(), idx.data_ptr(), base.data_ptr(),
                   *(t.data_ptr() for t in lead), dout.data_ptr(), d_rows.data_ptr(),
                   d_base.data_ptr(), dwb.data_ptr(), partial.data_ptr(), B, M, N, K, C, C2,
                   nblk)
        return d_rows, d_base, dwb[:C * C2].view(C, C2), dwb[C * C2:]

    def attention_train_fwd(self, q, k, v, seed, scale, rate, entry="attention_train_fwd"):
        from mocopci_torch.kernels.attention_train import dropout_constants

        G, N, D = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((G, N), dtype=torch.float32, device=q.device)
        self._call(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), G, N, k.shape[1], D, float(scale),
                   seed.data_ptr(), *dropout_constants(rate))
        return out, lse

    def knn_approx(self, query, ref, k, metric):
        from mocopci_torch.kernels.knn import DIRECT_MAX_C, METRICS
        from mocopci_torch.kernels.knn_approx import launch_grid, tiling

        B, N, C = query.shape
        M = ref.shape[1]
        tr, bits, fold = tiling(M, k)
        out = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
        rn = (ref * ref).sum(-1).contiguous() if metric == "euclidean" and C > DIRECT_MAX_C else ref
        grid = launch_grid(B, N, M, C, tr, metric) if len(self.sig["knn_approx"]) == 17 else ()
        self._call("knn_approx", query.data_ptr(), ref.data_ptr(), rn.data_ptr(), B, N, M, C, k,
                   METRICS[metric], tr, bits, int(fold), *grid, out.data_ptr())
        return out

    def transformer_tail(self, table, idx, xyzq, q, *weights):
        """That tree's forward: its route for (K, D) where it has two, on this
        tree's grid where its entry takes one."""
        from mocopci_torch.kernels.transformer_tail import fwd_grid, fwd_route

        B, M, _ = table.shape
        N, K, D = idx.shape[1], idx.shape[2], q.shape[2]
        out = torch.empty((B, N, D), device=table.device)
        entry, grid = "transformer_tail", []
        if "transformer_tail_general" in self.sig:
            entry = fwd_route(K, D)
            if len(self.sig[entry]) == 20:
                grid = [fwd_grid(B, N, K)]
        self._call(entry, table.data_ptr(), idx.data_ptr(), xyzq.data_ptr(), q.data_ptr(),
                   *(t.data_ptr() for t in weights), out.data_ptr(), B, M, N, K, D, *grid)
        return out

    def chamfer_pair_keys(self, pc1, pc2):
        """That tree's keys: both outputs filled with the f32 max's bits where
        its entry takes no grid, else this tree's grid and fills."""
        from mocopci_torch.kernels.chamfer_pair import INF_KEY, INT_MAX, index_bits, launch_grid

        G, N, _ = pc1.shape
        M = pc2.shape[1]
        grid, fill12 = [], INF_KEY
        if len(self.sig["chamfer_pair"]) == 11:
            grid, fill12 = list(launch_grid(G, N, M)[:2]), INT_MAX
        k12 = torch.full((G, N), fill12, dtype=torch.int32, device=pc1.device)
        k21 = torch.full((G, M), INF_KEY, dtype=torch.int32, device=pc1.device)
        self._call("chamfer_pair", pc1.data_ptr(), pc2.data_ptr(), G, N, M, index_bits(N, M),
                   *grid, k12.data_ptr(), k21.data_ptr())
        return k12, k21

    def knn(self, query, ref, k, metric):
        """That tree's exact kNN indices."""
        from mocopci_torch.kernels.knn import METRICS, launch_grid

        B, N, C = query.shape
        M = ref.shape[1]
        out = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
        args = [query.data_ptr(), ref.data_ptr(), B, N, M, C, k, METRICS[metric]]
        if len(self.sig["knn"]) == 10:
            self._call("knn", *args, out.data_ptr())
            return out
        grid = launch_grid(B, N, M, C, metric)
        self.part = torch.empty((B, N, grid[1], k, 2), dtype=torch.int32, device=query.device)
        self.overflow = torch.zeros(1, dtype=torch.int32, device=query.device)
        self._call("knn", *args, *grid, out.data_ptr(), self.part.data_ptr(),
                   self.overflow.data_ptr())
        return out

    def fusion_pair(self, points2, idx, points1, *weights):
        """That tree's eval fusion head: (planes, logits)."""
        G, N, K2 = idx.shape
        planes = torch.empty((G, 4, N * K2), device=idx.device)
        logits = torch.empty((G, N * K2), device=idx.device)
        self._call("fusion_pair", points2.data_ptr(), idx.data_ptr(), points1.data_ptr(),
                   *(t.data_ptr() for t in weights), planes.data_ptr(), logits.data_ptr(), G, N,
                   points2.shape[1], K2)
        return planes, logits

    def fusion_pair_planes(self, points2, idx, points1):
        G, N, K2 = idx.shape
        planes = torch.empty((G, 4, N * K2), device=idx.device)
        self._call("fusion_pair_planes", points2.data_ptr(), idx.data_ptr(), points1.data_ptr(),
                   planes.data_ptr(), G, N, points2.shape[1], K2)
        return planes

    def fusion_head_train_fwd(self, planes, params, n_groups):
        """This tree's ``fusion_head_train_fwd`` with that tree's entry (the
        same arguments)."""
        lib = importlib.import_module("mocopci_torch.kernels._lib")
        head = importlib.import_module("mocopci_torch.kernels.fusion_head_train")
        if self.sig["fusion_head_train_fwd"] != lib.SIGNATURES["fusion_head_train_fwd"]:
            raise SystemExit("the parent's fusion_head_train_fwd takes other arguments")
        saved = lib.launch

        def launch(name, *args):
            if getattr(self.lib, f"mocopci_{name}")(*args):
                raise RuntimeError(f"the parent's {name} failed")
        lib.launch = launch
        try:
            return head.fusion_head_train_fwd(planes, params, n_groups)
        finally:
            lib.launch = saved

    def transformer_tail_bwd(self, table, idx, xyzq, q, *weights_and_dout):
        """(d_rows, dxq, dq, dw) from that tree's backward, dw the eight weight
        and bias gradients in one flat tensor."""
        *weights, dout = weights_and_dout
        B, M, _ = table.shape
        N, K, D = idx.shape[1], idx.shape[2], q.shape[2]
        dev = table.device
        d_rows = torch.empty((B, N, K, 3 + 2 * D), device=dev)
        dxq, dq = torch.empty((B, N, 3), device=dev), torch.empty((B, N, D), device=dev)
        dw = torch.empty(3 * D * D + 7 * D, device=dev)
        nblk = min(self.tail_bwd_blocks, B * N)
        partial = torch.empty(nblk * dw.numel(), device=dev)
        self._call("transformer_tail_bwd", table.data_ptr(), idx.data_ptr(), xyzq.data_ptr(),
                   q.data_ptr(), *(t.data_ptr() for t in weights), dout.data_ptr(),
                   d_rows.data_ptr(), dxq.data_ptr(), dq.data_ptr(), dw.data_ptr(),
                   partial.data_ptr(), B, M, N, K, D, nblk)
        return d_rows, dxq, dq, dw


def check_train_kernels(kernels, cfg, dev, rows, parent=None):
    """The train kernels against their plain versions at the train step's
    shapes (B=2, the 3 frames folded into the batch: G = 6), each repeated
    once to show it returns the same bits; ``parent`` (a :class:`Parent`),
    when given, its cost-volume tail timed beside this tree's."""
    from mocopci_torch.config import TrainConfig

    (attention_train, cross_tail, fusion_head_train, fusion_pair, scatter_add,
     transformer_tail) = (importlib.import_module(f"mocopci_torch.kernels.{name}") for name in (
         "attention_train", "cross_tail", "fusion_head_train", "fusion_pair", "scatter_add",
         "transformer_tail"))

    B, F = TrainConfig().batch_size, cfg.n_frames
    G = B * F
    c0, c1, c2, c3, _ = cfg.enc_channels
    n0, n1 = cfg.npoints, cfg.pyramid[0]
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def idx_of(*shape, high):
        return torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int32)

    def err_of(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def sdpa_bwd(q, k, v, do, sc):
        """SDPA's float32 backward without dropout (autograd of one call): the
        library yardstick of both attention backward routes."""
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=sc)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    # scatter_add: the fusion planes' backward, (G, 3, N*2k) -> N rows; then
    # the 8192 Chamfer VJP of the loss (5 pairs x B*F = 30 groups, C = 3)
    S = n0 * 2 * cfg.fusion_k
    v, idx = rnd(G, 3, S), idx_of(G, S, high=n0)
    got = scatter_add.scatter_add(v, idx, n0, planes=True)
    want = scatter_add.scatter_add_plain(v, idx, n0, planes=True)
    same = bits_equal([got], [scatter_add.scatter_add(v, idx, n0, planes=True)])
    vc, ic = rnd(30, n0, 3), idx_of(30, n0, high=n0)
    got_c = scatter_add.scatter_add(vc, ic, n0)
    same_c = bits_equal([got_c], [scatter_add.scatter_add(vc, ic, n0)])
    err_c = float((got_c - scatter_add.scatter_add_plain(vc, ic, n0)).abs().max())
    log(f"scatter_add planes {tuple(v.shape)} -> {n0}: repeat bit-equal {same}; Chamfer "
        f"rows {tuple(vc.shape)}: max_abs_err {err_c:.3e}, repeat bit-equal {same_c}")
    if not (same and same_c) or err_c > 1e-4:
        raise SystemExit("scatter_add: a run did not repeat its bits, or the Chamfer shape disagrees")
    rows_flat = v.transpose(1, 2).reshape(-1, 3).contiguous()
    flat = (idx.long() + torch.arange(G, device=dev)[:, None] * n0).reshape(-1)
    add_row(rows, "scatter_add", scatter_add.SOURCE, scatter_add.REPLACES,
            lambda: scatter_add.scatter_add(v, idx, n0, planes=True),
            lambda: scatter_add.scatter_add_plain(v, idx, n0, planes=True),
            lambda: torch.zeros(G * n0, 3, device=dev).index_add_(0, flat, rows_flat),
            (v.numel() + G * n0 * 3) * F32 + idx.numel() * I32, 1.0 * v.numel(),
            float((got - want).abs().max()), 1e-4)

    # attention_train forward at each (G, N = M, D, rate) of the step's one-pass
    # calls (Multi_Frame_Att at L1 and L2 with dropout, the EICrossformer at
    # L3, L2 and L1 without), each against its plain version (output and
    # log-sum-exp) and, with a parent, timed beside that tree's forward
    seed_i = -12345
    seed = torch.tensor([seed_i], dtype=torch.int32, device=dev)
    n2, n3 = cfg.pyramid[1:3]
    for Ga, L, D, rate in ((B * 5 * 8, n1, c1 // 8, cfg.attn_drop),
                           (B * 5 * 8, n2, c2 // 8, cfg.attn_drop), (B * 8, n3, c3 // 8, 0.0),
                           (B * 8, n2, c2 // 8, 0.0), (B * 8, n1, c1 // 8, 0.0)):
        q, k, vv = rnd(Ga, L, D), rnd(Ga, L, D), rnd(Ga, L, D)
        sc = D ** -0.5
        out, lse = attention_train.attention_train_fwd(q, k, vv, seed, sc, rate)
        err = float((out - attention_train.attention_train_plain(q, k, vv, seed_i, sc, rate))
                    .abs().max())
        err_lse = float((lse - torch.logsumexp(q @ k.transpose(1, 2) * sc, -1)).abs().max())
        msg = (f"attention_train fwd (G, N, M, D, rate) {(Ga, L, L, D, rate)}: max_abs_err "
               f"{err:.3e}, lse {err_lse:.3e} (tol 1e-5)")
        if parent is not None:
            gap = float((parent.attention_train_fwd(q, k, vv, seed, sc, rate)[0] - out)
                        .abs().max())
            msg += (f"; the parent's output differs by {gap:.3e}: "
                    + beside(lambda: parent.attention_train_fwd(q, k, vv, seed, sc, rate),
                             lambda: attention_train.attention_train_fwd(q, k, vv, seed, sc,
                                                                         rate)))
        log(msg)
        if err > 1e-5 or err_lse > 1e-5:
            raise SystemExit("attention_train_fwd disagrees with its plain version")
    del q, k, vv, out, lse

    # attention_train: Multi_Frame_Att at L1, (B*5*8, n1, c1/8), the dropout rate
    Ga, D, rate = B * 5 * 8, c1 // 8, cfg.attn_drop
    q, k, vv, do = rnd(Ga, n1, D), rnd(Ga, n1, D), rnd(Ga, n1, D), rnd(Ga, n1, D)
    sc = D ** -0.5
    out, lse = attention_train.attention_train_fwd(q, k, vv, seed, sc, rate)
    want = attention_train.attention_train_plain(q, k, vv, seed_i, sc, rate)
    err = float((out - want).abs().max())
    # one flipped keep factor moves its row by about |v| / (M (1 - rate)) >> tol
    add_row(rows, "attention_train_fwd", attention_train.SOURCE, attention_train.REPLACES,
            lambda: attention_train.attention_train_fwd(q, k, vv, seed, sc, rate),
            lambda: attention_train.attention_train_plain(q, k, vv, seed_i, sc, rate),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, vv, scale=sc),
            (4 * q.numel() + Ga * n1) * F32, Ga * n1 * n1 * (4.0 * D + 3), err, 1e-5)
    got = attention_train.attention_train_bwd(q, k, vv, out, lse, do, seed, sc, rate)
    want = attention_train.attention_train_bwd_plain(q, k, vv, seed_i, sc, rate, do)
    same = bits_equal(got, attention_train.attention_train_bwd(q, k, vv, out, lse, do, seed,
                                                               sc, rate))
    # the rate-0 kernel (the EICrossformer's calls: no keep factor, no hash)
    out0, lse0 = attention_train.attention_train_fwd(q, k, vv, seed, sc, 0.0)
    got0 = attention_train.attention_train_bwd(q, k, vv, out0, lse0, do, seed, sc, 0.0)
    same0 = bits_equal(got0, attention_train.attention_train_bwd(q, k, vv, out0, lse0, do, seed,
                                                                 sc, 0.0))
    err0 = err_of(got0, attention_train.attention_train_bwd_plain(q, k, vv, seed_i, sc, 0.0, do))
    log(f"attention_train bwd {tuple(q.shape)}: repeat bit-equal {same}; at rate 0 "
        f"max_abs_err {err0:.3e}, repeat bit-equal {same0}")
    if not (same and same0) or err0 > 1e-4:
        raise SystemExit("attention_train_bwd: a run did not repeat its bits, or rate 0 "
                         "disagrees")
    add_row(rows, "attention_train_bwd", attention_train.SOURCE, attention_train.REPLACES_BWD,
            lambda: attention_train.attention_train_bwd(q, k, vv, out, lse, do, seed, sc, rate),
            lambda: attention_train.attention_train_bwd_plain(q, k, vv, seed_i, sc, rate, do),
            sdpa_bwd(q, k, vv, do, sc), (8 * q.numel() + Ga * n1) * F32,
            Ga * n1 * n1 * (10.0 * D + 6), err_of(got, want), 1e-4)
    # the wide route at the same shape, beside it (the backward before the one pass)
    attention_train.MAX_BWD_D, max_bwd_d = 0, attention_train.MAX_BWD_D
    try:
        wide_ms = median_ms(lambda: attention_train.attention_train_bwd(q, k, vv, out, lse, do,
                                                                        seed, sc, rate))
    finally:
        attention_train.MAX_BWD_D = max_bwd_d
    log(f"attention_train bwd {tuple(q.shape)}: the wide route takes {wide_ms:.4f} ms")
    del q, k, vv, do, out, lse, got, want, out0, lse0, got0

    # attention_train, the wide route (D > 64): CrossFrameBlock at L3, 4 heads
    # of the full width c3 over both input frames, (B*2*4, n3, c3)
    Gw = B * 2 * 4
    q, k, vv, do = rnd(Gw, n3, c3), rnd(Gw, n3, c3), rnd(Gw, n3, c3), rnd(Gw, n3, c3)
    sc = c3 ** -0.5
    out, lse = attention_train.attention_train_fwd(q, k, vv, seed, sc, rate)
    for r_ in (rate, 0.0):
        o1, l1 = attention_train.attention_train_fwd(q, k, vv, seed, sc, r_)
        same = bits_equal([o1, l1], attention_train.attention_train_fwd(q, k, vv, seed, sc, r_))
        err = float((o1 - attention_train.attention_train_plain(q, k, vv, seed_i, sc, r_))
                    .abs().max())
        err_lse = float((l1 - torch.logsumexp(q @ k.transpose(1, 2) * sc, -1)).abs().max())
        msg = (f"attention_train fwd wide (G, N, M, D, rate) {(Gw, n3, n3, c3, r_)}: max_abs_err "
               f"{err:.3e}, lse {err_lse:.3e} (tol 1e-5), repeat bit-equal {same}")
        if parent is not None:
            gap = float((parent.attention_train_fwd(q, k, vv, seed, sc, r_,
                                                    "attention_train_fwd_wide")[0] - o1)
                        .abs().max())
            msg += (f"; the parent's output differs by {gap:.3e}: "
                    + beside(lambda: parent.attention_train_fwd(q, k, vv, seed, sc, r_,
                                                                "attention_train_fwd_wide"),
                             lambda: attention_train.attention_train_fwd(q, k, vv, seed, sc, r_))
                    + "; SDPA (no dropout) device us "
                    + device_us(lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, vv, scale=sc)))
        log(msg)
        if not same or err > 1e-5 or err_lse > 1e-5:
            raise SystemExit("attention_train_fwd_wide disagrees with its plain version or did "
                             "not repeat its bits")
    # the bound: its two products (4 D flops a pair) on the tensor cores at
    # float32 grade
    add_row(rows, "attention_train_fwd_wide", attention_train.SOURCE, attention_train.REPLACES,
            lambda: attention_train.attention_train_fwd(q, k, vv, seed, sc, rate),
            lambda: attention_train.attention_train_plain(q, k, vv, seed_i, sc, rate),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, vv, scale=sc),
            (4 * q.numel() + Gw * n3) * F32, Gw * n3 * n3 * 4.0 * c3,
            float((out - attention_train.attention_train_plain(q, k, vv, seed_i, sc, rate))
                  .abs().max()), 1e-5, peak=PEAK_3XTF32_FLOPS)
    got = attention_train.attention_train_bwd(q, k, vv, out, lse, do, seed, sc, rate)
    same = bits_equal(got, attention_train.attention_train_bwd(q, k, vv, out, lse, do, seed,
                                                               sc, rate))
    out0, lse0 = attention_train.attention_train_fwd(q, k, vv, seed, sc, 0.0)
    got0 = attention_train.attention_train_bwd(q, k, vv, out0, lse0, do, seed, sc, 0.0)
    same0 = bits_equal(got0, attention_train.attention_train_bwd(q, k, vv, out0, lse0, do, seed,
                                                                 sc, 0.0))
    err0 = err_of(got0, attention_train.attention_train_bwd_plain(q, k, vv, seed_i, sc, 0.0, do))
    log(f"attention_train bwd wide {tuple(q.shape)}: repeat bit-equal {same}; at rate 0 "
        f"max_abs_err {err0:.3e}, repeat bit-equal {same0}")
    if not (same and same0) or err0 > 1e-4:
        raise SystemExit("attention_train_bwd_wide: a run did not repeat its bits, or rate 0 "
                         "disagrees")
    # the bound: the five products (10 D flops a pair) on the tensor cores at
    # float32 grade
    add_row(rows, "attention_train_bwd_wide", attention_train.SOURCE,
            attention_train.REPLACES_BWD,
            lambda: attention_train.attention_train_bwd(q, k, vv, out, lse, do, seed, sc, rate),
            lambda: attention_train.attention_train_bwd_plain(q, k, vv, seed_i, sc, rate, do),
            sdpa_bwd(q, k, vv, do, sc), (8 * q.numel() + Gw * n3) * F32,
            Gw * n3 * n3 * 10.0 * c3,
            err_of(got, attention_train.attention_train_bwd_plain(q, k, vv, seed_i, sc, rate, do)),
            1e-4, peak=PEAK_3XTF32_FLOPS)
    del q, k, vv, do, out, lse, got, out0, lse0, got0

    # cross_tail at up_1, bid / fe: G x n1 queries, K = flow_nei.  The forward
    # with its argmax against the twin's first argmax (where they differ, the
    # two pre-max values within 1e-5: a near tie summed in another order),
    # then the backward from it, the rows' gradient compared after its scatter
    # (ties split differently)
    M, N, K, C = n1, n1, cfg.flow_nei, c1
    tab, base, dout = rnd(G, M, C), rnd(G, N, C), rnd(G, N, C)
    w, b = rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1)
    idx = idx_of(G, N, K, high=M)
    amax = torch.empty((G, N, C), dtype=cross_tail.argmax_dtype(K), device=dev)
    out = cross_tail.cross_tail_fwd(tab, idx, base, w, b, amax)
    want_amax = cross_tail.cross_tail_argmax_plain(tab, idx, base, w, b)
    h = cross_tail._tail_pre(kernels._lib.group_rows(tab, idx), base, w, b)
    tie_gap = float((h.gather(2, amax.long()[:, :, None]) - h.gather(
        2, want_amax.long()[:, :, None])).abs().max())
    del h
    log(f"cross_tail fwd {tuple(idx.shape)} argmax: mismatches against the twin's "
        f"{int((amax != want_amax).sum())}, largest pre-max gap there {tie_gap:.3e}")
    if tie_gap > 1e-5:
        raise SystemExit("cross_tail: the forward's argmax is not a max")
    fwd_ms = [median_ms(lambda: cross_tail.cross_tail_fwd(tab, idx, base, w, b, amax)),
              median_ms(lambda: cross_tail.cross_tail_fwd(tab, idx, base, w, b))]
    log(f"cross_tail fwd {tuple(idx.shape)}: {fwd_ms[0]:.4f} ms with the argmax, "
        f"{fwd_ms[1]:.4f} ms without")
    if parent is not None:      # the redesign keeps the parent's bits and argmax
        pamax = torch.empty_like(amax)
        same = (bits_equal([parent.cross_tail_fwd(tab, idx, base, w, b, pamax)], [out])
                and torch.equal(pamax, amax))
        log(f"cross_tail fwd {tuple(idx.shape)} with the argmax (output and argmax bit-equal "
            f"to the parent's {same}): "
            + beside(lambda: parent.cross_tail_fwd(tab, idx, base, w, b, pamax),
                     lambda: cross_tail.cross_tail_fwd(tab, idx, base, w, b, amax)))
        if not same:
            raise SystemExit("cross_tail: the forward's bits or argmax differ from the parent's")
    got = cross_tail.cross_tail_bwd(tab, idx, base, w, out, amax, dout)
    want = cross_tail.cross_tail_bwd_plain(tab, idx, base, w, b, dout)
    same = bits_equal(got, cross_tail.cross_tail_bwd(tab, idx, base, w, out, amax, dout))
    flat_idx = idx.reshape(G, N * K)

    def d_tab(r):
        return scatter_add.gather_backward(r.reshape(G, N * K, C), flat_idx, M)

    err = rel_err([d_tab(got[0]), *got[1:]], [d_tab(want[0]), *want[1:]])
    log(f"cross_tail bwd: repeat bit-equal {same}; d_tab/d_base/dw/db error over "
        f"max(1, |value|) {err:.3e}")
    if not same:
        raise SystemExit("cross_tail_bwd: a run did not repeat its bits")
    # the bound: the sparse work from the saved argmax (cross_bwd_work)
    add_row(rows, "cross_tail_bwd", cross_tail.SOURCE, cross_tail.REPLACES_BWD,
            lambda: cross_tail.cross_tail_bwd(tab, idx, base, w, out, amax, dout),
            lambda: cross_tail.cross_tail_bwd_plain(tab, idx, base, w, b, dout), None,
            *cross_bwd_work(G, M, N, K, C, C), err, 1e-4)
    if parent is not None:
        pout = parent.cross_tail_fwd(tab, idx, base, w, b)
        pgot = parent.cross_tail_bwd(tab, idx, base, w, b, pout, amax, dout)
        gap = rel_err([d_tab(pgot[0]), *pgot[1:]], [d_tab(got[0]), *got[1:]])
        log(f"cross_tail bwd {tuple(idx.shape)} (results differ by {gap:.3e} over max(1, "
            f"|value|) after the scatter): "
            + beside(lambda: parent.cross_tail_bwd(tab, idx, base, w, b, pout, amax, dout),
                     lambda: cross_tail.cross_tail_bwd(tab, idx, base, w, out, amax, dout)))
    del tab, base, dout, out, amax, want_amax, got, want

    # transformer_tail backward: the refine head, G x refine_npoint, K = refine_k
    M = N = cfg.refine_npoint
    K, D = cfg.refine_k, c1
    table, xq, qq, dout = rnd(G, M, 3 + 2 * D), rnd(G, N, 3), rnd(G, N, D), rnd(G, N, D)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
    idx = idx_of(G, N, K, high=M)
    got = transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout)
    want = transformer_tail.transformer_tail_bwd_plain(table, idx, xq, qq, *ws, dout)
    same = bits_equal(got, transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout))
    err = rel_err(got, want)
    log(f"transformer_tail bwd: repeat bit-equal {same}; error over max(1, |value|) {err:.3e}")
    if not same:
        raise SystemExit("transformer_tail_bwd: a run did not repeat its bits")
    # the bound: the chain's products (recompute and VJP, 6 (3 D^2 + 3 D) flops
    # a pair) on the tensor cores at float32 grade
    add_row(rows, "transformer_tail_bwd", transformer_tail.SOURCE,
            transformer_tail.REPLACES_BWD,
            lambda: transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout),
            lambda: transformer_tail.transformer_tail_bwd_plain(table, idx, xq, qq, *ws, dout),
            None, *tail_bwd_work(G, M, N, K, D), err, 1e-4, peak=PEAK_3XTF32_FLOPS)
    if parent is not None:      # the forward's redesign shares the recompute: same bits
        pgot = parent.transformer_tail_bwd(table, idx, xq, qq, *ws, dout)
        flat = [*got[:3], torch.cat([t.reshape(-1) for t in got[3:]])]
        same = bits_equal(pgot, flat)
        log(f"transformer_tail bwd {tuple(idx.shape)} (bit-equal to the parent's {same}; "
            f"results differ by {rel_err(pgot, flat):.3e} over max(1, |value|)): "
            + beside(lambda: parent.transformer_tail_bwd(table, idx, xq, qq, *ws, dout),
                     lambda: transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout)))
        if not same:
            raise SystemExit("transformer_tail_bwd: the bits differ from the parent's")
    del table, xq, qq, dout, got, want

    # transformer_tail backward on its general route: the refine head at
    # refine_k = 8 (any (K, D) off BWD_SHAPES that fits), on FMAs
    K = 8
    table, xq, qq, dout = rnd(G, M, 3 + 2 * D), rnd(G, N, 3), rnd(G, N, D), rnd(G, N, D)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
    idx = idx_of(G, N, K, high=M)
    kernels.reset_launches()
    got = transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout)
    route = {n: c for n, c in kernels.LAUNCHES.items() if c}
    want = transformer_tail.transformer_tail_bwd_plain(table, idx, xq, qq, *ws, dout)
    same = bits_equal(got, transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout))
    err = rel_err(got, want)
    log(f"transformer_tail bwd general {tuple(idx.shape)}: launches {route}, repeat bit-equal "
        f"{same}; error over max(1, |value|) {err:.3e}")
    if not same or route != {"transformer_tail_bwd_general": 1}:
        raise SystemExit("transformer_tail_bwd_general: not launched, or a run did not repeat "
                         "its bits")
    add_row(rows, "transformer_tail_bwd_general", transformer_tail.SOURCE,
            transformer_tail.REPLACES_BWD,
            lambda: transformer_tail.transformer_tail_bwd(table, idx, xq, qq, *ws, dout),
            lambda: transformer_tail.transformer_tail_bwd_plain(table, idx, xq, qq, *ws, dout),
            None, *tail_bwd_work(G, M, N, K, D), err, 1e-4)
    del table, xq, qq, dout, got, want

    # fusion_pair planes and fusion_head_train: G x n0 queries x 2k pairs, 3 groups
    K2 = 2 * cfg.fusion_k
    P = n0 * K2
    p2, p1 = rnd(G, n0, 3, scale=10.0), rnd(G, n0, 3, scale=10.0)
    idx = idx_of(G, n0, K2, high=n0)
    planes = fusion_pair.fusion_pair_planes_kernel(p2, idx, p1)
    err = float((planes - fusion_pair.pair_planes(p2, idx, p1)).abs().max())
    add_row(rows, "fusion_pair_planes", fusion_pair.SOURCE, fusion_pair.REPLACES_PLANES,
            lambda: fusion_pair.fusion_pair_planes_kernel(p2, idx, p1),
            lambda: fusion_pair.pair_planes(p2, idx, p1), None,
            (p1.numel() + p2.numel() + planes.numel()) * F32 + idx.numel() * I32,
            9.0 * G * P, err, 1e-4)
    if parent is not None:      # the gather stage keeps the parent's bits
        same = bits_equal([parent.fusion_pair_planes(p2, idx, p1)], [planes])
        log(f"fusion_pair_planes {tuple(idx.shape)} (bit-equal to the parent's {same}): "
            + beside(lambda: parent.fusion_pair_planes(p2, idx, p1),
                     lambda: fusion_pair.fusion_pair_planes_kernel(p2, idx, p1)))
        if not same:
            raise SystemExit("fusion_pair_planes: the bits differ from the parent's")
    params, cin = [], 4
    for c in fusion_head_train.WIDTHS[1:]:
        params += [rnd(cin, c, scale=cin ** -0.5), rnd(c, scale=0.1), 1 + rnd(c, scale=0.1),
                   rnd(c, scale=0.1)]
        cin = c
    products = 2.0 * (4 * c1 + c1 * c1 + c1 * c2)     # the chain's products per pair
    o, stats, (packed, st) = fusion_head_train.fusion_head_train_fwd(planes, params, F)
    want_o, want_stats = fusion_head_train.fusion_head_train_plain(planes, params, F)
    o2, stats2, _ = fusion_head_train.fusion_head_train_fwd(planes, params, F)
    same = bits_equal([o, *[t for s in stats for t in s]], [o2, *[t for s in stats2 for t in s]])
    err_stats = rel_err([t for s in stats for t in s], [t for s in want_stats for t in s])
    log(f"fusion_head_train fwd: repeat bit-equal {same}; stats error over max(1, |value|) "
        f"{err_stats:.3e}")
    if not same or err_stats > 1e-3:
        raise SystemExit("fusion_head_train_fwd: stats disagree or a run did not repeat")
    if parent is not None:      # the shared layer chain keeps the parent's bits
        po, pstats, _ = parent.fusion_head_train_fwd(planes, params, F)
        same = bits_equal([po, *[t for s in pstats for t in s]],
                          [o, *[t for s in stats for t in s]])
        log(f"fusion_head_train fwd {tuple(planes.shape)} (output and statistics bit-equal to "
            f"the parent's {same}): "
            + beside(lambda: parent.fusion_head_train_fwd(planes, params, F),
                     lambda: fusion_head_train.fusion_head_train_fwd(planes, params, F), reps=5))
        if not same:
            raise SystemExit("fusion_head_train_fwd: the bits differ from the parent's")
    # the bound: one chain's products on the tensor cores at float32 grade
    add_row(rows, "fusion_head_train_fwd", fusion_head_train.SOURCE, fusion_head_train.REPLACES,
            lambda: fusion_head_train.fusion_head_train_fwd(planes, params, F),
            lambda: fusion_head_train.fusion_head_train_plain(planes, params, F), None,
            (planes.numel() + o.numel() + packed.numel()) * F32, G * P * products,
            float((o - want_o).abs().max()), 1e-3, reps=5, peak=PEAK_3XTF32_FLOPS)
    # the gradient follows the channel max and the ReLU kinks; where the top
    # two channels are within 1e-4 relative, or a hidden pre-activation within
    # 1e-4 of 0, kernel and twin (sums in another order) may route it
    # differently, so those pairs get no gradient in this comparison
    h3, _, kink = fusion_head_train.fusion_head_train_channels(planes, params, F)
    top2 = h3.topk(2, dim=1).values
    del h3
    near = ((top2[:, 0] - top2[:, 1]) <= 1e-4 * top2[:, 0]) | (kink < 1e-4)
    log(f"fusion_head_train bwd: {float(near.float().mean()):.5f} of pairs are within 1e-4 "
        f"of a channel-max tie or a ReLU kink and get no gradient here")
    d_o = rnd(G, P) * (~near)
    del top2, near, kink
    got = fusion_head_train.fusion_head_train_bwd(planes, params, F, packed, st, d_o)
    want = fusion_head_train.fusion_head_train_bwd_plain(planes, params, F, 1e-3, d_o)
    same = bits_equal(got, fusion_head_train.fusion_head_train_bwd(planes, params, F, packed,
                                                                   st, d_o))
    # b1..b3 precede a train-mode BatchNorm, so their exact gradient is 0 and
    # both versions return float32 noise of that 0: held only below 1e-2 of
    # their layer's largest weight gradient; every other output is compared
    biases = (2, 6, 10)
    err = rel_err([g for i, g in enumerate(got) if i not in biases],
                  [w for i, w in enumerate(want) if i not in biases])
    each = [round(rel_err([g], [w]), 9) for g, w in zip(got, want)]
    noise = [max(float(got[i].abs().max()), float(want[i].abs().max()))
             / float(want[i - 1].abs().max()) for i in biases]
    log(f"fusion_head_train bwd: repeat bit-equal {same}; dx and parameter grads error over "
        f"max(1, |value|) {err:.3e} (biases excluded), each (dx, W1, b1, g1, e1, ..., e3): "
        f"{each}; bias gradients over their weight's largest: {noise}")
    if not same or max(noise) > 1e-2:
        raise SystemExit("fusion_head_train_bwd: a run did not repeat its bits, or a bias "
                         "gradient is not noise")
    # the bound: a VJP from x needs one forward chain and two products per
    # layer, 3 x the chain's products, at the tensor cores' float32-grade rate
    add_row(rows, "fusion_head_train_bwd", fusion_head_train.SOURCE_BWD,
            fusion_head_train.REPLACES_BWD,
            lambda: fusion_head_train.fusion_head_train_bwd(planes, params, F, packed, st, d_o),
            lambda: fusion_head_train.fusion_head_train_bwd_plain(planes, params, F, 1e-3, d_o),
            None, (2 * planes.numel() + d_o.numel() + 2 * packed.numel()) * F32,
            3.0 * G * P * products, err, 1e-3, reps=5, peak=PEAK_3XTF32_FLOPS)
    # the Chamfer VJP of the loss (5 pairs x B*F = 30 groups of 8192 points)
    time_chamfer_vjp(kernels, rnd(30, n0, 3, scale=10.0), rnd(30, n0, 3, scale=10.0),
                     "through scatter_add, the loss shape")
    check_chamfer_step(kernels, cfg, dev, parent)


def op_inputs(cfg, dev):
    """The "ops" path's inputs at B=2 (G = 6 folded frames), from seed 5: the
    fusion query's clouds, a 131072-point sweep with 8192 queries, a 64-point
    cloud against an 8192-point frame, and k-major neighbour rows (2k per
    query) with their query planes and a plane cotangent."""
    from mocopci_torch.config import TrainConfig

    G, n0, K2 = TrainConfig().batch_size * cfg.n_frames, cfg.npoints, 2 * cfg.fusion_k
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    p1 = rnd(G, n0, 3, scale=10.0)
    gt = rnd(G, n0, 3, scale=10.0)
    return {"p1": p1, "p2": p1 + rnd(G, n0, 3, scale=0.05),
            "ref": rnd(1, 131072, 3, scale=20.0), "query": rnd(1, n0, 3, scale=20.0),
            "pred": (gt[:, ::n0 // 64] + rnd(G, 64, 3, scale=0.1)).contiguous(), "gt": gt,
            "nbr": rnd(G, n0 * K2, 3, scale=10.0), "p1t": rnd(G, 3, n0, scale=10.0),
            "dx": rnd(G, 4, n0 * K2)}


def check_op_kernels(kernels, cfg, dev, rows):
    """The op kernels against their plain versions at the "ops" path's shapes:
    select_min_k on the approx candidates of the fusion query's (6, 8192,
    8192) distances, the one-hot scatter of the Chamfer VJP (8192 rows into 64
    columns, and 64 rows into 8192 beside it), the pair planes' rows forward
    and backward at (6, 8192 x 64) pairs."""
    from mocopci_torch.ops import distance

    select_k, scatter_onehot, fusion_pair = (importlib.import_module(
        f"mocopci_torch.kernels.{name}") for name in ("select_k", "scatter_onehot", "fusion_pair"))
    x = op_inputs(cfg, dev)
    k = cfg.fusion_k
    gen = torch.Generator(device=dev).manual_seed(6)

    vals, idx = distance.approx_candidates(distance.square_distance(x["p1"], x["p2"]), k)
    got = select_k.select_min_k(vals, idx, k)
    mism = int((got != select_k.select_min_k_plain(vals, idx, k)).sum())
    log(f"select_min_k candidates {tuple(vals.shape)} k={k}: index mismatches {mism}")
    add_row(rows, "select_min_k", select_k.SOURCE, select_k.REPLACES,
            lambda: select_k.select_min_k(vals, idx, k),
            lambda: select_k.select_min_k_plain(vals, idx, k),
            lambda: torch.topk(vals, k, dim=-1, largest=False),
            vals.numel() * F32 + 2 * got.numel() * I32, 1.0 * vals.numel(), float(mism), 0.0)
    del vals, idx, got

    G, n0, n_small = x["gt"].shape[0], cfg.npoints, x["pred"].shape[1]
    errs = {}
    for S, n_out in ((n0, n_small), (n_small, n0)):
        v = torch.randn(G, S, 3, generator=gen, device=dev)
        ix = torch.randint(0, n_out, (G, S), generator=gen, device=dev, dtype=torch.int32)
        got = scatter_onehot.onehot_scatter_rows(v, ix, n_out)
        same = bits_equal([got], [scatter_onehot.onehot_scatter_rows(v, ix, n_out)])
        errs[(S, n_out)] = float((got - scatter_onehot.onehot_scatter_rows_plain(v, ix, n_out))
                                 .abs().max())
        log(f"onehot_scatter ({G}, {S}, 3) -> {n_out}: max_abs_err {errs[(S, n_out)]:.3e}, "
            f"repeat bit-equal {same}")
        if not same or errs[(S, n_out)] > 1e-4:
            raise SystemExit("onehot_scatter: a run did not repeat its bits, or it disagrees")
        fl = (ix.long() + torch.arange(G, device=dev)[:, None] * n_out).reshape(-1)
        vl = v.reshape(-1, 3)

        def launch(v=v, ix=ix, n_out=n_out):
            return scatter_onehot.onehot_scatter_rows(v, ix, n_out)

        def library(fl=fl, vl=vl, n_out=n_out):
            return torch.zeros(G * n_out, 3, device=dev).index_add_(0, fl, vl)

        log(f"onehot_scatter ({G}, {S}, 3) -> {n_out}: CUDA-event ms kernel "
            f"{median_ms(launch):.4f} index_add_ {median_ms(library):.4f}; device us "
            f"(torch.profiler) kernel {device_us(launch)} index_add_ {device_us(library)}")
        if S == n0:
            rows_v, ix_big, fl_big, vl_big = v, ix, fl, vl
    add_row(rows, "onehot_scatter", scatter_onehot.SOURCE, scatter_onehot.REPLACES,
            lambda: scatter_onehot.onehot_scatter_rows(rows_v, ix_big, n_small),
            lambda: scatter_onehot.onehot_scatter_rows_plain(rows_v, ix_big, n_small),
            lambda: torch.zeros(G * n_small, 3, device=dev).index_add_(0, fl_big, vl_big),
            (rows_v.numel() + G * 3 * n_small) * F32 + ix_big.numel() * I32,
            1.0 * rows_v.numel(), errs[(n0, n_small)], 1e-4)

    time_chamfer_vjp(kernels, x["pred"], x["gt"], "through onehot_scatter")

    nbr, p1t, dx = x["nbr"], x["p1t"], x["dx"]
    P = nbr.shape[1]
    planes = fusion_pair.pair_planes_rows_kernel(nbr, p1t)
    err = float((planes - fusion_pair.build_pair_planes_plain(nbr, p1t)).abs().max())
    add_row(rows, "pair_planes_rows", fusion_pair.SOURCE, fusion_pair.REPLACES_ROWS,
            lambda: fusion_pair.pair_planes_rows_kernel(nbr, p1t),
            lambda: fusion_pair.build_pair_planes_plain(nbr, p1t), None,
            (nbr.numel() + p1t.numel() + planes.numel()) * F32, 9.0 * G * P, err, 1e-4)
    got = fusion_pair.pair_planes_bwd_kernel(nbr, p1t, dx)
    want = fusion_pair.build_pair_planes_bwd_plain(nbr, p1t, dx)
    err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(got, want))
    add_row(rows, "pair_planes_bwd", fusion_pair.SOURCE, fusion_pair.REPLACES_BWD,
            lambda: fusion_pair.pair_planes_bwd_kernel(nbr, p1t, dx),
            lambda: fusion_pair.build_pair_planes_bwd_plain(nbr, p1t, dx), None,
            (2 * nbr.numel() + 2 * p1t.numel() + dx.numel()) * F32, 20.0 * G * P, err, 1e-5)


# the kernels the "ops" phase launches
OPS_KERNELS = ("select_min_k", "onehot_scatter", "chamfer_pair", "pair_planes_rows",
               "pair_planes_bwd")


def run_ops(kernels, cfg, dev):
    """The op paths that reach the op kernels, with the launch counts zeroed
    before and read after: approx selection on the fusion query's distances,
    exact ``ops.knn`` over 131072 references (16 query chunks x (8 reference
    chunks + 1 merge)), ``ops.chamfer_distance`` of a 64-point cloud against
    an 8192-point frame under grad, ``build_pair_planes`` forward and
    backward.  Then each result against its plain route (the same route with
    ``select_min_k_plain``) or the CPU, and each op's time."""
    from mocopci_torch import ops
    from mocopci_torch.ops import distance

    select_k = importlib.import_module("mocopci_torch.kernels.select_k")
    fusion_pair = importlib.import_module("mocopci_torch.kernels.fusion_pair")
    x = op_inputs(cfg, dev)
    k = cfg.fusion_k
    d = distance.square_distance(x["p1"], x["p2"])
    saved = distance.get_knn_mode()

    def select():
        distance.set_knn_mode("approx")
        return distance._topk_min_indices(d, k)

    def blocked():
        distance.set_knn_mode("exact")
        return ops.knn(k, x["ref"], x["query"])

    def chamfer_grads(pred, gt):
        leaves = [pred.clone().requires_grad_(), gt.clone().requires_grad_()]
        cd = ops.chamfer_distance(*leaves)
        cd.backward()
        return [cd.detach()] + [t.grad for t in leaves]

    def planes():
        leaves = [x["nbr"].clone().requires_grad_(), x["p1t"].clone().requires_grad_()]
        out = kernels.build_pair_planes(*leaves)
        out.backward(x["dx"])
        return [out.detach()] + [t.grad for t in leaves]

    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        sel, nn, cd, pl = select(), blocked(), chamfer_grads(x["pred"], x["gt"]), planes()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"ops: launches {launches}")
        missing = [name for name in OPS_KERNELS if launches[name] == 0]
        if missing:
            raise SystemExit(f"ops: kernels not launched on the op paths: {missing}")

        vals, idx = distance.approx_candidates(d, k)
        mism_sel = int((sel != select_k.select_min_k_plain(vals, idx, k)).sum())
        exact = torch.topk(d, k, dim=-1, largest=False).indices
        recall = float((sel[..., :, None] == exact[..., None, :]).any(-1).float().mean())
        del vals, idx, exact
        distance.select_min_k = select_k.select_min_k_plain
        try:
            nn_plain = blocked()
        finally:
            distance.select_min_k = select_k.select_min_k
        mism_nn = int((nn != nn_plain).sum())
        cpu = chamfer_grads(x["pred"].cpu(), x["gt"].cpu())
        cd_gap = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                     for a, b in zip(cd, cpu))
        want = [fusion_pair.build_pair_planes_plain(x["nbr"], x["p1t"]),
                *fusion_pair.build_pair_planes_bwd_plain(x["nbr"], x["p1t"], x["dx"])]
        pl_gap = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                     for a, b in zip(pl, want))
        log(f"ops: approx selection {tuple(sel.shape)}: index mismatches against the plain "
            f"selection {mism_sel}, recall against the exact sort {recall:.5f}; exact knn "
            f"{tuple(x['ref'].shape)} x {tuple(x['query'].shape)}: index mismatches against "
            f"the route with select_min_k_plain {mism_nn}; chamfer {tuple(x['pred'].shape)} x "
            f"{tuple(x['gt'].shape)}: value and gradients against the CPU, largest gap over "
            f"the largest value {cd_gap:.3e}; build_pair_planes planes and gradients against "
            f"the plain versions {pl_gap:.3e}")
        if mism_sel or recall < 0.95 or mism_nn or cd_gap > 1e-5 or pl_gap > 1e-5:
            raise SystemExit("ops: an op path disagrees with its plain route or the CPU")
        timing = {
            "approx_select_ms": host_ms(select),
            "exact_knn_131072_ms": host_ms(blocked),
            "chamfer_fwd_bwd_ms": host_ms(lambda: chamfer_grads(x["pred"], x["gt"])),
            "build_pair_planes_fwd_bwd_ms": host_ms(planes),
        }
    finally:
        distance.set_knn_mode(saved)
    log("ops: ms per call, median of 5 (host clock, synchronized): "
        + json.dumps({key: round(v, 3) for key, v in timing.items()}))
    return launches, {"recall": recall, "chamfer_gap": cd_gap, "planes_gap": pl_gap, **timing}


def chamfer(a: torch.Tensor, b: torch.Tensor) -> float:
    """Bidirectional squared-distance Chamfer of (N, 3) clouds, each direction
    a mean over points, summed; direct differences in float64."""
    a, b = a.double(), b.double()

    def directed(src, dst):
        mins = [((s[:, None, :] - dst[None]) ** 2).sum(-1).min(dim=1).values
                for s in torch.split(src, 1024)]
        return torch.cat(mins).mean()

    return float(directed(a, b) + directed(b, a))


# launch-counter names of the kernels the forward runs in each kNN mode
FORWARD_KERNELS = {
    "approx": ("fps", "fps_pyramid", "knn_approx", "attention", "attention_wide", "cross_tail",
               "transformer_tail", "fusion_pair"),
    "exact": ("fps", "fps_pyramid", "knn", "attention", "attention_wide", "cross_tail",
              "transformer_tail", "fusion_pair"),
}


def run_slice(kernels, cfg, dataset, dev, model, cpu_model, mode):
    """The forward in kNN ``mode`` on 3 pairs: launches, CD to the CPU run,
    the 12-run median; profiled once in approx mode."""
    from mocopci_torch import interpolate
    from mocopci_torch.ops import set_knn_mode

    set_knn_mode(mode)
    pairs = []
    for i in range(3):
        f = frames(dataset, i, dev)
        pairs.append((f[1][None], f[2][None]))        # the middle pair, B = 1
    kernels.reset_launches()
    outs = [interpolate(model, x1, x2) for x1, x2 in pairs]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"slice {mode}: launches per 3 forwards: {launches}")
    for out in outs:
        if out.shape != (1, 3, cfg.npoints, 3) or not bool(torch.isfinite(out).all()):
            raise SystemExit(f"slice {mode}: output wrong: {tuple(out.shape)}")
    missing = [name for name in FORWARD_KERNELS[mode] if launches[name] == 0]
    if missing:
        raise SystemExit(f"slice {mode}: kernels not launched on the main path: {missing}")

    t0 = time.perf_counter()
    ref = interpolate(cpu_model, pairs[0][0].cpu(), pairs[0][1].cpu())
    cpu_s = time.perf_counter() - t0
    cds = [chamfer(outs[0][0, j], ref[0, j].to(dev)) for j in range(cfg.n_frames)]
    log(f"slice {mode}: CD card vs cpu per frame {cds} (cpu forward {cpu_s:.1f} s)")
    if max(cds) > 1e-4:
        raise SystemExit(f"slice {mode}: card output differs from the CPU run")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(12):
        x1, x2 = pairs[i % 3]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        interpolate(model, x1, x2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated()
    log(f"slice {mode}: ModelConfig() B=1 eval forward median {fwd_ms:.3f} ms over 12 runs "
        f"(min {min(times):.3f}, max {max(times):.3f}), peak memory {peak / 2**20:.1f} MiB")
    busy, launched = {}, []
    if mode == "approx":
        def per_call(prof):
            log_calls(prof, launched, ("knn_approx",), "forward knn_approx")
            log_calls(prof, launched, ("attention", "attention_wide"), "forward attention")
            log_calls(prof, launched, ("cross_tail",), "forward cross_tail")
            log_calls(prof, launched, TAIL_FWD_ENTRIES, "forward transformer_tail")

        with recording(launched, ("knn_approx", "attention", "attention_wide", "cross_tail")
                       + TAIL_FWD_ENTRIES):
            busy = profile_fps_calls(lambda: interpolate(model, *pairs[0]), "forward", per_call)
    else:
        knn_mod = importlib.import_module("mocopci_torch.kernels.knn")
        knn_mod.reset_overflows()
        with recording(launched, ("knn",)):
            busy = profile(lambda: interpolate(model, *pairs[0]), "forward exact",
                           lambda prof: log_calls(prof, launched, ("knn",), "forward exact knn"))
        busy["knn_overflow_queries"] = knn_mod.overflows()
        log(f"slice exact: {busy['knn_overflow_queries']} queries took the knn overflow route "
            "in the profiled forward")
    return launches, {"forward_ms": fwd_ms, "forward_ms_min": min(times),
                      "forward_ms_max": max(times), "cd_max": max(cds),
                      "peak_mib": peak / 2**20, **busy}


# the final JSON keys of the JAX package's eval CLI, which the port's CLI keeps
CLI_KEYS = {f"{m}_frame{j}" for m in ("cd", "emd") for j in (1, 2, 3)} | {
    "cd_mean", "emd_mean", "wall_s", "compile_s", "per_sample_ms", "device_ms_per_sample",
    "synced_roundtrip_ms_per_sample", "n_samples"}


def host_ms(fn, reps=5) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_eval(kernels, cfg, dataset, dev, model, cpu_model):
    """eval_step (forward, CD, EMD) on one sample in approx mode, held against
    the CPU, the times of its parts, then the eval CLI on 3 synthetic samples."""
    from mocopci_torch import interpolate, ops
    from mocopci_torch.cli import test as cli_test
    from mocopci_torch.training import eval_metrics, eval_step

    ops.set_knn_mode("approx")
    inputs, gts = dataset[0]
    batch = {"pc1": inputs[1][None], "pc2": inputs[2][None], "gt": np.stack(gts)[None]}
    kernels.reset_launches()
    m = eval_step(model, batch)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"eval: launches per eval_step: {launches}")
    if launches["chamfer_pair"] == 0:
        raise SystemExit("eval: chamfer_pair not launched")
    card = {k: float(v[0]) for k, v in m.items()}
    if not all(np.isfinite(v) for v in card.values()):
        raise SystemExit(f"eval: metrics not finite: {card}")

    # the times first, before the CPU comparisons load the host
    out = interpolate(model, batch["pc1"], batch["pc2"])
    x1, x2, gt_d = (torch.from_numpy(batch[k]).to(dev) for k in ("pc1", "pc2", "gt"))
    B, F, N, _ = out.shape
    timing = {
        "eval_step_ms": host_ms(lambda: eval_step(model, batch)),
        "forward_ms": host_ms(lambda: interpolate(model, x1, x2)),
        "cd_ms": host_ms(lambda: ops.chamfer_distance_per_sample(
            out.reshape(B * F, N, 3), gt_d.reshape(B * F, N, 3))),
        "emd_ms": host_ms(lambda: [ops.earth_mover_distance_auto(out[:, j], gt_d[:, j])
                                   for j in range(F)]),
    }
    log("eval: ModelConfig() B=1 ms per sample, median of 5 (host clock, synchronized): "
        + json.dumps({k: round(v, 3) for k, v in timing.items()}))

    # the card's output through the metrics on the CPU (every kernel's plain
    # version), then the whole eval_step on the CPU model
    t0 = time.perf_counter()
    same = {k: float(v[0]) for k, v in eval_metrics(out.cpu(), gt_d.cpu()).items()}
    whole = {k: float(v[0]) for k, v in eval_step(cpu_model, batch).items()}
    cpu_s = time.perf_counter() - t0
    gaps = {k: abs(card[k] - same[k]) / abs(same[k]) for k in card}
    gaps_whole = {k: abs(card[k] - whole[k]) / abs(whole[k]) for k in card}
    log(f"eval: card metrics {card}")
    log(f"eval: relative gap to the CPU metrics of the same output {gaps}; to the CPU "
        f"eval_step {gaps_whole} ({cpu_s:.1f} s on the CPU)")
    bad = [k for k, g in gaps.items() if g > (1e-6 if k.startswith("cd") else 1e-3)]
    if bad:
        raise SystemExit(f"eval: card metrics differ from the CPU's: {bad}")

    kernels.reset_launches()
    result = cli_test.main(["--synthetic", "3"])
    cli_launches = dict(kernels.LAUNCHES)
    log(f"eval cli: launches {cli_launches}")
    if cli_launches["chamfer_pair"] == 0 or set(result) != CLI_KEYS:
        raise SystemExit(f"eval cli: chamfer_pair launches {cli_launches['chamfer_pair']}, "
                         f"keys {sorted(result)}")
    return launches, {"metrics": card, "gap_same_output": gaps, "gap_cpu_eval_step": gaps_whole,
                      **timing, "cli": result}


STRESS_SIZES = (16384, 32768)
# launch-counter names of the kernels the stress forward runs in each kNN
# mode: above 8192 points FPS takes its cluster routes
STRESS_KERNELS = {mode: tuple(f"{name}_cluster" if name.startswith("fps") else name
                              for name in names) for mode, names in FORWARD_KERNELS.items()}
# and at 32768 points cross3's cost-volume tail (L3's 1024 queries, C = C2 =
# 256) on its wide route
STRESS_EXTRA = {32768: ("cross_tail_wide",)}


def stress_levels(n):
    """The encoder's pyramid of ``stress_model_config(n)``."""
    return (n // 4, n // 16, n // 32, n // 128)


def check_stress_kernels(kernels, dev, rows, parent=None):
    """FPS's cluster routes against their plain versions, bit for bit, at the
    stress forwards' calls: the pyramid (2, n) -> n/4, n/16, n/32, n/128 and
    the refine head's (3, n) -> n/4 for n = 32768 and 16384; each timed in
    µs a step (device time over the steps of every level), beside the
    one-block route at 8192 points in this call; with ``parent``, that
    tree's one-block routes at 8192 and its cluster routes at each n (at its
    own ``CLUSTER``, indices held equal to this tree's) beside this tree's,
    in turns by CUDA events.  Then the
    cost-volume tail's wide route at cross3 of the 32768-point forward, (1,
    1024) queries of K = 32 over C = C2 = 256, within 1e-4 (1 + max |out|)
    of its plain version, its argmax instance bit-equal."""
    fps_mod = importlib.import_module("mocopci_torch.kernels.fps")
    gen = torch.Generator(device=dev).manual_seed(15)

    def per_step(fn, steps):
        us = device_us(fn)
        return float(us) / steps if us != "not measured" else None

    def turns(there, here, steps):
        """The parent's call against this tree's in turns (there, here, here,
        there), in µs a step by CUDA events."""
        us = [1e3 * median_ms(f, 10) / steps for f in (there, here, here, there)]
        return f"there {us[0]:.4f} / {us[3]:.4f}, here {us[1]:.4f} / {us[2]:.4f}"

    x8 = torch.randn(3, 8192, 3, generator=gen, device=dev) * 10
    one = {"fps": per_step(lambda: kernels.fps(x8, 2048), 2047),
           "fps_pyramid": per_step(lambda: kernels.fps_pyramid(x8[:2], stress_levels(8192)),
                                   sum(n - 1 for n in stress_levels(8192)))}
    log(f"stress fps: the one-block route at 8192 points, us a step by device time: (3, 8192) "
        f"-> 2048 {one['fps']}, (2, 8192) -> {stress_levels(8192)} {one['fps_pyramid']}")
    if parent is not None:
        pair8, lv8 = x8[:2].contiguous(), stress_levels(8192)
        one_r = turns(lambda: parent.fps(x8, 2048), lambda: kernels.fps(x8, 2048), 2047)
        one_p = turns(lambda: parent.fps_pyramid(pair8, lv8),
                      lambda: kernels.fps_pyramid(pair8, lv8), 2876)
        log(f"stress fps: the parent's one-block route at 8192 points, µs a step by CUDA "
            f"events: (3, 8192) -> 2048 {one_r}; (2, 8192) -> {lv8} {one_p}")
    for n in STRESS_SIZES[::-1]:
        tri = torch.randn(3, n, 3, generator=gen, device=dev) * 10
        pair, lv, npt = tri[:2].contiguous(), stress_levels(n), n // 4
        steps_p, steps_r = sum(m - 1 for m in lv), npt - 1
        mism_p = sum(int((a != b).sum()) for a, b in zip(kernels.fps_pyramid(pair, lv),
                                                         kernels.fps_pyramid_plain(pair, lv)))
        mism_r = int((kernels.fps(tri, npt) != kernels.fps_plain(tri, npt)).sum())
        log(f"stress fps_pyramid_cluster (2, {n}) -> {lv}: index mismatches {mism_p}; "
            f"fps_cluster (3, {n}) -> {npt}: index mismatches {mism_r}")
        if mism_p or mism_r:
            raise SystemExit(f"stress fps at {n} points differs from the plain version")
        us_r = per_step(lambda: kernels.fps(tri, npt), steps_r)
        us_p = per_step(lambda: kernels.fps_pyramid(pair, lv), steps_p)
        log(f"stress fps cluster of {fps_mod.CLUSTER} at {n} points, us a step by device "
            f"time: fps_cluster (3, {n}) -> {npt} {us_r}, fps_pyramid_cluster (2, {n}) {us_p}")
        if parent is not None and parent.cluster is not None:
            flat = torch.cat([i.reshape(-1) for i in kernels.fps_pyramid(pair, lv)])
            same = (torch.equal(parent.fps_cluster(tri, npt), kernels.fps(tri, npt))
                    and torch.equal(parent.fps_pyramid_cluster(pair, lv), flat))
            t_r = turns(lambda: parent.fps_cluster(tri, npt), lambda: kernels.fps(tri, npt),
                        steps_r)
            t_p = turns(lambda: parent.fps_pyramid_cluster(pair, lv),
                        lambda: kernels.fps_pyramid(pair, lv), steps_p)
            log(f"stress fps at {n} points, the parent's cluster routes ({parent.cluster} "
                f"blocks; indices equal {same}) against this tree's ({fps_mod.CLUSTER}), µs a "
                f"step by CUDA events: fps_cluster (3, {n}) -> {npt} {t_r}; "
                f"fps_pyramid_cluster (2, {n}) -> {lv} {t_p}")
            if not same:
                raise SystemExit("stress fps: the parent's indices differ from this tree's")
        if n != STRESS_SIZES[-1]:
            continue
        add_row(rows, "fps_cluster", fps_mod.SOURCE, fps_mod.REPLACES,
                lambda: kernels.fps(tri, npt), lambda: kernels.fps_plain(tri, npt), None,
                tri.numel() * F32 + 3 * npt * I32, 9.0 * 3 * steps_r * n, float(mism_r), 0.0,
                reps=10)
        fps_steps(rows[-1], [npt])
        rows[-1].update(cluster=fps_mod.CLUSTER, device_us_per_step=us_r,
                        one_block_8192_device_us_per_step=one["fps"])
        add_row(rows, "fps_pyramid_cluster", fps_mod.SOURCE, fps_mod.REPLACES_PYRAMID,
                lambda: kernels.fps_pyramid(pair, lv),
                lambda: kernels.fps_pyramid_plain(pair, lv), None,
                pair.numel() * F32 + 2 * sum(lv) * I32,
                9.0 * 2 * sum((m - 1) * k for m, k in zip(lv, (n,) + lv)), float(mism_p), 0.0,
                reps=10)
        fps_steps(rows[-1], lv)
        rows[-1].update(cluster=fps_mod.CLUSTER, device_us_per_step=us_p,
                        one_block_8192_device_us_per_step=one["fps_pyramid"])

    from mocopci_torch import stress_model_config

    ct = importlib.import_module("mocopci_torch.kernels.cross_tail")
    cfg = stress_model_config(STRESS_SIZES[-1])
    B, N, K, C = 1, cfg.pyramid[2], cfg.flow_nei, cfg.enc_channels[3]
    tab = torch.randn(B, N, C, generator=gen, device=dev)
    base = torch.randn(B, N, C, generator=gen, device=dev)
    w = torch.randn(C, C, generator=gen, device=dev) * C ** -0.5
    b = torch.randn(C, generator=gen, device=dev) * 0.1
    idx = torch.randint(0, N, (B, N, K), generator=gen, device=dev, dtype=torch.int32)
    if ct.fwd_route(K, C, C) != "cross_tail_wide":
        raise SystemExit("cross_tail: cross3 of the 32768-point forward left the wide route")
    out = kernels.cross_tail_plain(tab, idx, base, w, b)
    got = kernels.cross_tail(tab, idx, base, w, b)
    amax = torch.empty((B, N, C), dtype=ct.argmax_dtype(K), device=dev)
    same = bits_equal([ct.cross_tail_fwd(tab, idx, base, w, b, amax)], [got])
    log(f"stress cross_tail_wide (B, N, K, C, C2) {(B, N, K, C, C)}: the argmax instance "
        f"bit-equal {same}, argmax in [0, {K}) {0 <= int(amax.min()) and int(amax.max()) < K}")
    if not same:
        raise SystemExit("cross_tail_wide: the argmax instance changed the output's bits")
    if parent is not None and "cross_tail_wide" in parent.sig:
        nblk = min(ct.WIDE_BLOCKS, B * N)
        log(f"stress cross_tail_wide: the parent's bit-equal "
            f"{bits_equal([parent.cross_tail_wide(tab, idx, base, w, b, nblk)], [got])}; "
            + beside(lambda: parent.cross_tail_wide(tab, idx, base, w, b, nblk),
                     lambda: kernels.cross_tail(tab, idx, base, w, b)))
    add_row(rows, "cross_tail_wide", ct.SOURCE, ct.REPLACES,
            lambda: kernels.cross_tail(tab, idx, base, w, b),
            lambda: kernels.cross_tail_plain(tab, idx, base, w, b), None,
            (tab.numel() + base.numel() + w.numel() + b.numel() + out.numel()) * F32
            + idx.numel() * I32, B * N * K * (2 * C * C + 2 * C + 3 * C),
            float((got - out).abs().max()), 1e-4 * (1 + float(out.abs().max())))
    check_stress_tail_bwd(kernels, ct, gen, rows, tab, idx, base, w, b, amax, parent)
    check_long_attention(kernels, gen, rows, cfg)


def _lib_entry(name):
    """This tree's C entry ``mocopci_<name>`` (the loaded kernel library)."""
    from mocopci_torch.kernels import _lib

    return getattr(_lib.load(), f"mocopci_{name}")


def check_stress_tail_bwd(kernels, ct, gen, rows, tab, idx, base, w, b, amax, parent=None):
    """The cost-volume tail's wide backward ``cross_tail_bwd_wide`` at cross3
    of the 32768-point step, (1, 1024, 32) at C = C2 = 256, from the wide
    forward's argmax: its grid, shared memory and partials logged, its bits
    repeated, its gradients against ``cross_tail_bwd_plain`` (the rows'
    gradient after its scatter into the table, as the twin splits a tie
    evenly) within 1e-4 over max(1, |value|); with ``parent``, where that
    tree has a wide backward, its d_rows and d_base held bit-equal to that
    tree's and the two timed in turns.  Its general form at (K, C, C2) =
    (32, 128, 512) against the plain version the same way, its bits
    repeated.  Then both backward routes at C = C2 = 64, the wide one forced: d_rows and d_base bit-equal, dW and db within
    1e-5 (1 + max |value|), at (1, 1024, 32) and at the 8192-point step's
    (6, 2048, 32), where the two routes are timed in turns."""
    scatter_add = importlib.import_module("mocopci_torch.kernels.scatter_add")
    dev = tab.device

    def d_tab(r, idx, M):
        B, N, K, C = r.shape
        return scatter_add.gather_backward(r.reshape(B, N * K, C), idx.reshape(B, N * K), M)

    B, M, C = tab.shape
    N, K, C2 = idx.shape[1], idx.shape[2], w.shape[1]
    if ct.bwd_route(K, C, C2) != "cross_tail_bwd_wide":
        raise SystemExit("cross_tail: cross3 of the 32768-point step left the wide backward")
    spans, scratch = ct.bwd_wide_scratch(B, N, C, C2, K)
    slices = -(-C // ct.BWD_WIDE_SLICE)
    log(f"stress cross_tail_bwd_wide: grid {slices} channel slices x {spans} query spans = "
        f"{slices * spans} blocks of {32 * ct.BWD_WIDE_QUERIES} threads, shared memory "
        f"{ct._bwd_wide_smem(K, C2)} B a block, {spans} partials "
        f"({spans * (C * C2 + C2) * F32 / 2 ** 20:.2f} MiB; scratch with the queries' orders "
        f"{scratch * F32 / 2 ** 20:.2f} MiB)")
    out = ct.cross_tail_fwd(tab, idx, base, w, b, amax)
    dout = torch.randn(B, N, C2, generator=gen, device=dev)
    got = ct.cross_tail_bwd(tab, idx, base, w, out, amax, dout)
    same = bits_equal(got, ct.cross_tail_bwd(tab, idx, base, w, out, amax, dout))
    want = ct.cross_tail_bwd_plain(tab, idx, base, w, b, dout)
    err = rel_err([d_tab(got[0], idx, M), *got[1:]], [d_tab(want[0], idx, M), *want[1:]])
    log(f"stress cross_tail_bwd_wide (B, N, K, C, C2) {(B, N, K, C, C2)}: repeat bit-equal "
        f"{same}; d_tab/d_base/dw/db error over max(1, |value|) {err:.3e} (tol 1e-4)")
    if not same:
        raise SystemExit("cross_tail_bwd_wide: a run did not repeat its bits")
    if parent is not None and "cross_tail_bwd_wide" in parent.sig:
        # both trees' C entries, each with its wrapper's allocations and no
        # Python checks, so that the turns time the kernels and not the
        # wrappers' host work
        entry = _lib_entry("cross_tail_bwd_wide")
        theirs = parent.cross_tail_bwd_wide(tab, idx, base, w, out, amax, dout)
        same = bits_equal(theirs[:2], got[:2])
        gap = max(float((a - t).abs().max()) / (1 + float(t.abs().max()))
                  for a, t in zip(got[2:], theirs[2:]))
        log(f"stress cross_tail_bwd_wide: d_rows and d_base bit-equal to the parent's {same}, "
            f"dW and db within {gap:.3e} (1 + max); the C entries "
            + beside(lambda: parent.cross_tail_bwd_wide(tab, idx, base, w, out, amax, dout),
                     lambda: bwd_wide_call(entry, ct, tab, idx, base, w, out, amax, dout)))
        if not same:
            raise SystemExit("cross_tail_bwd_wide: d_rows or d_base differ from the parent's")
    add_row(rows, "cross_tail_bwd_wide", ct.SOURCE, ct.REPLACES_BWD,
            lambda: ct.cross_tail_bwd(tab, idx, base, w, out, amax, dout),
            lambda: ct.cross_tail_bwd_plain(tab, idx, base, w, b, dout), None,
            *cross_bwd_work(B, M, N, K, C, C2), err, 1e-4)

    # the general form, where the bucketed one does not fit: C2 = 512 at C = 128
    Cg, C2g = 128, 512
    if (ct.bwd_route(K, Cg, C2g), ct.bwd_wide_form(K, Cg, C2g)) != ("cross_tail_bwd_wide",
                                                                     "general"):
        raise SystemExit("cross_tail: (K, C, C2) = (32, 128, 512) left the wide general form")
    tab_g = torch.randn(B, M, Cg, generator=gen, device=dev)
    base_g = torch.randn(B, N, Cg, generator=gen, device=dev)
    w_g = torch.randn(Cg, C2g, generator=gen, device=dev) * Cg ** -0.5
    b_g = torch.randn(C2g, generator=gen, device=dev) * 0.1
    amax_g = torch.empty((B, N, C2g), dtype=ct.argmax_dtype(K), device=dev)
    out_g = ct.cross_tail_fwd(tab_g, idx, base_g, w_g, b_g, amax_g)
    dout_g = torch.randn(B, N, C2g, generator=gen, device=dev)

    def general():
        return ct.cross_tail_bwd(tab_g, idx, base_g, w_g, out_g, amax_g, dout_g)

    kernels.reset_launches()
    got_g = general()
    launched = kernels.LAUNCHES["cross_tail_bwd_wide"]
    same = bits_equal(got_g, general())
    want_g = ct.cross_tail_bwd_plain(tab_g, idx, base_g, w_g, b_g, dout_g)
    err_g = rel_err([d_tab(got_g[0], idx, M), *got_g[1:]], [d_tab(want_g[0], idx, M), *want_g[1:]])
    log(f"stress cross_tail_bwd_wide, its general form at (B, N, K, C, C2) {(B, N, K, Cg, C2g)} "
        f"({ct.bwd_wide_scratch(B, N, Cg, C2g, K)[0]} blocks): repeat bit-equal {same}; "
        f"d_tab/d_base/dw/db error over max(1, |value|) {err_g:.3e} (tol 1e-4); "
        f"{median_ms(general):.4f} ms, device us {device_us(general)}")
    if not same or err_g > 1e-4 or launched != 1:
        raise SystemExit("cross_tail_bwd_wide: its general form failed its check")

    def forced(fn):
        def run():
            saved = ct.bwd_route
            ct.bwd_route = lambda *a: "cross_tail_bwd_wide"
            try:
                return fn()
            finally:
                ct.bwd_route = saved
        return run

    # both routes where both fit: C = C2 = 64, the wide one forced
    for B, M, N in ((B, M, N), (6, 2048, 2048)):
        C = C2 = 64
        tab64 = torch.randn(B, M, C, generator=gen, device=dev)
        base64 = torch.randn(B, N, C, generator=gen, device=dev)
        w64 = torch.randn(C, C, generator=gen, device=dev) * C ** -0.5
        b64 = torch.randn(C, generator=gen, device=dev) * 0.1
        idx64 = torch.randint(0, M, (B, N, K), generator=gen, device=dev, dtype=torch.int32)
        idx64[:, :, 1] = idx64[:, :, 0]       # a duplicate neighbour: every max ties
        amax64 = torch.empty((B, N, C2), dtype=ct.argmax_dtype(K), device=dev)
        out64 = ct.cross_tail_fwd(tab64, idx64, base64, w64, b64, amax64)
        dout64 = torch.randn(B, N, C2, generator=gen, device=dev)

        def tiled_fn():
            return ct.cross_tail_bwd(tab64, idx64, base64, w64, out64, amax64, dout64)

        wide_fn = forced(tiled_fn)
        tiled = tiled_fn()
        kernels.reset_launches()
        wide = wide_fn()
        launched = kernels.LAUNCHES["cross_tail_bwd_wide"]
        same = bits_equal(wide[:2], tiled[:2])
        gap = max(float((a - t).abs().max()) / (1 + float(t.abs().max()))
                  for a, t in zip(wide[2:], tiled[2:]))
        log(f"stress cross_tail_bwd_wide forced at (B, N, K, C, C2) {(B, N, K, C, C2)} "
            f"({-(-C // ct.BWD_WIDE_SLICE)} x {ct.bwd_wide_spans(B, N, C)} blocks): d_rows and "
            f"d_base bit-equal to the tiled backward's {same}; dW, db within {gap:.3e} (1 + max) "
            f"(tol 1e-5)")
        if not same or gap > 1e-5 or launched != 1:
            raise SystemExit("cross_tail_bwd_wide: differs from the tiled backward")
        if B == 6:
            t = [median_ms(f) for f in (tiled_fn, wide_fn, wide_fn, tiled_fn)]
            log(f"stress cross_tail_bwd_wide forced at {(B, N, K, C, C2)}: the tiled route "
                f"{t[0]:.4f} / {t[3]:.4f} ms against the wide {t[1]:.4f} / {t[2]:.4f} ms in "
                f"turns; device us {device_us(tiled_fn)} against {device_us(wide_fn)}; bound "
                f"{bound(*cross_bwd_work(B, M, N, K, C, C2))[0]:.5f} ms")


# the 32768-point step's attentions over 8192 keys: the EI injector and
# extractor (8 heads) and the L1 MultiFrameBlock (5 frames x 8 heads), D = 8
LONG_ATTENTION = ((8, 8192, 8192, 8), (40, 8192, 8192, 8))
LONG_SUBSET = 2       # groups held to the plain version (the mask's hash takes g)


def check_long_attention(kernels, gen, rows, cfg):
    """The train attention (forward and backward, rate ``cfg.attn_drop`` and
    0) and the eval attention at the 32768-point calls over 8192 keys,
    ``LONG_ATTENTION``: each kernel on every group, repeated for its bits,
    and held on its first ``LONG_SUBSET`` groups to its plain version on
    those groups (a (G, 8192, 8192) plain matrix and its int64 mask pass
    what the card holds at G = 40): the forward within 1e-5, the backward
    within 1e-4, the eval attention within 1e-5.  Each timed beside its
    bound and its plain version's time on the subset; the numbers go to the
    kernel rows under ``keys_8192``."""
    attention_train = importlib.import_module("mocopci_torch.kernels.attention_train")
    dev = torch.device("cuda")
    seed_i = -12345
    seed = torch.tensor([seed_i], dtype=torch.int32, device=dev)
    by_name = {r["name"]: r for r in rows}
    g = LONG_SUBSET
    for G, N, M, D in LONG_ATTENTION:
        q, k, v, do = (torch.randn(G, L, D, generator=gen, device=dev)
                       for L in (N, M, M, N))
        sc = D ** -0.5
        sub = [t[:g] for t in (q, k, v)]
        for rate in (cfg.attn_drop, 0.0):
            out, lse = attention_train.attention_train_fwd(q, k, v, seed, sc, rate)
            same = bits_equal([out, lse], attention_train.attention_train_fwd(q, k, v, seed, sc,
                                                                              rate))
            err = float((out[:g] - attention_train.attention_train_plain(*sub, seed_i, sc, rate))
                        .abs().max())
            err_lse = float((lse[:g] - torch.logsumexp(sub[0] @ sub[1].transpose(1, 2) * sc, -1))
                            .abs().max())
            got = attention_train.attention_train_bwd(q, k, v, out, lse, do, seed, sc, rate)
            same_b = bits_equal(got, attention_train.attention_train_bwd(q, k, v, out, lse, do,
                                                                         seed, sc, rate))
            want = attention_train.attention_train_bwd_plain(*sub, seed_i, sc, rate, do[:g])
            err_b = max(float((a[:g] - w_).abs().max()) for a, w_ in zip(got, want))
            del want
            ms_f = median_ms(lambda: attention_train.attention_train_fwd(q, k, v, seed, sc, rate),
                             10)
            ms_b = median_ms(lambda: attention_train.attention_train_bwd(
                q, k, v, out, lse, do, seed, sc, rate), 10)
            plain_f = median_ms(lambda: attention_train.attention_train_plain(
                *sub, seed_i, sc, rate), 3)
            plain_b = median_ms(lambda: attention_train.attention_train_bwd_plain(
                *sub, seed_i, sc, rate, do[:g]), 3)
            b_f, b_b = call_bound("fwd", G, N, M, D), call_bound("bwd", G, N, M, D)
            log(f"stress attention_train (G, N, M, D, rate) {(G, N, M, D, rate)}: fwd "
                f"max_abs_err {err:.3e}, lse {err_lse:.3e} (tol 1e-5, {g} groups), repeat "
                f"bit-equal {same}, ms {ms_f:.4f}, bound_ms {b_f:.5f}, plain_ms on {g} groups "
                f"{plain_f:.4f}; bwd max_abs_err {err_b:.3e} (tol 1e-4), repeat bit-equal "
                f"{same_b}, ms {ms_b:.4f}, bound_ms {b_b:.5f}, plain_ms on {g} groups "
                f"{plain_b:.4f}")
            if not (same and same_b) or err > 1e-5 or err_lse > 1e-5 or err_b > 1e-4:
                raise SystemExit(f"attention_train at {(G, N, M, D, rate)} disagrees with its "
                                 "plain version or did not repeat its bits")
            shape = {"G": G, "N": N, "M": M, "D": D, "rate": rate, "plain_groups": g}
            by_name["attention_train_fwd"].setdefault("keys_8192", []).append(
                {**shape, "ms": ms_f, "bound_ms": b_f, "plain_ms": plain_f,
                 "max_abs_err": max(err, err_lse)})
            by_name["attention_train_bwd"].setdefault("keys_8192", []).append(
                {**shape, "ms": ms_b, "bound_ms": b_b, "plain_ms": plain_b,
                 "max_abs_err": err_b})
            del out, lse, got
        with torch.no_grad():
            att = kernels.attention(q, k, v, sc)
            same = bits_equal([att], [kernels.attention(q, k, v, sc)])
            err = float((att[:g] - kernels.attention_plain(*sub, sc)).abs().max())
            ms = median_ms(lambda: kernels.attention(q, k, v, sc), 10)
            plain = median_ms(lambda: kernels.attention_plain(*sub, sc), 3)
        b_a = call_bound("attn", G, N, M, D)
        log(f"stress attention (G, N, M, D) {(G, N, M, D)}: max_abs_err {err:.3e} (tol 1e-5, "
            f"{g} groups), repeat bit-equal {same}, ms {ms:.4f}, bound_ms {b_a:.5f}, plain_ms "
            f"on {g} groups {plain:.4f}")
        if not same or err > 1e-5:
            raise SystemExit(f"attention at {(G, N, M, D)} disagrees with its plain version or "
                             "did not repeat its bits")
        by_name["attention"].setdefault("keys_8192", []).append(
            {"G": G, "N": N, "M": M, "D": D, "plain_groups": g, "ms": ms, "bound_ms": b_a,
             "plain_ms": plain, "max_abs_err": err})
        del q, k, v, do, sub, att
        torch.cuda.empty_cache()


def stress_inputs(n, p0, dev):
    """``bench.py``'s stress inputs: the point p0 plus normal noise of scale
    10 (numpy seed n) for the first cloud, the second shifted by 0.05."""
    noise = np.random.default_rng(n).normal(size=(1, n, 3)).astype(np.float32) * 10.0
    x1 = (p0[None, None, :] * np.ones((1, n, 1), np.float32) + noise).astype(np.float32)
    return torch.from_numpy(x1).to(dev), torch.from_numpy(x1 + np.float32(0.05)).to(dev)


class capturing_fps:
    """Within: each FPS call of ``ops.sampling`` appended to ``calls`` as
    (pyramid?, xyz, npoints, indices)."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        sampling = importlib.import_module("mocopci_torch.ops.sampling")
        self.saved = fps, fps_pyramid = sampling.fps, sampling.fps_pyramid

        def one(xyz, npoint):
            out = fps(xyz, npoint)
            self.calls.append((False, xyz, int(npoint), out))
            return out

        def pyramid(xyz, npoints):
            out = fps_pyramid(xyz, npoints)
            self.calls.append((True, xyz, tuple(npoints), out))
            return out
        sampling.fps, sampling.fps_pyramid = one, pyramid
        return self

    def __exit__(self, *exc):
        sampling = importlib.import_module("mocopci_torch.ops.sampling")
        sampling.fps, sampling.fps_pyramid = self.saved


def stress_forward(kernels, cfg, model, x1, x2, mode, what):
    """One forward in kNN ``mode`` with the launch counts set to 0 before and
    read after; fails unless every stress kernel of the mode launched and the
    output is finite and of the right shape.  Returns (launches, output,
    the FPS calls)."""
    from mocopci_torch import interpolate
    from mocopci_torch.ops import set_knn_mode

    set_knn_mode(mode)
    calls, long_keys = [], {}
    kernels.reset_launches()
    with capturing_fps(calls), counting_long_attention(long_keys):
        out = interpolate(model, x1, x2)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"{what}: launches per forward: {launches}; attention launches over more than "
        f"{LONG_KEYS} keys: {long_keys}")
    if out.shape != (1, cfg.n_frames, cfg.npoints, 3) or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"{what}: output wrong: {tuple(out.shape)}")
    missing = [name for name in STRESS_KERNELS[mode] + STRESS_EXTRA.get(cfg.npoints, ())
               if launches[name] == 0]
    if missing or launches["fps"] or launches["fps_pyramid"]:
        raise SystemExit(f"{what}: kernels not launched: {missing}, or FPS on the one-block "
                         f"route: {launches['fps']}, {launches['fps_pyramid']}")
    if cfg.pyramid[0] > LONG_KEYS and not long_keys.get("attention"):
        raise SystemExit(f"{what}: no eval attention over more than {LONG_KEYS} keys")
    return launches, out, calls


def run_stress(kernels, n, dev, p0):
    """The eval forward at ``stress_model_config(n)``, B=1, on ``bench.py``'s
    stress inputs (path ``stress_<n>``, approx mode): launches, every FPS call
    bit-equal to its plain version on the same inputs, the median of 3
    forwards and their peak memory, one profiled forward (busy share, each
    FPS launch, the other kernels' device ms).  At 16384 also the forward
    against the same model on the CPU (CD <= 1e-4 a frame) and in exact mode
    (path ``stress_16384_exact``); at 32768 ``eval_step`` once (path
    ``stress_32768_eval``)."""
    from mocopci_torch import MoCoPCI, interpolate, stress_model_config
    from mocopci_torch.ops import set_knn_mode
    from mocopci_torch.training import eval_step

    cfg = stress_model_config(n)
    model = MoCoPCI(cfg, device=dev, seed=0)
    x1, x2 = stress_inputs(n, p0, dev)
    paths, stats = {}, {}
    what = f"stress {n}"
    paths[f"stress_{n}"], out, calls = stress_forward(kernels, cfg, model, x1, x2, "approx",
                                                      what)
    mism = 0
    for pyramid, xyz, npoints, got in calls:
        want = (kernels.fps_pyramid_plain(xyz, npoints) if pyramid
                else (kernels.fps_plain(xyz, npoints),))
        mism += sum(int((a != b).sum()) for a, b in zip(got if pyramid else (got,), want))
    log(f"{what}: {len(calls)} FPS calls against their plain versions on the same inputs: "
        f"index mismatches {mism}")
    if mism or len(calls) != 2:
        raise SystemExit(f"{what}: FPS differs from its plain version")

    def timed(mode):
        set_knn_mode(mode)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            interpolate(model, x1, x2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"{what} {mode}: B=1 eval forward median {np.median(times):.3f} ms over 3 runs "
            f"({', '.join(f'{t:.3f}' for t in times)}), peak memory {peak:.1f} MiB")
        return {"forward_ms": float(np.median(times)), "forward_ms_runs": times,
                "peak_mib": peak}

    stats["approx"] = timed("approx")
    busy = profile_fps_calls(lambda: interpolate(model, x1, x2), f"{what} forward")
    if "profile_device_ms" in busy:
        # the profiler's trace loses FPS launches: their CUDA-event time
        # takes the place of what it traced of them
        busy["busy_ms"] = (busy["profile_device_ms"] - busy["fps_traced_ms"]
                           + busy["fps_device_ms"])
        busy["fps_share_of_busy"] = busy["fps_device_ms"] / busy["busy_ms"]
        log(f"{what} forward: FPS {busy['fps_device_ms']:.4f} device ms, "
            f"{100 * busy['fps_share_of_busy']:.1f}% of the device's busy time, "
            f"{busy['busy_ms']:.3f} ms with the FPS launches the trace lost "
            f"({100 * busy['busy_ms'] / busy['profile_wall_ms']:.1f}% of the profiled wall)")
    stats["approx"].update(busy)
    if n == STRESS_SIZES[0]:
        t0 = time.perf_counter()
        ref = interpolate(MoCoPCI(cfg, device="cpu", seed=0), x1.cpu(), x2.cpu())
        cpu_s = time.perf_counter() - t0
        cds = [chamfer(out[0, j], ref[0, j].to(dev)) for j in range(cfg.n_frames)]
        log(f"{what}: CD card vs cpu per frame {cds} (cpu forward {cpu_s:.1f} s)")
        if max(cds) > 1e-4:
            raise SystemExit(f"{what}: card output differs from the CPU run")
        stats["approx"].update(cd_max=max(cds), cpu_forward_s=cpu_s)
        paths[f"stress_{n}_exact"], _, _ = stress_forward(kernels, cfg, model, x1, x2, "exact",
                                                          f"{what} exact")
        stats["exact"] = timed("exact")
        set_knn_mode("approx")
    else:
        gt = np.stack([(x1 + 0.05 * t).cpu().numpy()[0] for t in (0.25, 0.5, 0.75)])[None]
        batch = {"pc1": x1.cpu().numpy(), "pc2": x2.cpu().numpy(), "gt": gt}
        set_knn_mode("approx")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eval_step(model, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        paths[f"stress_{n}_eval"] = launches = dict(kernels.LAUNCHES)
        metrics = {k: float(v[0]) for k, v in m.items()}
        log(f"{what} eval_step: {ms:.3f} ms (host clock, once), metrics {metrics}, "
            f"launches {launches}")
        if not all(np.isfinite(v) for v in metrics.values()) or launches["chamfer_pair"] == 0:
            raise SystemExit(f"{what} eval_step: metrics {metrics}, chamfer_pair launches "
                             f"{launches['chamfer_pair']}")
        stats["eval_step"] = {"ms": ms, "metrics": metrics}
    del model
    torch.cuda.empty_cache()
    return paths, stats


# the kernels one train step launches in the default (approx) kNN mode
TRAIN_KERNELS = ("fps", "fps_pyramid", "knn_approx", "cross_tail", "cross_tail_bwd",
                 "transformer_tail", "transformer_tail_bwd", "attention_train_fwd",
                 "attention_train_fwd_wide", "attention_train_bwd", "attention_train_bwd_wide",
                 "fusion_pair_planes",
                 "fusion_head_train_fwd", "fusion_head_train_bwd", "chamfer_pair", "scatter_add")
TRAIN_FWD_ENTRIES = ("attention_train_fwd", "attention_train_fwd_wide")
TAIL_FWD_ENTRIES = ("transformer_tail", "transformer_tail_general")
TRAIN_STEPS = 6
ZERO_GRAD_LEAVES = {f"estimator.fusion_conv{i}.bias" for i in range(3)}


def run_train(kernels, cfg, dev):
    """``create_train_state`` at ``cfg`` with seed 0, then TRAIN_STEPS train
    steps at B=2 on synthetic pairs: finite losses, the kernels launched, the
    median step time of the last 5 (host clock, synchronized), peak memory;
    then one profiled step."""
    from mocopci_torch import ops
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import SyntheticInterpolationDataset, batches
    from mocopci_torch.training import create_train_state, train_step

    ops.set_knn_mode("approx")
    tcfg = TrainConfig()
    data = SyntheticInterpolationDataset(length=TRAIN_STEPS * tcfg.batch_size,
                                         num_points=cfg.npoints, seed=2)
    steps = list(batches(data, tcfg.batch_size, shuffle=False))
    model, state = create_train_state(cfg, tcfg, steps_per_epoch=len(steps), device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, auxes = [], []
    for batch in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = train_step(state, batch, rng)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        auxes.append({k: float(v) for k, v in aux.items()})
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train: launches per {len(steps)} steps: {launches}")
    for i, aux in enumerate(auxes):
        log(f"train: step {i} " + json.dumps({k: round(v, 6) for k, v in aux.items()}))
    bad = [i for i, aux in enumerate(auxes) if not all(np.isfinite(v) for v in aux.values())]
    if bad:
        raise SystemExit(f"train: loss not finite at steps {bad}")
    missing = [name for name in TRAIN_KERNELS if launches[name] == 0]
    if missing:
        raise SystemExit(f"train: kernels not launched on the train path: {missing}")
    step_ms = float(np.median(times[1:]))
    log(f"train: ModelConfig() B=2 step median {step_ms:.3f} ms over the last "
        f"{len(times) - 1} (first {times[0]:.1f} ms, min {min(times[1:]):.3f}, max "
        f"{max(times[1:]):.3f}), peak memory {peak / 2**20:.1f} MiB")
    busy = profile_attention_calls(lambda: train_step(state, steps[0], rng))
    return launches, {"step_ms": step_ms, "step_ms_all": times, "peak_mib": peak / 2**20,
                      "loss": [a["loss"] for a in auxes], **busy}


STRESS_TRAIN_STEPS = 4
# the train kernels of the stress step: above 8192 points FPS takes its
# cluster routes; at 32768 cross3's cost-volume tail (L3's 1024 queries, C =
# C2 = 256) takes its wide routes both ways
STRESS_TRAIN_KERNELS = tuple(f"{name}_cluster" if name.startswith("fps") else name
                             for name in TRAIN_KERNELS)
STRESS_TRAIN_EXTRA = {32768: ("cross_tail_wide", "cross_tail_bwd_wide")}
# the argument that holds M, the keys, in each attention entry's C call
ATTENTION_KEYS_ARG = {"attention": 6, "attention_wide": 6, "attention_train_fwd": 7,
                      "attention_train_fwd_wide": 7, "attention_train_bwd": 12,
                      "attention_train_bwd_wide": 12}
LONG_KEYS = 4096


class counting_long_attention:
    """Within: each attention launch over more than ``LONG_KEYS`` keys counted
    in ``counts`` by entry."""

    def __init__(self, counts):
        self.counts = counts

    def __enter__(self):
        lib = importlib.import_module("mocopci_torch.kernels._lib")
        launch = self.saved = lib.launch

        def spied(name, *args):
            launch(name, *args)
            if name in ATTENTION_KEYS_ARG and args[ATTENTION_KEYS_ARG[name]] > LONG_KEYS:
                self.counts[name] = self.counts.get(name, 0) + 1
        lib.launch = spied
        return self

    def __exit__(self, *exc):
        importlib.import_module("mocopci_torch.kernels._lib").launch = self.saved


def run_stress_train(kernels, n, dev, remat=False, n_steps=STRESS_TRAIN_STEPS):
    """``create_train_state`` at ``stress_model_config(n)`` (with ``remat``),
    ``TrainConfig(batch_size=1)``, seed 0, then ``n_steps`` train steps at B=1
    on synthetic pairs of n points, approx kNN, dropout on (path
    ``stress_train_<n>``, ``_remat`` with remat): finite losses, every train
    kernel launched (FPS on its cluster routes), the attention launches over
    more than 4096 keys, the median step time of all but the first (host
    clock, synchronized), peak memory; then, without remat, one profiled step
    (busy share, each FPS launch, the top device ops)."""
    import dataclasses

    from mocopci_torch import ops, stress_model_config
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import SyntheticInterpolationDataset, batches
    from mocopci_torch.training import create_train_state, train_step

    what = f"stress train {n}" + (" remat" if remat else "")
    ops.set_knn_mode("approx")
    cfg = dataclasses.replace(stress_model_config(n), remat=remat)
    tcfg = TrainConfig(batch_size=1)
    data = SyntheticInterpolationDataset(length=n_steps, num_points=n, seed=2)
    steps = list(batches(data, 1, shuffle=False))
    model, state = create_train_state(cfg, tcfg, steps_per_epoch=len(steps), device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    long_keys, times, auxes = {}, [], []
    with counting_long_attention(long_keys):
        for batch in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, aux = train_step(state, batch, rng)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            auxes.append({k: float(v) for k, v in aux.items()})
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"{what}: launches per {len(steps)} steps: {launches}")
    log(f"{what}: attention launches over more than {LONG_KEYS} keys: {long_keys}")
    for i, aux in enumerate(auxes):
        log(f"{what}: step {i} " + json.dumps({k: round(v, 6) for k, v in aux.items()}))
    bad = [i for i, aux in enumerate(auxes) if not all(np.isfinite(v) for v in aux.values())]
    if bad:
        raise SystemExit(f"{what}: loss not finite at steps {bad}")
    missing = [name for name in STRESS_TRAIN_KERNELS + STRESS_TRAIN_EXTRA.get(n, ())
               if launches[name] == 0]
    if missing or launches["fps"] or launches["fps_pyramid"]:
        raise SystemExit(f"{what}: kernels not launched: {missing}, or FPS on the one-block "
                         f"route: {launches['fps']}, {launches['fps_pyramid']}")
    if cfg.pyramid[0] > LONG_KEYS and not (long_keys.get("attention_train_fwd")
                                           and long_keys.get("attention_train_bwd")):
        raise SystemExit(f"{what}: no train attention over more than {LONG_KEYS} keys")
    step_ms = float(np.median(times[1:]))
    log(f"{what}: stress_model_config({n}) B=1 step median {step_ms:.3f} ms over the last "
        f"{len(times) - 1} (first {times[0]:.1f} ms, all {', '.join(f'{t:.3f}' for t in times)}"
        f"), peak memory {peak:.1f} MiB; {card_line()}")
    busy = {} if remat else profile_fps_calls(lambda: train_step(state, steps[0], rng),
                                              f"{what} step")
    if "profile_device_ms" in busy:
        busy["busy_ms"] = (busy["profile_device_ms"] - busy["fps_traced_ms"]
                           + busy["fps_device_ms"])
        log(f"{what} step: {busy['busy_ms']:.3f} device ms busy with the FPS launches the "
            f"trace lost ({100 * busy['busy_ms'] / busy['profile_wall_ms']:.1f}% of the "
            f"profiled wall)")
    del model, state
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "step_ms_all": times, "peak_mib": peak,
                      "loss": [a["loss"] for a in auxes], "long_key_launches": long_keys,
                      **busy}


def call_bound(kind, B, N, M, C, k=0, wide=False) -> float:
    """bound_ms of one call of the step or forward, counted as the kernel rows
    count it: the train attention forward ("fwd", 4 C + 3 flops a pair at
    f32; on the wide route 4 C at 3xTF32) and the eval attention ("attn", the
    same without the log-sum-exp written), the train attention backward
    ("bwd", 10 C + 6 at f32; 10 C at 3xTF32 on the wide route), (B, N, M, C)
    = (G, N, M, D); ``knn_approx`` ("knn", 2 C + 2 a pair at f32, k indices
    written); ``chamfer_pair`` ("chamfer", 9 flops a pair at f32, a key a
    point written)."""
    if kind in ("fwd", "attn"):
        nbytes = (2 * B * N * C + 2 * B * M * C + (B * N if kind == "fwd" else 0)) * F32
        return (bound(nbytes, B * N * M * 4.0 * C, PEAK_3XTF32_FLOPS) if wide
                else bound(nbytes, B * N * M * (4.0 * C + 3)))[0]
    if kind == "bwd":
        nbytes = (4 * B * N * C + 4 * B * M * C + B * N) * F32
        return (bound(nbytes, B * N * M * 10.0 * C, PEAK_3XTF32_FLOPS) if wide
                else bound(nbytes, B * N * M * (10.0 * C + 6)))[0]
    if kind == "chamfer":
        return bound((B * N + B * M) * (C * F32 + I32), 9.0 * B * N * M)[0]
    return bound((B * N * C + B * M * C) * F32 + B * N * k * I32, B * N * M * (2.0 * C + 2))[0]


def tail_fwd_work(B, M, N, K, D, route="transformer_tail"):
    """(bytes, f32 flops, tensor-core flops) of one transformer tail forward:
    the table, xq, q, the weights and idx read once, out written once;
    6 D^2 + 20 D + 3 flops a pair, of which the tiled route runs the three
    D x D products (6 D^2) at 3xTF32."""
    nbytes = ((B * M * (3 + 2 * D) + B * N * 3 + 2 * B * N * D + 3 * D * D + 7 * D) * F32
              + B * N * K * I32)
    pairs = B * N * K
    tc = pairs * 6.0 * D * D if route == "transformer_tail" else 0.0
    return nbytes, pairs * (6.0 * D * D + 20 * D + 3) - tc, tc


def tail_fwd_bound(B, M, N, K, D, route="transformer_tail") -> float:
    nbytes, f32, tc = tail_fwd_work(B, M, N, K, D, route)
    return bound(nbytes, f32, tc_flops=tc)[0]


def tail_bwd_work(B, M, N, K, D):
    """(bytes, flops) of one transformer tail backward: the table, xq, q,
    dout, the weights and idx read once, d_rows, dxq, dq and the weight
    gradients written once; 6 (3 D^2 + 3 D) flops a pair (the chain's
    products, recompute and VJP)."""
    nbytes = ((B * M * (3 + 2 * D) + 2 * B * N * 3 + 3 * B * N * D + 2 * (3 * D * D + 7 * D)
               + B * N * K * (3 + 2 * D)) * F32 + B * N * K * I32)
    return nbytes, B * N * K * 6.0 * (3 * D * D + 3 * D)


def tail_bwd_bound(B, M, N, K, D) -> float:
    """bound_ms of one tiled-route backward: its products at 3xTF32."""
    return bound(*tail_bwd_work(B, M, N, K, D), PEAK_3XTF32_FLOPS)[0]


# chamfer_pair's instructions a pair, fixed by its bit contract: 3 subtractions,
# a product and 2 FMAs, the key's mask and two add-and-min (DPX); the floor is
# one instruction a clock on each of an H100's 132 x 4 schedulers at 1.98 GHz
CHAMFER_ISSUE = 9


def chamfer_floor(G, N, M) -> float:
    return G * N * M * CHAMFER_ISSUE / (132 * 4 * 32 * 1.98e9) * 1e3


def tail_bound(B, M, N, K, C, C2, argmax=False, bwd=False) -> float:
    """bound_ms of one cost-volume tail forward, counted as its kernel row
    counts it: the table, base, W, b and idx read once, out (and the argmax,
    a byte an entry for K <= 255) written once; 2 C C2 + 2 C + 3 C2 f32
    flops a pair.  With ``bwd``, of one backward (``cross_bwd_work``)."""
    if bwd:
        return bound(*cross_bwd_work(B, M, N, K, C, C2))[0]
    nbytes = ((B * M * C + B * N * C + C * C2 + C2 + B * N * C2) * F32 + B * N * K * I32
              + (B * N * C2 * (1 if K <= 255 else 4) if argmax else 0))
    return bound(nbytes, B * N * K * (2.0 * C * C2 + 2 * C + 3 * C2))[0]


def cross_bwd_work(B, M, N, K, C, C2):
    """(bytes, f32 flops) of one cost-volume tail backward from the saved
    argmax, as the ``cross_tail_bwd`` row counts them: the table, base, W,
    out, dout, idx and the argmax (a byte an entry for K <= 255) read once,
    d_rows, d_base, dW and db written once; gv W into one row a channel and
    dW (4 C C2 a query) and leaky' of every row (3 K C a query)."""
    nbytes = ((B * M * C + 2 * B * N * C + 2 * C * C2 + C2 + 2 * B * N * C2 + B * N * K * C)
              * F32 + B * N * K * I32 + B * N * C2 * (1 if K <= 255 else 4))
    return nbytes, B * N * (4.0 * C * C2 + 3 * K * C)


class recording:
    """Within: each ``_lib.launch`` of an entry in ``names`` is appended to
    ``launched`` as (name, args, start, end), CUDA events recorded around
    it."""

    def __init__(self, launched, names):
        self.launched, self.names = launched, names

    def __enter__(self):
        lib = importlib.import_module("mocopci_torch.kernels._lib")
        launch = self.saved = lib.launch

        def spied(name, *args):
            if name not in self.names:
                return launch(name, *args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launch(name, *args)
            end.record()
            self.launched.append((name, args, start, end))
        lib.launch = spied
        return self

    def __exit__(self, *exc):
        importlib.import_module("mocopci_torch.kernels._lib").launch = self.saved


def call_shape_bound(name, args):
    """(shape, bound_ms) of one recorded launch: of the train attention
    forward, ``knn_approx``, the eval attention, ``chamfer_pair``, the
    transformer tail (either direction) or the cost-volume tail's forward,
    from its C arguments."""
    if name == "chamfer_pair":
        return (f"(G, N, M) {args[2:5]}, threads {args[6]}, span {args[7]}",
                call_bound("chamfer", *args[2:5], 3))
    if name.startswith("transformer_tail_bwd"):
        return f"(B, M, N, K, D) {args[18:23]}, route {name}", tail_bwd_bound(*args[18:23])
    if name.startswith("transformer_tail"):
        return (f"(B, M, N, K, D) {args[13:18]}, route {name}",
                tail_fwd_bound(*args[13:18], route=name))
    if name == "knn_approx":
        return (f"(B, N, M, C) {args[3:7]}, k {args[7]}, metric {args[8]}",
                call_bound("knn", *args[3:7], k=args[7]))
    if name == "knn":
        return (f"(B, N, M, C) {args[2:6]}, k {args[6]}, metric {args[7]}, route "
                f"{knn_route(args)}", call_bound("knn", *args[2:6], k=args[6]))
    if name.startswith("attention_train_fwd"):
        rate = 0.0 if args[11] == 0 and args[12] == 1.0 else 1.0 - 1.0 / args[12]
        return (f"(G, N, M, D, rate) {(*args[5:9], round(rate, 6))}, route {name}",
                call_bound("fwd", *args[5:9], wide=name.endswith("_wide")))
    if name.startswith("attention"):
        return (f"(G, N, M, D) {args[4:8]}, route {name}",
                call_bound("attn", *args[4:8], wide=name.endswith("_wide")))
    B, M, N, K, C, C2 = args[7:13]
    return (f"(B, M, N, K, C, C2) {args[7:13]}, argmax {bool(args[6])}",
            tail_bound(B, M, N, K, C, C2, argmax=bool(args[6])))


def knn_route(args) -> str:
    """The route of a recorded exact ``knn`` launch: the filtered scan of xyz
    rows (Euclidean, C <= 8) or the dot form."""
    return "xyz" if args[7] == 0 and args[5] <= 8 else "dot"


def kernels_of(name, args) -> int:
    """The device kernels one recorded launch runs: two for exact ``knn``'s
    dot form over more than one reference span (the spans, then their
    merge), else one."""
    return 2 if name == "knn" and knn_route(args) == "dot" and args[9] > 1 else 1


def log_calls(prof, launched, names, what):
    """Each recorded launch of an entry in ``names``: its shape, device ms by
    CUDA events and, where the profiler traced every kernel of every one, by
    the profiler (the sum of the launch's kernels, ``kernels_of``), and its
    bound (``call_shape_bound``); then the sums and the lost time (device ms
    less the calls' bounds)."""
    from torch.autograd import DeviceType

    symbols = [key for key, v in KERNEL_SYMBOLS.items() if v in names]
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and any(sym in e.name for sym in symbols))
    mine = [c for c in launched if c[0] in names]
    counts = [kernels_of(name, args) for name, args, _, _ in mine]
    traced = len(spans) == sum(counts)
    total = lost = bounds = 0.0
    routes = {}     # route -> [calls, device ms by the profiler, bounds]
    first = 0
    for (name, args, start, end), n in zip(mine, counts):
        ms = start.elapsed_time(end)
        shape, b_ms = call_shape_bound(name, args)
        total, lost, bounds = total + ms, lost + ms - b_ms, bounds + b_ms
        dev_ms = sum(b - a for a, b in spans[first:first + n]) / 1e3 if traced else 0.0
        first += n
        r = routes.setdefault(knn_route(args) if name == "knn" else name, [0, 0.0, 0.0])
        r[0] += 1
        r[1] += dev_ms
        r[2] += b_ms
        log(f"{what} {shape}: device ms {ms:.4f} by CUDA events, "
            + (f"{dev_ms:.4f} by the profiler over {n} kernel{'s' * (n > 1)}, lost "
               f"{dev_ms - b_ms:.4f}" if traced
               else "not matched in the profile") + f", bound_ms {b_ms:.5f}")
    if len(routes) > 1 and traced:
        log(f"{what} by route: " + "; ".join(
            f"{r}: {c} calls, device ms {d:.4f} by the profiler, lost {d - b:.4f}"
            for r, (c, d, b) in routes.items()))
    # CUDA events also time the host's gap before a launch; the profiler's
    # device time, less the calls' bounds, is the lost time to rank by
    traced_ms = sum(b - a for a, b in spans) / 1e3
    log(f"{what}: {len(mine)} launches, device ms {total:.4f} by CUDA events (lost "
        f"{lost:.4f}); the profiler traced {len(spans)} of their kernels, device ms "
        f"{traced_ms:.4f}, lost {traced_ms - bounds:.4f} (bounds {bounds:.4f})")


def profile_attention_calls(step):
    """One profiled train step (``profile``), with each train attention
    backward logged: (G, N, M, D, rate), its route and the device ms of its
    3 kernels (the dot pass, the route's main kernel, the dq pass), in call
    order; then each forward, (G, N, M, D, rate), its route and the device ms
    of its kernel; then each ``knn_approx`` launch, (B, N, M, C), k and its
    metric, and each cost-volume tail forward, (B, M, N, K, C, C2); each of
    these by CUDA events around the launch and, where the profiler traced
    every one of their kernels, by the profiler.  Beside each call its bound
    (``call_shape_bound``), and for each kernel the time lost over the step:
    the sum of device ms minus bound over its calls."""
    from torch.autograd import DeviceType

    attention_train = importlib.import_module("mocopci_torch.kernels.attention_train")
    calls, launched = [], []
    bwd = attention_train.attention_train_bwd

    def recorded(q, k, v, out, lse, dout, seed, scale, rate):
        calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], rate))
        return bwd(q, k, v, out, lse, dout, seed, scale, rate)

    def per_call(prof):
        symbols = [k for k, v in KERNEL_SYMBOLS.items() if v.startswith("attention_train_bwd")]
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and any(sym in e.name for sym in symbols))
        total = lost = 0.0
        for shape in calls:
            ms = sum(end - start for start, end in spans[:3]) / 1e3
            spans = spans[3:]
            wide = shape[3] > attention_train.MAX_BWD_D
            b_ms = call_bound("bwd", *shape[:4], wide=wide)
            total, lost = total + ms, lost + ms - b_ms
            log(f"train attention bwd (G, N, M, D, rate) {shape}: "
                f"{'wide' if wide else 'one-pass'} route, device ms {ms:.4f}, bound_ms "
                f"{b_ms:.5f}")
        log(f"train attention bwd: {len(calls)} calls, device ms {total:.4f}, lost {lost:.4f}; "
            f"kernels not matched to a call {len(spans)}")
        if not calls:
            raise SystemExit("profile: the train step called no attention backward")
        log_calls(prof, launched, TRAIN_FWD_ENTRIES, "train attention fwd")
        log_calls(prof, launched, ("knn_approx",), "train knn_approx")
        log_calls(prof, launched, ("cross_tail",), "train cross_tail fwd")
        log_calls(prof, launched, ("chamfer_pair",), "train chamfer_pair")
        log_calls(prof, launched, TAIL_FWD_ENTRIES, "train transformer_tail fwd")
        log_calls(prof, launched, ("transformer_tail_bwd",), "train transformer_tail bwd")

    attention_train.attention_train_bwd = recorded
    try:
        with recording(launched, TRAIN_FWD_ENTRIES + TAIL_FWD_ENTRIES + (
                "knn_approx", "cross_tail", "chamfer_pair", "transformer_tail_bwd")):
            return profile_fps_calls(step, "train step", per_call)
    finally:
        attention_train.attention_train_bwd = bwd


def sm_clock() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0] if out.strip() else "not read"


FPS_SYMBOLS = ("fps_kernel", "fps_pyramid_kernel", "fps_cluster_kernel",
               "fps_pyramid_cluster_kernel")


def profile_fps_calls(fn, what, trace=None):
    """One profiled call of ``fn`` (``profile``), with each FPS launch logged
    in call order: its entry (the one-block or the cluster route, by N),
    (B, N, npoints), device ms by CUDA events around the launch and, where
    the profiler traced every FPS kernel, by the profiler, and µs a step;
    the SM clock, power and temperature read before and after.  ``trace``,
    when given, reads the profile too.  The result carries the FPS device ms
    (``fps_device_ms``, by the profiler where it traced every launch, else by
    CUDA events) and what the profiler traced of it (``fps_traced_ms``)."""
    from torch.autograd import DeviceType

    sampling = importlib.import_module("mocopci_torch.ops.sampling")
    fps_mod = importlib.import_module("mocopci_torch.kernels.fps")
    calls, saved, totals = [], (sampling.fps, sampling.fps_pyramid), {}

    def timed(entry, launch, xyz, npoints):
        if xyz.shape[1] > fps_mod.BLOCK_MAX_N:
            entry += "_cluster"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch()
        end.record()
        calls.append((entry, xyz.shape[0], xyz.shape[1], npoints, start, end))
        return out

    def fps(xyz, npoint):
        return timed("fps", lambda: saved[0](xyz, npoint), xyz, (int(npoint),))

    def fps_pyramid(xyz, npoints):
        return timed("fps_pyramid", lambda: saved[1](xyz, npoints), xyz, tuple(npoints))

    def per_call(prof):
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and any(sym in e.name for sym in FPS_SYMBOLS))
        traced = len(spans) == len(calls)
        total = 0.0
        for i, (entry, B, N, npoints, start, end) in enumerate(calls):
            ms = start.elapsed_time(end)
            total += ms
            steps = max(1, sum(n - 1 for n in npoints))
            prof_ms = (spans[i][1] - spans[i][0]) / 1e3 if traced else None
            log(f"{what} fps launch {entry} (B, N, npoints) ({B}, {N}, {npoints}): device ms "
                f"{ms:.4f} by CUDA events ({1e3 * ms / steps:.4f} us a step), "
                + (f"{prof_ms:.4f} by the profiler ({1e3 * prof_ms / steps:.4f} us a step)"
                   if traced else "not matched in the profile"))
        traced_ms = sum(b - a for a, b in spans) / 1e3
        log(f"{what} fps: {len(calls)} launches, device ms {total:.4f} by CUDA events; the "
            f"profiler traced {len(spans)} FPS kernels, device ms {traced_ms:.4f}")
        totals["fps_device_ms"] = traced_ms if traced else total
        totals["fps_traced_ms"] = traced_ms
        if trace is not None:
            trace(prof)

    sampling.fps, sampling.fps_pyramid = fps, fps_pyramid
    try:
        log(f"{what}: SM clock, max, power, temperature before: {sm_clock()}")
        busy = profile(fn, what, per_call)
        log(f"{what}: SM clock, max, power, temperature after: {sm_clock()}")
        return {**busy, **totals}
    finally:
        sampling.fps, sampling.fps_pyramid = saved


def run_train_parity(kernels, dev):
    """One step's loss and gradients at tiny_model_config(4096) (level 1 and
    the refine head at 1024, so both tails and every train kernel run), B=2,
    exact kNN, dropout rates 0, the same weights, on the card and on the CPU:
    loss components within rel 1e-4; the whole gradient (all leaves as one
    vector) within rel L2 1e-3 and every leaf within rel L2 5e-2 plus 1e-6
    absolute.  The sums run in another order on the two devices, so a near
    tie of a max over neighbours or channels, a ReLU kink or a kNN selection
    can go the other way and move a row's gradient to its neighbour: the loss
    barely moves, a leaf's gradient can by a few percent; a leaf whose
    gradient cancels to near zero keeps the float32 noise of its terms.  The
    gradients are compared, not an AdamW update of them, whose first step
    turns noise on near-zero gradients into +-lr.  The biases before the
    fusion head's train-mode BatchNorms have a gradient of exactly zero: on
    both devices it must stay below 1e-5 of their weight's gradient."""
    import dataclasses

    from mocopci_torch import MoCoPCI, ops, tiny_model_config
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.training.loop import loss_and_grads

    cfg = dataclasses.replace(tiny_model_config(4096), attn_drop=0.0, proj_drop=0.0,
                              drop_path=0.0)
    rng = np.random.default_rng(3)
    x1 = (rng.normal(size=(2, cfg.npoints, 3)) * 5).astype(np.float32)
    flow = (0.3 * rng.normal(size=(2, 1, 3))).astype(np.float32)
    batch = {"pc1": x1, "pc2": x1 + flow,
             "gt": np.stack([x1 + flow * t for t in (0.25, 0.5, 0.75)], 1).astype(np.float32)}
    ops.set_knn_mode("exact")
    card_model, cpu_model = MoCoPCI(cfg, device=dev), MoCoPCI(cfg, device="cpu")
    kernels.reset_launches()
    got = loss_and_grads(card_model, batch, None, cfg, TrainConfig())
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    want = loss_and_grads(cpu_model, batch, None, cfg, TrainConfig())
    cpu_s = time.perf_counter() - t0
    ops.set_knn_mode("approx")
    loss_gap = {k: abs(float(got[k]) - float(v)) / abs(float(v)) for k, v in want.items()}
    grad_gap = {}       # leaf gap over its limit: <= 1 passes
    cpu_grads = dict(cpu_model.named_parameters())
    d2 = g2 = 0.0
    for name, p in card_model.named_parameters():
        q = cpu_grads[name].grad
        if name in ZERO_GRAD_LEAVES:
            # a bias before a train-mode BatchNorm: its gradient is exactly 0
            w_norm = float(torch.linalg.vector_norm(cpu_grads[name[:-4] + "weight"].grad))
            grad_gap[name] = max(float(torch.linalg.vector_norm(p.grad)),
                                 float(torch.linalg.vector_norm(q))) / (1e-5 * w_norm)
            continue
        gap = float(torch.linalg.vector_norm(p.grad.cpu() - q))
        norm = float(torch.linalg.vector_norm(q))
        grad_gap[name] = gap / (5e-2 * norm + 1e-6)
        d2, g2 = d2 + gap ** 2, g2 + norm ** 2
    whole = (d2 / g2) ** 0.5
    worst = sorted(grad_gap.items(), key=lambda kv: -kv[1])[:5]
    log(f"train parity: launches {launches}")
    log(f"train parity: loss relative gaps {json.dumps(loss_gap)} (limit 1e-4); largest "
        f"gradient rel L2 gap {whole:.3e} (limit 1e-3); largest leaf gaps over their limit "
        f"{worst} over {len(grad_gap)} leaves (limit 1); CPU step {cpu_s:.1f} s")
    missing = [n for n in TRAIN_KERNELS if n != "knn_approx" and launches[n] == 0]
    if missing or max(loss_gap.values()) > 1e-4 or whole > 1e-3 or max(grad_gap.values()) > 1:
        raise SystemExit(f"train parity: card differs from the CPU (or kernels missing: "
                         f"{missing})")
    return {"loss_gap": loss_gap, "grad_gap_whole": whole, "worst_leaves": worst}


def run_train_refine_k(kernels, dev, refine_k=8):
    """One train step at ``ModelConfig()`` with ``refine_k`` (B=2, synthetic
    pairs, seed 4): finite losses, and the refine head's transformer tail,
    forward and backward, on their general routes (``BWD_SHAPES`` holds
    refine_k 16 and 4)."""
    import dataclasses

    from mocopci_torch import ModelConfig, ops
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import SyntheticInterpolationDataset, batches
    from mocopci_torch.training import create_train_state, train_step

    ops.set_knn_mode("approx")
    cfg = dataclasses.replace(ModelConfig(), refine_k=refine_k)
    tcfg = TrainConfig()
    data = SyntheticInterpolationDataset(length=tcfg.batch_size, num_points=cfg.npoints, seed=4)
    batch = next(iter(batches(data, tcfg.batch_size, shuffle=False)))
    _, state = create_train_state(cfg, tcfg, steps_per_epoch=1, device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, aux = train_step(state, batch, rng)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    aux = {k: float(v) for k, v in aux.items()}
    log(f"train refine_k={refine_k}: one step {step_ms:.1f} ms, "
        + json.dumps({k: round(v, 6) for k, v in aux.items()}) + f", launches {launches}")
    if not all(np.isfinite(v) for v in aux.values()):
        raise SystemExit(f"train refine_k={refine_k}: loss not finite")
    if (launches["transformer_tail_bwd_general"] == 0 or launches["transformer_tail_bwd"]
            or launches["transformer_tail_general"] == 0 or launches["transformer_tail"]):
        raise SystemExit(f"train refine_k={refine_k}: the tail took another route")
    return launches, {"step_ms": step_ms, "loss": aux["loss"]}


def run_train_cli(kernels):
    """The train CLI in-process at ModelConfig() on 4 synthetic samples: one
    epoch, then a resume to the second."""
    import shutil
    import tempfile

    from mocopci_torch.cli import train as cli_train

    save_dir = tempfile.mkdtemp(prefix="mocopci_train_cli_")
    try:
        common = ["--synthetic", "4", "--batch_size", "2", "--save_dir", save_dir,
                  "--log_every", "1"]
        kernels.reset_launches()
        first = cli_train.main(common + ["--epochs", "1"])
        second = cli_train.main(common + ["--epochs", "2", "--resume"])
        launches = dict(kernels.LAUNCHES)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    log(f"train cli: launches {launches}")
    ok = (first["step"] == 2 and second["start_epoch"] == 1 and second["step"] == 4
          and all(np.isfinite(v) for e in first["epochs"] + second["epochs"] for v in e.values()))
    if not ok or launches["fusion_head_train_bwd"] == 0:
        raise SystemExit(f"train cli: unexpected result {first} / {second}")
    return {"first": first["epochs"], "second": second["epochs"]}


# the forward kernels of the four remat stages, which their recompute launches again
REMAT_FWD_KERNELS = ("knn_approx", "cross_tail", "attention_train_fwd", "transformer_tail",
                     "fusion_pair_planes", "fusion_head_train_fwd")
REMAT_STEPS = 6
# leaves whose gradient is exactly 0 in exact arithmetic: the biases before a
# train-mode BatchNorm, and the refine head's last logit bias, which adds one
# constant over the neighbours of a softmax
ROUNDING_LEAVES = ZERO_GRAD_LEAVES | {"estimator.shape1.fc_gamma2.bias"}


def grad_gaps(got, want):
    """The whole gradient's relative L2 gap of ``got`` to ``want`` (name ->
    tensor) and each leaf's; ``ROUNDING_LEAVES`` are measured against their
    weight's gradient."""
    d2 = g2 = 0.0
    leaves = {}
    for name, q in want.items():
        gap = float(torch.linalg.vector_norm((got[name] - q).double()))
        if name in ROUNDING_LEAVES:
            leaves[name] = gap / float(torch.linalg.vector_norm(want[name[:-4] + "weight"]))
            continue
        norm = float(torch.linalg.vector_norm(q.double()))
        leaves[name] = gap / max(norm, 1e-30)
        d2, g2 = d2 + gap ** 2, g2 + norm ** 2
    return (d2 / g2) ** 0.5, leaves


def run_train_remat(kernels, dev):
    """Path ``train_remat``: at ``ModelConfig()``, B=2, approx kNN, dropout on,
    from the same weights (seed 0) and generator seed, ``loss_and_grads``
    without and with remat: the loss bit-equal, the gradients within relative
    L2 1e-6 and each leaf within 1e-4, the running statistics and the
    generator's state after the step equal, more launches of every forward
    kernel of the four stages with remat (the recompute); then REMAT_STEPS - 1
    ``train_step``s each, their median and the peak memory of each."""
    import dataclasses

    from mocopci_torch import ModelConfig, ops
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import SyntheticInterpolationDataset, batches
    from mocopci_torch.training import create_train_state, train_step
    from mocopci_torch.training.loop import loss_and_grads

    ops.set_knn_mode("approx")
    tcfg = TrainConfig()
    data = SyntheticInterpolationDataset(length=REMAT_STEPS * tcfg.batch_size,
                                         num_points=ModelConfig().npoints, seed=2)
    steps = list(batches(data, tcfg.batch_size, shuffle=False))
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(ModelConfig(), remat=remat)
        model, state = create_train_state(cfg, tcfg, steps_per_epoch=len(steps), device=dev)
        rng = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        aux = loss_and_grads(model, steps[0], rng, cfg, tcfg)
        torch.cuda.synchronize()
        run = {"launches": dict(kernels.LAUNCHES), "loss": {k: float(v) for k, v in aux.items()},
               "loss_bits": {k: v.detach().clone() for k, v in aux.items()},
               "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
               "stats": {n: b.clone() for n, b in model.named_buffers()},
               "rng": rng.get_state(), "times": []}
        for batch in steps[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch, rng)
            torch.cuda.synchronize()
            run["times"].append((time.perf_counter() - t0) * 1e3)
        run["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        runs[remat] = run
        del model, state
    plain, remat = runs[False], runs[True]
    whole, leaves = grad_gaps(remat["grads"], plain["grads"])
    worst = sorted(leaves.items(), key=lambda kv: -kv[1])[:4]
    loss_equal = all(torch.equal(remat["loss_bits"][k], v) for k, v in plain["loss_bits"].items())
    stats_equal = all(torch.equal(remat["stats"][n], b) for n, b in plain["stats"].items())
    rng_equal = torch.equal(remat["rng"], plain["rng"])
    fewer = [k for k in REMAT_FWD_KERNELS if remat["launches"][k] <= plain["launches"][k]]
    for name, run in (("without remat", plain), ("with remat", remat)):
        log(f"train remat: {name}: loss {run['loss']['loss']!r}, launches of one step "
            f"{ {k: run['launches'][k] for k in REMAT_FWD_KERNELS} }, train_step median "
            f"{np.median(run['times']):.3f} ms of {len(run['times'])} "
            f"({', '.join(f'{t:.3f}' for t in run['times'])}), peak memory "
            f"{run['peak_mib']:.1f} MiB; {card_line()}")
    log(f"train remat: loss bit-equal {loss_equal}, gradient rel L2 gap {whole:.3e} (limit "
        f"1e-6), largest leaf gaps {worst} (limit 1e-4), running statistics equal "
        f"{stats_equal}, generator state equal {rng_equal}")
    if (not (loss_equal and stats_equal and rng_equal) or whole > 1e-6
            or worst[0][1] > 1e-4 or fewer):
        raise SystemExit(f"train remat: the remat step differs from the step without it, or "
                         f"no recompute of {fewer}")
    return remat["launches"], {
        "step_ms": float(np.median(remat["times"])), "step_ms_plain": float(
            np.median(plain["times"])), "peak_mib": remat["peak_mib"],
        "peak_mib_plain": plain["peak_mib"], "grad_gap_whole": whole}


class torchrun_env:
    """Within: the environment ``torchrun`` gives rank 0 of one process on
    this card (``env://`` on a free local port)."""

    KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

    def __enter__(self):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0")
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_train_dp1(kernels, dev):
    """Path ``train_dp1``: the data-parallel step over NCCL at world size 1
    (``parallel.init_distributed``, as ``torchrun`` starts it) at
    ``ModelConfig()``, B=2, approx kNN.  Dropout off: ``dp_train_step``'s loss
    components, gradients, parameters and running statistics bit-equal to
    ``train_step``'s from the same weights.  The step's ``index_add_``s sum
    by atomics, so these three steps run under PyTorch's deterministic
    algorithms, and a second ``train_step`` must repeat the first's bits;
    then one DP step with dropout on: finite values."""
    import dataclasses

    from mocopci_torch import ModelConfig, ops, parallel
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import SyntheticInterpolationDataset, batches
    from mocopci_torch.training import create_train_state, train_step
    from mocopci_torch.training.loop import dp_train_step

    ops.set_knn_mode("approx")
    tcfg = TrainConfig()
    data = SyntheticInterpolationDataset(length=tcfg.batch_size,
                                         num_points=ModelConfig().npoints, seed=6)
    batch = next(iter(batches(data, tcfg.batch_size, shuffle=False)))
    no_dropout = dataclasses.replace(ModelConfig(), attn_drop=0.0, proj_drop=0.0,
                                     drop_path=0.0)

    def one(step, cfg=no_dropout, rng=None):
        model, state = create_train_state(cfg, tcfg, steps_per_epoch=1, device=dev)
        _, aux = step(state, batch, rng)
        torch.cuda.synchronize()
        out = {"aux": {k: v.detach().clone() for k, v in aux.items()},
               "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
               "params": {n: p.detach().clone() for n, p in model.named_parameters()},
               "stats": {n: b.clone() for n, b in model.named_buffers()}}
        del model, state
        return out

    def same(a, b):
        return [f"{part}.{k}" for part in a for k, v in a[part].items()
                if not torch.equal(v, b[part][k])]

    with torchrun_env():
        if not parallel.init_distributed(dev):
            raise SystemExit("train dp1: no process group started")
        try:
            backend = torch.distributed.get_backend()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                kernels.reset_launches()
                t0 = time.perf_counter()
                dp = one(lambda st, b, r: dp_train_step(st, b, r))
                dp_s = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
                plain, control = one(train_step), one(train_step)
            finally:
                torch.use_deterministic_algorithms(False)
            rng = parallel.rank_generator(tcfg.seed, 0, dev)
            dropout = one(lambda st, b, r: dp_train_step(st, b, r), ModelConfig(), rng)
        finally:
            parallel.shutdown_distributed()
    differ, control_differ = same(dp, plain), same(control, plain)
    finite = all(bool(torch.isfinite(v)) for v in dropout["aux"].values())
    log(f"train dp1: backend {backend}, world 1; DP step {dp_s:.2f} s; loss "
        f"{float(dp['aux']['loss'])!r}, train_step's {float(plain['aux']['loss'])!r}; "
        f"tensors that differ from train_step's: DP step {len(differ)} {differ[:6]}, a second "
        f"train_step {len(control_differ)} {control_differ[:6]}; dropout on: "
        + json.dumps({k: round(float(v), 6) for k, v in dropout["aux"].items()}))
    if backend != "nccl" or differ or control_differ or not finite:
        raise SystemExit("train dp1: the DP step at world size 1 differs from train_step, "
                         "or train_step from itself")
    return launches, {"dp_step_s": dp_s, "control_differs": len(control_differ)}


def run_train_cli_dp(kernels):
    """Path ``train_cli_dp``: the train CLI in-process at ModelConfig() on 4
    synthetic samples under NCCL at world size 1 (``torchrun``'s environment),
    ``--dp_impl shard_map --remat --grad_accum 2 --multihost``: one epoch, then
    ``--resume`` to the second."""
    import shutil
    import tempfile

    from mocopci_torch.cli import train as cli_train

    save_dir = tempfile.mkdtemp(prefix="mocopci_train_cli_dp_")
    try:
        common = ["--synthetic", "4", "--batch_size", "2", "--save_dir", save_dir,
                  "--log_every", "1", "--dp_impl", "shard_map", "--remat", "--grad_accum", "2",
                  "--multihost"]
        kernels.reset_launches()
        with torchrun_env():
            first = cli_train.main(common + ["--epochs", "1"])
        with torchrun_env():
            second = cli_train.main(common + ["--epochs", "2", "--resume"])
        launches = dict(kernels.LAUNCHES)
        group_left = torch.distributed.is_initialized()
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    log(f"train cli dp: launches {launches}")
    ok = (first["step"] == 2 and second["start_epoch"] == 1 and second["step"] == 4
          and all(np.isfinite(v) for e in first["epochs"] + second["epochs"] for v in e.values()))
    if not ok or group_left or launches["fusion_head_train_bwd"] == 0:
        raise SystemExit(f"train cli dp: unexpected result {first} / {second}")
    return launches, {"first": first["epochs"], "second": second["epochs"]}


# device-kernel name fragment -> port kernel, for the profile breakdown
KERNEL_SYMBOLS = {"fps_kernel": "fps", "fps_pyramid_kernel": "fps_pyramid",
                  "fps_cluster_kernel": "fps_cluster",
                  "fps_pyramid_cluster_kernel": "fps_pyramid_cluster",
                  "knn_exact_xyz_kernel": "knn",
                  "knn_dot_kernel": "knn", "knn_merge_kernel": "knn",
                  "knn_approx_xyz_kernel": "knn_approx",
                  "knn_approx_dot_kernel": "knn_approx", "chamfer_pair_kernel": "chamfer_pair",
                  "attention_eval_kernel": "attention",
                  "attention_eval_wide_kernel": "attention_wide",
                  "cross_tail_kernel": "cross_tail",
                  "cross_tail_wide_kernel": "cross_tail_wide",
                  "transformer_tail_fwd_kernel": "transformer_tail",
                  "transformer_tail_general_kernel": "transformer_tail_general",
                  "fusion_pair_kernel": "fusion_pair",
                  "scatter_add_": "scatter_add",     # every kernel of scatter_add.cu
                  "attention_train_fwd_kernel": "attention_train_fwd",
                  "attention_train_fwd_wide_kernel": "attention_train_fwd_wide",
                  "attention_train_bwd_dot_kernel": "attention_train_bwd dot and dq passes "
                                                    "(both routes)",
                  "attention_train_bwd_kernel": "attention_train_bwd",
                  "attention_train_bwd_dq_kernel": "attention_train_bwd dot and dq passes "
                                                   "(both routes)",
                  "attention_train_bwd_wide_kernel": "attention_train_bwd_wide",
                  "cross_tail_bwd_kernel": "cross_tail_bwd",
                  "cross_tail_bwd_wide_": "cross_tail_bwd_wide",   # every launch of the route
                  "transformer_tail_bwd_kernel": "transformer_tail_bwd",
                  "transformer_tail_bwd_general_kernel": "transformer_tail_bwd_general",
                  "fusion_pair_planes_kernel": "fusion_pair_planes",
                  "fusion_head_fwd_kernel": "fusion_head_train_fwd",
                  "fusion_head_bwd_kernel": "fusion_head_train_bwd",
                  "reduce_partials_kernel": "block partial sums (tails, fusion_head_train)",
                  "select_min_k_kernel": "select_min_k",
                  "onehot_scatter_kernel": "onehot_scatter",
                  "pair_planes_rows_kernel": "pair_planes_rows",
                  "pair_planes_bwd_kernel": "pair_planes_bwd"}


def profile(fn, what: str, trace=None) -> dict:
    """One call of ``fn`` under torch.profiler: device time per port kernel, the
    rest (PyTorch's own kernels) by name, and the device's busy share of the
    profiled wall time (the profiler's own overhead inflates the wall);
    ``trace(prof)``, when given, reads the profile further."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel, other = {}, {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        # kernels only: an operator's device time repeats its kernels'
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        port = next((v for k, v in KERNEL_SYMBOLS.items() if k in e.key), None)
        bucket = per_kernel if port else other
        name = port or e.key[:60]
        bucket[name] = bucket.get(name, 0.0) + us / 1e3
    device_ms = sum(per_kernel.values()) + sum(other.values())
    if device_ms == 0.0:
        log(f"profile {what}: the profiler recorded no device time; breakdown not measured")
        return {"profile": "not measured"}
    if trace is not None:
        trace(prof)
    log(f"profile {what}: device busy {device_ms:.3f} ms of {wall_ms:.3f} ms profiled wall "
        f"({100 * device_ms / wall_ms:.1f}%)")
    log(f"profile {what}: port kernels ms " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])}))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile {what}: top other kernels ms " + json.dumps({k: round(v, 4) for k, v in top}))
    return {"profile_device_ms": device_ms, "profile_wall_ms": wall_ms,
            "profile_port_kernels_ms": sum(per_kernel.values())}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="TREE",
                    help="another checkout whose kernels in PARENT_SOURCES are timed beside "
                         "this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mocopci_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from mocopci_torch import MoCoPCI, ModelConfig, kernels
    from mocopci_torch.data import SyntheticInterpolationDataset
    from mocopci_torch.device import resolve_device
    from mocopci_torch.kernels import _lib

    card = card_line()
    nvcc = subprocess.run([_lib._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout
    release = re.search(r"release ([\d.]+)", nvcc)
    log(f"probe: {card} | torch {torch.__version__} | torch.version.cuda {torch.version.cuda}"
        f" | nvcc {release.group(1) if release else '?'}"
        f" | triton {importlib.util.find_spec('triton') is not None}")

    t0 = time.perf_counter()
    finish_parent = build_parent(args.parent) if args.parent else None
    _lib.load()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    parent = finish_parent() if finish_parent else None
    dev = resolve_device("cuda")
    cfg = ModelConfig()
    dataset = SyntheticInterpolationDataset(length=3, num_points=cfg.npoints, seed=0)
    rows = check_kernels(kernels, cfg, dataset, dev, parent)
    check_train_kernels(kernels, cfg, dev, rows, parent)
    check_op_kernels(kernels, cfg, dev, rows)
    check_stress_kernels(kernels, dev, rows, parent)
    torch.cuda.empty_cache()
    model = MoCoPCI(cfg, device=dev, seed=0)
    cpu_model = MoCoPCI(cfg, device="cpu", seed=0)
    paths, stats = {}, {}
    for mode in ("approx", "exact"):
        paths[f"slice_{mode}"], stats[f"slice_{mode}"] = run_slice(
            kernels, cfg, dataset, dev, model, cpu_model, mode)
    paths["eval"], stats["eval"] = run_eval(kernels, cfg, dataset, dev, model, cpu_model)
    del model, cpu_model
    torch.cuda.empty_cache()
    p0 = dataset[0][0][1][0]        # the eval pair's first point, as bench.py's x1[:1, :1]
    for n in STRESS_SIZES:
        stress_paths, stats[f"stress_{n}"] = run_stress(kernels, n, dev, p0)
        paths.update(stress_paths)
    paths["train"], stats["train"] = run_train(kernels, cfg, dev)
    for n in STRESS_SIZES:
        paths[f"stress_train_{n}"], stats[f"stress_train_{n}"] = run_stress_train(kernels, n,
                                                                                  dev)
    stats["train_parity"] = run_train_parity(kernels, dev)
    paths["train_refine_k8"], stats["train_refine_k8"] = run_train_refine_k(kernels, dev)
    stats["train_cli"] = run_train_cli(kernels)
    for name, path in (("train_remat", lambda: run_train_remat(kernels, dev)),
                       ("stress_train_32768_remat", lambda: run_stress_train(
                           kernels, 32768, dev, remat=True, n_steps=3)),
                       ("train_dp1", lambda: run_train_dp1(kernels, dev)),
                       ("train_cli_dp", lambda: run_train_cli_dp(kernels))):
        t0 = time.perf_counter()
        paths[name], stats[name] = path()
        stats[name]["seconds"] = time.perf_counter() - t0
        log(f"{name}: {stats[name]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    paths["ops"], stats["ops"] = run_ops(kernels, cfg, dev)
    # each kernel's launches on the path it belongs to: the default forward,
    # the exact-mode forward for knn_exact, eval_step for chamfer_pair, the
    # train steps for the train kernels, the op paths for the op kernels
    home = {"knn_exact": ("slice_exact", "knn"), "chamfer_pair": ("eval", "chamfer_pair"),
            "transformer_tail_general": ("train_refine_k8", "transformer_tail_general"),
            "transformer_tail_bwd_general": ("train_refine_k8", "transformer_tail_bwd_general"),
            "fps_cluster": ("stress_32768", "fps_cluster"),
            "fps_pyramid_cluster": ("stress_32768", "fps_pyramid_cluster"),
            "cross_tail_wide": ("stress_32768", "cross_tail_wide"),
            "cross_tail_bwd_wide": ("stress_train_32768", "cross_tail_bwd_wide")}
    home.update({name: ("ops", name) for name in OPS_KERNELS if name != "chamfer_pair"})
    home.update({name: ("train", name) for name in TRAIN_KERNELS
                 if name.endswith(("_bwd", "_fwd", "_wide")) or name in ("scatter_add",
                                                                  "fusion_pair_planes")})
    for r in rows:
        path, counter = home.get(r["name"], ("slice_approx", r["name"]))
        r["launches"], r["path"] = paths[path][counter], path
    never = [r["name"] for r in rows if r["launches"] == 0]
    if never or len(rows) != len(_lib.LAUNCHES):
        raise SystemExit(f"kernels not launched on their path: {never}")
    log(json.dumps({"paths": paths}))
    log(json.dumps(stats))
    log(f"total: {time.perf_counter() - T0:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
