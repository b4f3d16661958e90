#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MoCoPCI on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each fatal on failure:
  1. probe: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build every kernel from ``mocopci_torch/csrc`` (one nvcc per source);
  3. each kernel against its plain PyTorch twin on the card, at the shapes of
     the main path, with median times (CUDA events) and the least time the
     card could take (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
     whichever is larger; H100 SXM data sheet);
  4. the forward, once per kNN mode (approx, the default, then exact):
     ``interpolate`` at the production ``ModelConfig()`` on 3 synthetic frame
     pairs, the launch counts read, the Chamfer distance to the same model
     run with ``device="cpu"`` (the plain twins), the median forward time and
     peak memory; one profiled forward in approx mode (device time per
     kernel, the device's busy share);
  5. the eval path: ``eval_step`` (forward, CD, EMD) on one sample, its
     metrics against the CPU's, the times of its parts, then the eval CLI
     ``python -m mocopci_torch.cli.test --synthetic 3`` in-process;
  6. the summary lines: the card, the per-kernel JSON line, the contract line.
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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and f32 ops / peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def frames(dataset, index, dev):
    inputs, _ = dataset[index]
    return [torch.from_numpy(f).to(dev) for f in inputs]


def check_kernels(kernels, cfg, dataset, dev):
    """Every kernel against its twin at the main path's shapes for ``cfg``;
    returns the per-kernel JSON rows (launch counts filled in later)."""
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
        ms, plain_ms = median_ms(launch), median_ms(plain)
        lib_ms = median_ms(library) if library is not None else None
        b_ms, b_by = bound(nbytes, flops)
        ok = err <= tol
        log(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:.1e}) ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} library_ms {lib_ms} bound_ms {b_ms:.5f} ({b_by})")
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        rows.append({"name": name, "route": "cuda", "source": module.SOURCE,
                     "replaces": module.REPLACES, "launches": None, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})

    # fps: the encoder's level 0, both clouds, n0 -> n1
    xyz = torch.stack([f[1], f[2]]).contiguous()
    got, want = kernels.fps(xyz, n1), kernels.fps_plain(xyz, n1)
    mism = int((got != want).sum())
    log(f"fps {tuple(xyz.shape)} -> {n1}: index mismatches {mism}")
    row("fps", mods["fps"], lambda: kernels.fps(xyz, n1), lambda: kernels.fps_plain(xyz, n1),
        None, xyz.numel() * F32 + 2 * n1 * I32, 9.0 * 2 * (n1 - 1) * n0, float(mism), 0.0)

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
    row("knn_exact", mods["knn"],
        lambda: kernels.knn_exact(p1, p2, k, "euclidean"),
        lambda: kernels.knn_plain(p1, p2, k, "euclidean"),
        lambda: torch.topk(torch.cdist(p1, p2), k, dim=-1, largest=False),
        2 * p1.numel() * F32 + p1.shape[0] * n0 * k * I32,
        8.0 * p1.shape[0] * n0 * n0, gap, 1e-6)

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

    # attention: Multi_Frame_Att at L1, (B*F*H, N, hd) = (5*8, n1, c1/8); then
    # EI at L2 / L3 and Cross_Frame_Att (head width c3) for the other widths
    for G, N, D in ((8, n2, c2 // 8), (8, n3, c3 // 8), (8, n3, c3)):
        q, kk, v = rnd(G, N, D), rnd(G, N, D), rnd(G, N, D)
        e = float((kernels.attention(q, kk, v, D ** -0.5)
                   - kernels.attention_plain(q, kk, v, D ** -0.5)).abs().max())
        log(f"attention ({G}, {N}, {D}): max_abs_err {e:.3e}")
        if e > 1e-5:
            raise SystemExit("attention disagrees with its plain version")
    G, D = 5 * 8, c1 // 8
    q, kk, v = rnd(G, n1, D), rnd(G, n1, D), rnd(G, n1, D)
    s = D ** -0.5
    err = float((kernels.attention(q, kk, v, s)
                 - kernels.attention_plain(q, kk, v, s)).abs().max())
    row("attention", mods["attention"],
        lambda: kernels.attention(q, kk, v, s), lambda: kernels.attention_plain(q, kk, v, s),
        lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, v, scale=s),
        4 * q.numel() * F32, G * n1 * n1 * (4 * D + 3), err, 1e-5)

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

    # transformer_tail: the refine head, 3 frames x refine_npoint queries
    G, M, N, K, D = 3, cfg.refine_npoint, cfg.refine_npoint, cfg.refine_k, c1
    table, xq, qq = rnd(G, M, 3 + 2 * D), rnd(G, N, 3), rnd(G, N, D)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
    idx = torch.randint(0, M, (G, N, K), generator=gen, device=dev, dtype=torch.int32)
    out = kernels.transformer_tail_plain(table, idx, xq, qq, *ws)
    err = float((kernels.transformer_tail(table, idx, xq, qq, *ws) - out).abs().max())
    row("transformer_tail", mods["transformer_tail"],
        lambda: kernels.transformer_tail(table, idx, xq, qq, *ws),
        lambda: kernels.transformer_tail_plain(table, idx, xq, qq, *ws), None,
        (table.numel() + xq.numel() + qq.numel() + sum(t.numel() for t in ws)
         + out.numel()) * F32 + idx.numel() * I32,
        G * N * K * (6 * D * D + 20 * D + 3), err, 1e-4 * (1 + float(out.abs().max())))

    # fusion_pair: 3 frames x n0 queries x 2k neighbours (the fusion kNN above)
    G, N, K2 = 3, n0, 2 * k
    pts1, pts2 = p1[:3], p2[3:]
    idx = torch.cat(torch.chunk(got, 2), dim=-1).contiguous()
    ws = []
    for ci, co in [(4, c1), (c1, c1), (c1, c2)]:
        ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
    planes, logits = kernels.fusion_pair_plain(pts2, idx, pts1, *ws)
    kp, kl = kernels.fusion_pair(pts2, idx, pts1, *ws)
    err = max(float((kp - planes).abs().max()), float((kl - logits).abs().max()))
    P = N * K2
    row("fusion_pair", mods["fusion_pair"],
        lambda: kernels.fusion_pair(pts2, idx, pts1, *ws),
        lambda: kernels.fusion_pair_plain(pts2, idx, pts1, *ws), None,
        (pts1.numel() + pts2.numel() + sum(t.numel() for t in ws) + G * 5 * P) * F32
        + idx.numel() * I32,
        G * P * (2 * (4 * c1 + c1 * c1 + c1 * c2) + 2 * (c1 + c1 + c2) + 9),
        err, 1e-4 * (1 + float(logits.abs().max())))

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
    return rows


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
    "approx": ("fps", "knn_approx", "attention", "cross_tail", "transformer_tail",
               "fusion_pair"),
    "exact": ("fps", "knn", "attention", "cross_tail", "transformer_tail", "fusion_pair"),
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
    busy = profile_forward(model, *pairs[0]) if mode == "approx" else {}
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


# device-kernel name fragment -> port kernel, for the profile breakdown
KERNEL_SYMBOLS = {"fps_kernel": "fps", "knn_xyz_kernel": "knn_exact",
                  "knn_dot_kernel": "knn_exact", "knn_approx_xyz_kernel": "knn_approx",
                  "knn_approx_dot_kernel": "knn_approx", "chamfer_pair_kernel": "chamfer_pair",
                  "attention_kernel": "attention",
                  "cross_tail_kernel": "cross_tail",
                  "transformer_tail_kernel": "transformer_tail",
                  "fusion_pair_kernel": "fusion_pair"}


def profile_forward(model, x1, x2) -> dict:
    """One forward under torch.profiler: device time per port kernel, the rest
    (PyTorch's own kernels) by name, and the device's busy share of the
    profiled wall time (the profiler's own overhead inflates the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mocopci_torch import interpolate

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        interpolate(model, x1, x2)
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
        log("profile: the profiler recorded no device time; breakdown not measured")
        return {"profile": "not measured"}
    log(f"profile: device busy {device_ms:.3f} ms of {wall_ms:.3f} ms profiled wall "
        f"({100 * device_ms / wall_ms:.1f}%)")
    log("profile: port kernels ms " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])}))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    log("profile: top other kernels ms " + json.dumps({k: round(v, 4) for k, v in top}))
    return {"profile_device_ms": device_ms, "profile_wall_ms": wall_ms,
            "profile_port_kernels_ms": sum(per_kernel.values())}


def main() -> int:
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
    _lib.load()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    dev = resolve_device("cuda")
    cfg = ModelConfig()
    dataset = SyntheticInterpolationDataset(length=3, num_points=cfg.npoints, seed=0)
    rows = check_kernels(kernels, cfg, dataset, dev)
    model = MoCoPCI(cfg, device=dev, seed=0)
    cpu_model = MoCoPCI(cfg, device="cpu", seed=0)
    paths, stats = {}, {}
    for mode in ("approx", "exact"):
        paths[f"slice_{mode}"], stats[f"slice_{mode}"] = run_slice(
            kernels, cfg, dataset, dev, model, cpu_model, mode)
    paths["eval"], stats["eval"] = run_eval(kernels, cfg, dataset, dev, model, cpu_model)
    # each kernel's launches on the path it belongs to: the default forward,
    # the exact-mode forward for knn_exact, eval_step for chamfer_pair
    home = {"knn_exact": ("slice_exact", "knn"), "chamfer_pair": ("eval", "chamfer_pair")}
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
