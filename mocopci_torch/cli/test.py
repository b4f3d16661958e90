"""Evaluation entry point of the port, flag-compatible with
``mocopci_tpu/cli/test.py`` (itself the reference ``test.py:16-35``).

    python -m mocopci_torch.cli.test --synthetic 3                  # on the card
    python -m mocopci_torch.cli.test --synthetic 2 --tiny --npoints 128 --device cpu

One forward per sample producing all 3 frames, per-frame and average CD/EMD
means over the split, and a final JSON line with the JAX CLI's keys.
``--device cpu`` runs every kernel's plain version; without a card the
default ``--device cuda`` raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

UNSUPPORTED = ("is not ported yet: see ROADMAP.md, section 1 (modules and options "
               "still to port)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test")
    p.add_argument("--data_root", type=str, default="", help="Dataset path.")
    p.add_argument("--scene_list", type=str, default="")
    p.add_argument("--interval", type=int, default=4)
    p.add_argument("--npoints", type=int, default=8192)
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--t_begin", type=float, default=0.0)
    p.add_argument("--t_end", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--pretrain_model", type=str, default="",
                   help="a torch state_dict file saved from MoCoPCI.state_dict()")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--no_emd", action="store_true", help="CD-only eval")
    p.add_argument("--knn_mode", type=str, default="approx", choices=["approx", "exact"],
                   help="neighbour selection (see mocopci_torch.ops.set_knn_mode)")
    p.add_argument("--knn_recall", type=float, default=0.95,
                   help="accepted for compatibility; changes nothing here, as it "
                        "changes nothing on the JAX package's TPU path")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="activation dtype; only float32 is ported")
    p.add_argument("--emd_fast", action="store_true", help="fast-exp EMD; not ported")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.emd_fast:
        raise SystemExit(f"--emd_fast {UNSUPPORTED}")
    if args.compute_dtype != "float32":
        raise SystemExit(f"--compute_dtype {args.compute_dtype} {UNSUPPORTED}")

    from mocopci_torch import MoCoPCI, ModelConfig, ops, timestamps, tiny_model_config
    from mocopci_torch.data import NLDriveDataset, SyntheticInterpolationDataset, batches
    from mocopci_torch.device import resolve_device
    from mocopci_torch.training import eval_step

    dev = resolve_device(args.device)
    ops.set_knn_mode(args.knn_mode)
    t_f, t_b = timestamps(args.t_begin, args.t_end, args.interval, args.num_frames)
    model_cfg = tiny_model_config(args.npoints) if args.tiny else ModelConfig(
        npoints=args.npoints)
    model_cfg = dataclasses.replace(model_cfg, t_forward=t_f, t_backward=t_b)

    if args.synthetic:
        dataset = SyntheticInterpolationDataset(
            length=args.synthetic, num_points=args.npoints, seed=1)
    else:
        if not (args.data_root and args.scene_list):
            raise SystemExit("provide --data_root and --scene_list, or --synthetic N")
        dataset = NLDriveDataset(args.data_root, args.scene_list, args.npoints,
                                 args.interval, args.num_frames)

    model = MoCoPCI(model_cfg, device=dev)
    if args.pretrain_model:
        state = torch.load(args.pretrain_model, map_location=dev, weights_only=True)
        model.load_state_dict(state, strict=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with_emd = not args.no_emd
    # per-frame sums stay on the device across the split; one transfer at the end
    F = 3
    compile_s = 0.0
    steady_samples = 0
    total_samples = 0
    sums = None
    first_batch = None
    first_real = 0
    t1 = time.perf_counter()
    for i, batch in enumerate(batches(dataset, args.batch_size, shuffle=False,
                                      drop_last=False)):
        real = batch["pc1"].shape[0]
        if real < args.batch_size:
            # pad the ragged tail batch to the batch size; padded rows are
            # excluded from the metric sums below
            pad = args.batch_size - real
            batch = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
                     for k, v in batch.items()}
        m = eval_step(model, batch, with_emd)
        part = {k: v[:real].sum() for k, v in m.items()}
        sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
        total_samples += real
        if i == 0:
            sync()               # the first batch includes the kernels' build
            compile_s = time.perf_counter() - t1
            first_batch = batch
            first_real = real
            t1 = time.perf_counter()
        else:
            steady_samples += real
    sums = {k: float(v) for k, v in (sums or {}).items()}
    steady_s = time.perf_counter() - t1
    if steady_samples == 0 and first_batch is not None:
        # single-batch split: time it again, built
        t1 = time.perf_counter()
        eval_step(model, first_batch, with_emd)
        sync()
        steady_s = time.perf_counter() - t1
        steady_samples = first_real
    per_sample_ms = 1e3 * steady_s / max(steady_samples, 1)
    # device_ms: 10 back-to-back calls, one terminal sync (host dispatch
    # overlaps the device); synced_ms: a sync after every call
    device_ms = 0.0
    synced_ms = 0.0
    if first_batch is not None:
        reps = 10
        t1 = time.perf_counter()
        for _ in range(reps):
            eval_step(model, first_batch, with_emd)
        sync()
        device_ms = 1e3 * (time.perf_counter() - t1) / (reps * first_real)
        reps = 3
        t1 = time.perf_counter()
        for _ in range(reps):
            eval_step(model, first_batch, with_emd)
            sync()
        synced_ms = 1e3 * (time.perf_counter() - t1) / (reps * first_real)
    print(f"inference+metrics: {per_sample_ms:.2f} ms/sample wall "
          f"(steady state over {steady_samples} samples; compile "
          f"{compile_s:.1f}s excluded; device est {device_ms:.2f} "
          f"ms/sample; synced incl. round-trip {synced_ms:.2f} ms/sample)")
    n = max(total_samples, 1)
    result = {}
    for j in range(F):
        result[f"cd_frame{j + 1}"] = sums[f"cd_{j}"] / n
        print(f"Frame{j + 1}: Mean chamfer distance: ", result[f"cd_frame{j + 1}"])
        if with_emd:
            result[f"emd_frame{j + 1}"] = sums[f"emd_{j}"] / n
            print(f"Frame{j + 1}: Mean earth mover's distance: ", result[f"emd_frame{j + 1}"])
    print("-------------------------------------------")
    result["cd_mean"] = float(np.mean([result[f"cd_frame{j + 1}"] for j in range(F)]))
    print("Average: Mean chamfer distance: ", result["cd_mean"])
    if with_emd:
        result["emd_mean"] = float(np.mean([result[f"emd_frame{j + 1}"] for j in range(F)]))
        print("Average: Mean earth mover's distance: ", result["emd_mean"])
    result["wall_s"] = steady_s
    result["compile_s"] = compile_s
    result["per_sample_ms"] = per_sample_ms
    result["device_ms_per_sample"] = device_ms
    result["synced_roundtrip_ms_per_sample"] = synced_ms
    result["n_samples"] = total_samples
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
