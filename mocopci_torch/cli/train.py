"""Training entry point of the port, single device, flag-compatible with
``mocopci_tpu/cli/train.py`` (itself the reference ``train.py:18-37``).

    python -m mocopci_torch.cli.train --synthetic 4 --epochs 1          # on the card
    python -m mocopci_torch.cli.train --synthetic 4 --tiny --npoints 64 --device cpu

Best-by-``loss_f`` checkpoints under ``<save_dir>/ckpt`` (the port's own
format, ``training/checkpoint.py``), ``--resume`` from the latest, and a save
at the end of the epoch in which SIGTERM or SIGINT arrived.  ``--device cpu``
runs every kernel's plain version; without a card the default ``--device
cuda`` raises.  The flags of the JAX CLI's multi-device, rematerialisation,
bf16 and profiling features are refused with a pointer to ``ROADMAP.md``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time

UNSUPPORTED = ("is not ported yet: see ROADMAP.md, section 1 (modules and options "
               "still to port)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MoCoPCI (PyTorch port)")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--lr", type=float, default=0.001, help="Learning rate.")
    p.add_argument("--weight_decay", type=float, default=0.0001, help="Weight decay.")
    p.add_argument("--resume", action="store_true", help="continue from the latest checkpoint")
    p.add_argument("--save_dir", type=str, default="outputs")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--scene_list", type=str, default="")
    p.add_argument("--interval", type=int, default=4)
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--npoints", type=int, default=8192)
    p.add_argument("--t_begin", type=float, default=0.0)
    p.add_argument("--t_end", type=float, default=1.0)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples instead of NL-Drive")
    p.add_argument("--tiny", action="store_true", help="tiny model config (tests)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-epoch metrics to this CSV")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into K sequential micro-batches with "
                        "mean-combined gradients")
    p.add_argument("--knn_mode", type=str, default="approx", choices=["approx", "exact"])
    p.add_argument("--knn_recall", type=float, default=0.95,
                   help="accepted for compatibility; changes nothing here")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    # the JAX CLI's flags for features the port does not have yet
    p.add_argument("--remat", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--dp_impl", type=str, default="auto", choices=["auto", "shard_map", "spmd"])
    p.add_argument("--batch_policy", type=str, default="global",
                   choices=["global", "per_device"])
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--tensorboard", type=str, default="")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    refused = {
        "--remat": args.remat,
        "--compute_dtype bfloat16": args.compute_dtype != "float32",
        "--multihost": args.multihost,
        f"--dp_impl {args.dp_impl}": args.dp_impl != "auto",
        f"--batch_policy {args.batch_policy}": args.batch_policy != "global",
        "--profile_dir": bool(args.profile_dir),
        "--tensorboard": bool(args.tensorboard),
    }
    for flag, given in refused.items():
        if given:
            raise SystemExit(f"{flag} {UNSUPPORTED}")


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)

    import torch

    from mocopci_torch import ModelConfig, ops, timestamps, tiny_model_config
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import NLDriveDataset, SyntheticInterpolationDataset, batches
    from mocopci_torch.device import resolve_device
    from mocopci_torch.training import CheckpointManager, create_train_state, train_step

    dev = resolve_device(args.device)
    ops.set_knn_mode(args.knn_mode)
    t_f, t_b = timestamps(args.t_begin, args.t_end, args.interval, args.num_frames)
    model_cfg = tiny_model_config(args.npoints) if args.tiny else ModelConfig(
        npoints=args.npoints)
    model_cfg = dataclasses.replace(model_cfg, t_forward=t_f, t_backward=t_b)
    if args.batch_size % max(args.grad_accum, 1):
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by "
                         f"--grad_accum {args.grad_accum}")
    train_cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                            weight_decay=args.weight_decay, seed=args.seed,
                            grad_accum=max(args.grad_accum, 1))

    if args.synthetic:
        dataset = SyntheticInterpolationDataset(length=args.synthetic,
                                                num_points=args.npoints, seed=args.seed)
    else:
        if not (args.data_root and args.scene_list):
            raise SystemExit("provide --data_root and --scene_list, or --synthetic N")
        scene_list = args.scene_list
        if not scene_list.endswith(".txt"):
            scene_list = scene_list + "_list.txt"   # the reference's convention
        dataset = NLDriveDataset(args.data_root, scene_list, args.npoints, args.interval,
                                 args.num_frames)

    steps_per_epoch = max(len(dataset) // train_cfg.batch_size, 1)
    model, state = create_train_state(model_cfg, train_cfg, steps_per_epoch, device=dev)
    print(f"the number of network parameters: {sum(p.numel() for p in model.parameters())}")

    ckpt = CheckpointManager(os.path.join(args.save_dir, "ckpt"))
    start_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        state, saved_spe = ckpt.restore(state)
        start_epoch = ckpt.latest_epoch() + 1
        print(f"resumed from epoch {start_epoch - 1}")
        if saved_spe and saved_spe != steps_per_epoch:
            # the schedule derives the epoch from the step: keep the cadence it
            # was built on, or a changed dataset size would move the decay
            print(f"warning: steps_per_epoch changed {saved_spe} -> {steps_per_epoch}; "
                  "keeping the LR schedule on the original cadence")
            state.steps_per_epoch = saved_spe

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        stop_requested["flag"] = True
        print(f"signal {signum} received: will checkpoint and stop after this epoch")

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _request_stop)
        except ValueError:   # not the main thread
            pass

    rng = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    best_loss_f = float("inf")
    history = []
    try:
        for epoch in range(start_epoch, train_cfg.epochs):
            t0 = time.time()
            sums, count = {}, 0
            for batch in batches(dataset, train_cfg.batch_size, shuffle=True, seed=epoch):
                state, aux = train_step(state, batch, rng)
                aux = {k: float(v) for k, v in aux.items()}
                count += 1
                if count % args.log_every == 0:
                    print(f"Train Epoch:{epoch + 1}[{count}/{steps_per_epoch}]"
                          + "".join(f"\t{k}: {v:.6f}" for k, v in sorted(aux.items())))
                for k, v in aux.items():
                    sums[k] = sums.get(k, 0.0) + v
            means = {k: v / max(count, 1) for k, v in sums.items()}
            dt = time.time() - t0
            print(f"Epoch {epoch + 1} finished", json.dumps({**means, "epoch_time_s": dt}))
            history.append({"epoch": epoch, **means, "epoch_time_s": dt})
            if args.metrics_csv:
                header = not os.path.exists(args.metrics_csv)
                with open(args.metrics_csv, "a") as f:
                    if header:
                        f.write("epoch," + ",".join(sorted(means)) + "\n")
                    f.write(f"{epoch}," + ",".join(f"{means[k]:.6f}" for k in sorted(means))
                            + "\n")
            if means.get("loss_f", float("inf")) < best_loss_f:
                best_loss_f = means["loss_f"]
                ckpt.save(epoch, state, metrics=means, steps_per_epoch=state.steps_per_epoch)
                print(f"Best train loss: {best_loss_f:.4f} (checkpoint saved)")
            if stop_requested["flag"]:
                if ckpt.latest_epoch() != epoch:
                    ckpt.save(epoch, state, metrics=means,
                              steps_per_epoch=state.steps_per_epoch)
                print(f"stopped by signal after epoch {epoch + 1} (checkpoint saved)")
                break
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return {"start_epoch": start_epoch, "step": state.step, "epochs": history}


if __name__ == "__main__":
    main()
