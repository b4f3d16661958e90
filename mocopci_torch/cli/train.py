"""Training entry point of the port, flag-compatible with
``mocopci_tpu/cli/train.py`` (itself the reference ``train.py:18-37``).

    python -m mocopci_torch.cli.train --synthetic 4 --epochs 1          # on the card
    python -m mocopci_torch.cli.train --synthetic 4 --tiny --npoints 64 --device cpu
    torchrun --nproc_per_node 8 -m mocopci_torch.cli.train --synthetic 64 --epochs 1

Best-by-``loss_f`` checkpoints under ``<save_dir>/ckpt`` (the port's own
format, ``training/checkpoint.py``), ``--resume`` from the latest, and a save
at the end of the epoch in which SIGTERM or SIGINT arrived.  ``--device cpu``
runs every kernel's plain version; without a card the default ``--device
cuda`` raises.  ``--remat`` recomputes the decoder stages in the backward.

Under ``torchrun`` (one process a card; NCCL, or gloo with ``--device cpu``)
the step is data-parallel: ``--dp_impl auto`` takes JAX's shard_map step
(``training.loop.dp_train_step``) above one rank, ``shard_map`` always;
``--batch_policy per_device`` makes ``--batch_size`` a rank's rows.  Each
rank loads only its rows of a batch; ``--multihost`` (the same launch across
hosts) only checks that torchrun's environment is there.  Rank 0 prints,
writes the CSV and the checkpoints.  ``--dp_impl spmd`` above one rank, bf16
and the profiling flags are refused with a pointer to ``ROADMAP.md``.
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
    p.add_argument("--remat", action="store_true",
                   help="recompute the decoder stages' activations in the backward "
                        "(torch.utils.checkpoint): less peak memory, more step time")
    p.add_argument("--multihost", action="store_true",
                   help="accepted for compatibility (torchrun across hosts): checks "
                        "torchrun's environment; every rank loads only its rows anyway")
    p.add_argument("--dp_impl", type=str, default="auto", choices=["auto", "shard_map", "spmd"],
                   help="'shard_map': the one-device step on each rank's rows, then the "
                        "mean of gradients, losses and running statistics; 'auto': "
                        "shard_map above one rank; 'spmd': the plain step, one rank only")
    p.add_argument("--batch_policy", type=str, default="global",
                   choices=["global", "per_device"],
                   help="'global': --batch_size is the global batch (gcd(batch, ranks) "
                        "ranks hold rows); 'per_device': --batch_size is each rank's, the "
                        "global batch scales with the ranks (the rate is not rescaled)")
    # the JAX CLI's flags for features the port does not have yet
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--tensorboard", type=str, default="")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    refused = {
        "--compute_dtype bfloat16": args.compute_dtype != "float32",
        "--profile_dir": bool(args.profile_dir),
        "--tensorboard": bool(args.tensorboard),
    }
    for flag, given in refused.items():
        if given:
            raise SystemExit(f"{flag} {UNSUPPORTED}")


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)

    from mocopci_torch.device import resolve_device
    from mocopci_torch.parallel import init_distributed, shutdown_distributed

    dev = resolve_device(args.device)
    if args.multihost and "WORLD_SIZE" not in os.environ:
        raise SystemExit("--multihost needs the environment torchrun sets (MASTER_ADDR, "
                         "MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK)")
    started = init_distributed(dev)
    try:
        return _train(args, dev)
    finally:
        if started:
            shutdown_distributed()


def _train(args, dev):
    import torch
    import torch.distributed as dist

    from mocopci_torch import ModelConfig, ops, timestamps, tiny_model_config
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.data import NLDriveDataset, SyntheticInterpolationDataset, batches
    from mocopci_torch.parallel import (
        host_batch_slice,
        make_mesh_for_batch,
        rank_generator,
        scale_batch_to_mesh,
        world,
    )
    from mocopci_torch.training import CheckpointManager, create_train_state, dp_train_step

    rank, world_size = world()
    if world_size > 1 and args.dp_impl == "spmd":
        raise SystemExit(
            f"--dp_impl spmd over {world_size} ranks {UNSUPPORTED}: it is the JAX "
            "package's jit partitioned by XLA, which PyTorch has no counterpart of; "
            "--dp_impl shard_map (or auto) is the data-parallel step")
    if dev.type == "cuda" and world_size > 1:
        dev = torch.device("cuda", torch.cuda.current_device())

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    ops.set_knn_mode(args.knn_mode)
    t_f, t_b = timestamps(args.t_begin, args.t_end, args.interval, args.num_frames)
    model_cfg = tiny_model_config(args.npoints) if args.tiny else ModelConfig(
        npoints=args.npoints)
    model_cfg = dataclasses.replace(model_cfg, t_forward=t_f, t_backward=t_b,
                                    remat=args.remat)
    if args.batch_policy == "per_device":
        global_batch, n_data = scale_batch_to_mesh(args.batch_size, world_size)
        say(f"batch policy per_device: global batch {global_batch} ({args.batch_size}/device "
            f"x {n_data} data shards); LR is NOT auto-scaled (--lr to adjust)")
    else:
        global_batch = args.batch_size
        n_data = make_mesh_for_batch(global_batch, world_size)
    grad_accum = max(args.grad_accum, 1)
    if global_batch % grad_accum:
        raise SystemExit(f"--batch_size {global_batch} must be divisible by "
                         f"--grad_accum {args.grad_accum}")
    train_cfg = TrainConfig(batch_size=global_batch, epochs=args.epochs, lr=args.lr,
                            weight_decay=args.weight_decay, seed=args.seed,
                            grad_accum=grad_accum)
    if args.dp_impl == "shard_map" or world_size > 1:
        per_shard = global_batch // n_data
        if per_shard % grad_accum:
            raise SystemExit(f"under --dp_impl shard_map the PER-SHARD batch ({global_batch}/"
                             f"{n_data} = {per_shard}) must be divisible by --grad_accum "
                             f"{grad_accum}")
        say(f"dp_impl: shard_map over {n_data} data shard(s)")
    rows = host_batch_slice(global_batch, n_data, rank)

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
    say(f"the number of network parameters: {sum(p.numel() for p in model.parameters())}")

    ckpt = CheckpointManager(os.path.join(args.save_dir, "ckpt"))
    start_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        state, saved_spe = ckpt.restore(state)
        start_epoch = ckpt.latest_epoch() + 1
        say(f"resumed from epoch {start_epoch - 1}")
        if saved_spe and saved_spe != steps_per_epoch:
            # the schedule derives the epoch from the step: keep the cadence it
            # was built on, or a changed dataset size would move the decay
            say(f"warning: steps_per_epoch changed {saved_spe} -> {steps_per_epoch}; "
                "keeping the LR schedule on the original cadence")
            state.steps_per_epoch = saved_spe

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        stop_requested["flag"] = True
        print(f"signal {signum} received: will checkpoint and stop after this epoch")

    def stop_everywhere() -> bool:
        # a signal may reach some ranks only: all stop, or none
        if not dist.is_initialized():
            return stop_requested["flag"]
        flag = torch.tensor([float(stop_requested["flag"])], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _request_stop)
        except ValueError:   # not the main thread
            pass

    rng = rank_generator(train_cfg.seed, rank, dev)
    best_loss_f = float("inf")
    history = []
    try:
        for epoch in range(start_epoch, train_cfg.epochs):
            t0 = time.time()
            sums, count = {}, 0
            for batch in batches(dataset, train_cfg.batch_size, shuffle=True, seed=epoch,
                                 host_slice=rows):
                state, aux = dp_train_step(state, batch, rng, n_data)
                aux = {k: float(v) for k, v in aux.items()}
                count += 1
                if count % args.log_every == 0:
                    say(f"Train Epoch:{epoch + 1}[{count}/{steps_per_epoch}]"
                        + "".join(f"\t{k}: {v:.6f}" for k, v in sorted(aux.items())))
                for k, v in aux.items():
                    sums[k] = sums.get(k, 0.0) + v
            means = {k: v / max(count, 1) for k, v in sums.items()}
            dt = time.time() - t0
            say(f"Epoch {epoch + 1} finished", json.dumps({**means, "epoch_time_s": dt}))
            history.append({"epoch": epoch, **means, "epoch_time_s": dt})
            if args.metrics_csv and rank == 0:
                header = not os.path.exists(args.metrics_csv)
                with open(args.metrics_csv, "a") as f:
                    if header:
                        f.write("epoch," + ",".join(sorted(means)) + "\n")
                    f.write(f"{epoch}," + ",".join(f"{means[k]:.6f}" for k in sorted(means))
                            + "\n")
            # the means are the ranks' means, so every rank decides alike
            if means.get("loss_f", float("inf")) < best_loss_f:
                best_loss_f = means["loss_f"]
                ckpt.save(epoch, state, metrics=means, steps_per_epoch=state.steps_per_epoch)
                say(f"Best train loss: {best_loss_f:.4f} (checkpoint saved)")
            if stop_everywhere():
                if ckpt.latest_epoch() != epoch:
                    ckpt.save(epoch, state, metrics=means,
                              steps_per_epoch=state.steps_per_epoch)
                say(f"stopped by signal after epoch {epoch + 1} (checkpoint saved)")
                break
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return {"start_epoch": start_epoch, "step": state.step, "epochs": history}


if __name__ == "__main__":
    main()
