"""One rank of the port's data-parallel tests (``tests/test_torch_dp.py``).

    python -m tests.torch_dp_worker SPEC RANK

``SPEC`` is a ``torch.save``'d dict that the test wrote: the world size, the
``MASTER_PORT`` of each process group, and either ``runs`` (each one
``dp_train_step`` of ``tiny_model_config`` on this rank's rows of a global
batch) or ``cli`` (argument lists of ``mocopci_torch.cli.train.main``, one
process group each).  The rank joins over ``env://`` with gloo, on one thread,
and writes what it saw to ``<out>.<rank>.pt``.  It imports nothing of JAX.
"""
import dataclasses
import os
import sys

import torch


def _join(port: int, rank: int, world: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))


def _one_step(run: dict, rank: int) -> dict:
    """``dp_train_step`` on this rank's rows, with what it passed to the
    all-reduce (the local loss components) and what came back (the mean
    gradients before the clip)."""
    from mocopci_torch import tiny_model_config
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.parallel import host_batch_slice, rank_generator
    from mocopci_torch.training import create_train_state, loop

    cfg = dataclasses.replace(tiny_model_config(run["npoints"]), **run["model"])
    tcfg = TrainConfig(**run["train"])
    model, state = create_train_state(cfg, tcfg, steps_per_epoch=1, device="cpu")
    if run.get("weights") is not None:
        model.load_state_dict(run["weights"], strict=True)
    rows = host_batch_slice(len(run["batch"]["pc1"]), run["n_data"], rank)
    batch = {k: v[rows].numpy() for k, v in run["batch"].items()}
    rng = rank_generator(tcfg.seed, rank, "cpu") if run["dropout"] else None
    seen = {}
    loss_and_grads, apply_update = loop.loss_and_grads, loop.apply_update

    def local(*a, **k):
        aux = loss_and_grads(*a, **k)
        seen["local"] = {n: float(v) for n, v in aux.items()}
        return aux

    def update(st):
        seen["grads"] = {n: p.grad.clone() for n, p in st.model.named_parameters()}
        return apply_update(st)

    loop.loss_and_grads, loop.apply_update = local, update
    try:
        _, aux = loop.dp_train_step(state, batch, rng, run["n_data"])
    finally:
        loop.loss_and_grads, loop.apply_update = loss_and_grads, apply_update
    return {"aux": {n: float(v) for n, v in aux.items()}, "local": seen.get("local"),
            "grads": seen["grads"],
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "rows": (rows.start, rows.stop)}


def main(spec_path: str, rank: int) -> None:
    spec = torch.load(spec_path, weights_only=True)
    torch.set_num_threads(1)
    from mocopci_torch import ops
    from mocopci_torch.parallel import init_distributed, shutdown_distributed

    ops.set_knn_mode("exact")
    world, out = spec["world"], {}
    if "cli" in spec:
        from mocopci_torch.cli import train as cli_train

        out["cli"] = []
        for port, argv in zip(spec["ports"], spec["cli"]):
            _join(port, rank, world)
            out["cli"].append(cli_train.main(argv))   # starts and ends its own group
    else:
        _join(spec["ports"][0], rank, world)
        if not init_distributed(torch.device("cpu")):
            raise SystemExit("no process group started")
        try:
            out["runs"] = {run["name"]: _one_step(run, rank) for run in spec["runs"]}
        finally:
            shutdown_distributed()
    torch.save(out, f"{spec['out']}.{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
