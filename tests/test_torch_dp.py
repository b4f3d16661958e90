"""The port's data-parallel train step (``training.loop.dp_train_step``, JAX's
shard_map step over ``torch.distributed``) on the CPU with gloo.

Each 2-rank run is two processes of ``tests/torch_dp_worker.py`` (no JAX
there), one thread each, joined over ``env://`` on a free port, each waited
on with a timeout.  The step against the mean of the two shards'
``loss_and_grads`` in this process (dropout on, each rank its own stream;
with ``grad_accum``), the ranks' own dropout, the layout helpers against
JAX's, the whole slice (2 ranks, remat on) against JAX's
``make_sharded_train_step`` on a 2-device mesh, and the train CLI under 2
ranks with a resume.
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocopci_tpu.config import TrainConfig as JaxTrainConfig
from mocopci_tpu.config import tiny_model_config as jax_tiny
from mocopci_tpu.models import MoCoPCI as JaxMoCoPCI
from mocopci_tpu.parallel import batch_sharding, make_mesh, replicated, shard_batch
from mocopci_tpu.parallel import mesh as jax_mesh
from mocopci_tpu.training import make_sharded_train_step
from mocopci_tpu.training.loop import TrainState as JaxTrainState
from mocopci_tpu.training.loop import make_optimizer
from mocopci_torch import MoCoPCI, parallel, tiny_model_config
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.config import TrainConfig
from mocopci_torch.training.loop import loss_and_grads
from tests.torch_parity import dynamo_importable, exact_knn, np_tree  # noqa: F401  (fixtures)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD, NPOINTS = 2, 64
NO_DROPOUT = dict(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
TIMEOUT_S = 90


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    pc1 = rng.normal(size=(n, NPOINTS, 3)).astype(np.float32)
    flow = (0.3 * rng.normal(size=(n, 1, 3))).astype(np.float32)
    gt = np.stack([pc1 + flow * s for s in (0.25, 0.5, 0.75)], axis=1).astype(np.float32)
    return {"pc1": pc1, "pc2": pc1 + flow, "gt": gt}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The ranks of one spec, started at once; :meth:`results` waits for them
    (``TIMEOUT_S`` in all, then kills them) and reads what each wrote."""

    def __init__(self, tmp_path, spec):
        self.out = tmp_path / "rank"
        spec = dict(spec, world=WORLD, out=str(self.out))
        torch.save(spec, tmp_path / "spec.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dp_worker", str(tmp_path / "spec.pt"), str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        self.deadline = time.monotonic() + TIMEOUT_S

    def results(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=max(self.deadline - time.monotonic(), 1)))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_, err)) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
        return ([torch.load(f"{self.out}.{r}.pt", weights_only=True) for r in range(WORLD)],
                [o for o, _ in outs])


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# the 2-rank runs of one launch: (the global batch, TrainConfig fields,
# dropout, the ranks that hold rows)
RUNS = {
    "mean": (_frames(2, 0), {}, True, 2),
    "grad_accum": (_frames(4, 1), {"grad_accum": 2}, True, 2),
    # the same sample on both ranks: only the dropout streams tell them apart
    "same_rows": ({k: np.concatenate([v, v]) for k, v in _frames(1, 2).items()}, {}, True, 2),
    # a global batch of 1: rank 1 holds no rows and adds zeros
    "idle_rank": (_frames(1, 3), {}, True, 1),
}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """What each rank saw in every run of ``RUNS``, and the shards computed in
    this process while the ranks run."""
    runs = [{"name": name, "npoints": NPOINTS, "model": {}, "train": train,
             "batch": _tensors(batch), "dropout": dropout, "n_data": n_data}
            for name, (batch, train, dropout, n_data) in RUNS.items()]
    ranks = Ranks(tmp_path_factory.mktemp("dp"), {"ports": [_free_port()], "runs": runs})
    shards = {name: _shards(name) for name in RUNS}
    results, _ = ranks.results()
    return [r["runs"] for r in results], shards


def _shards(name):
    """The rows of each rank that holds some through ``loss_and_grads`` in
    this process, from the same weights, with the rank's own generator: per
    rank the gradients, the loss components and the running statistics after
    its EMA."""
    batch, train, dropout, n_data = RUNS[name]
    cfg, tcfg = tiny_model_config(NPOINTS), TrainConfig(**train)
    shards = []
    for r in range(n_data):
        model = MoCoPCI(cfg, device="cpu", seed=tcfg.seed)
        rows = parallel.host_batch_slice(len(batch["pc1"]), n_data, r)
        rng = parallel.rank_generator(tcfg.seed, r, "cpu") if dropout else None
        aux = loss_and_grads(model, {k: v[rows] for k, v in batch.items()}, rng, cfg, tcfg)
        shards.append(({n: p.grad for n, p in model.named_parameters()},
                       {k: float(v) for k, v in aux.items()}, dict(model.named_buffers())))
    return shards


def _check_mean_of_shards(dp_runs, name):
    dp_runs, shards = dp_runs[0], dp_runs[1][name]

    def mean(part, key):
        return sum(shard[part][key] for shard in shards) / len(shards)

    for rank, got in enumerate(dp_runs):
        run = got[name]
        if rank < len(shards):
            assert run["local"] == pytest.approx(shards[rank][1], rel=1e-6)
        else:
            assert run["local"] is None and run["rows"][1] == run["rows"][0]
        for k in shards[0][1]:
            np.testing.assert_allclose(run["aux"][k], mean(1, k), rtol=1e-6, err_msg=k)
        for n, g in run["grads"].items():
            np.testing.assert_allclose(g.numpy(), mean(0, n).numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=n)
        for n, b in run["buffers"].items():
            np.testing.assert_allclose(b.numpy(), mean(2, n).numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=n)
    for n, p in dp_runs[0][name]["params"].items():
        assert torch.equal(p, dp_runs[1][name]["params"][n]), n
    for n, b in dp_runs[0][name]["buffers"].items():
        assert torch.equal(b, dp_runs[1][name]["buffers"][n]), n


def test_dp_step_is_the_mean_of_the_shards(dp_runs):
    """2 gloo ranks, a row each, dropout on: each rank's gradients, loss
    components and running statistics are the mean of the two shards'
    ``loss_and_grads`` (within 1e-6), and the parameters after the update are
    bit-equal across the ranks."""
    _check_mean_of_shards(dp_runs, "mean")


def test_dp_step_with_grad_accum_is_the_mean_of_the_shards(dp_runs):
    """As above with grad_accum=2: 2 rows a rank, micro-batches of 1."""
    _check_mean_of_shards(dp_runs, "grad_accum")


def test_dp_rank_without_rows_adds_zeros(dp_runs):
    """A global batch of 1 over 2 ranks: rank 1 holds no rows, the means are
    over the one rank that does (rank 0's shard), and both ranks update
    alike."""
    _check_mean_of_shards(dp_runs, "idle_rank")


def test_dp_ranks_draw_their_own_dropout(dp_runs):
    """Both ranks hold the same row: their own dropout streams make their
    local losses differ, and the step's loss is the mean of the two."""
    ranks = [r["same_rows"] for r in dp_runs[0]]
    local = [r["local"] for r in ranks]
    assert ranks[0]["rows"] == (0, 1) and ranks[1]["rows"] == (1, 2)
    assert abs(local[0]["loss"] - local[1]["loss"]) > 1e-4 * abs(local[0]["loss"])
    for k in local[0]:
        np.testing.assert_allclose(ranks[0]["aux"][k], (local[0][k] + local[1][k]) / 2,
                                   rtol=1e-6, err_msg=k)
    _check_mean_of_shards(dp_runs, "same_rows")


@pytest.mark.parametrize("batch,world", [(2, 1), (2, 2), (2, 4), (2, 8), (4, 8), (6, 4),
                                         (8, 8), (3, 2), (5, 4)])
def test_layout_matches_jax(batch, world):
    """``make_mesh_for_batch``, ``scale_batch_to_mesh`` and
    ``host_batch_slice`` against JAX's on a mesh of ``world`` data devices
    (the 8 CPU devices split into ``world`` x 8/world): rank r holds the rows
    of the mesh's r-th data device, the ranks past the mesh none."""
    n_model = 8 // world
    mesh = jax_mesh.make_mesh_for_batch(batch, n_model=n_model)
    n_data = parallel.make_mesh_for_batch(batch, world)
    assert n_data == mesh.shape["data"]
    global_batch, per_device_mesh = jax_mesh.scale_batch_to_mesh(batch, n_model=n_model)
    assert parallel.scale_batch_to_mesh(batch, world) == (global_batch,
                                                          per_device_mesh.shape["data"])
    for m, b, n in ((mesh, batch, n_data), (per_device_mesh, global_batch, world)):
        imap = batch_sharding(m).devices_indices_map((b,))
        for r in range(world):
            got = parallel.host_batch_slice(b, n, r)
            if r < n:
                idx = imap[m.devices[r, 0]][0]
                want = (idx.start or 0, b if idx.stop is None else idx.stop)
                assert (got.start, got.stop) == want, (r, got, want)
            else:
                assert got.stop - got.start == 0


def _jax_variables(model):
    """The port's weights as flax variables (the inverse of
    ``bridge.params_from_jax``): a Dense weight becomes its kernel
    transposed, a norm's weight its scale, the running statistics
    ``batch_stats`` mean and var."""
    tree = {"params": {}, "batch_stats": {}}
    for name, mod in model.named_modules():
        leaves = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for leaf, value in leaves:
            arr = value.detach().numpy().copy()
            collection, key = "params", leaf
            if leaf == "weight" and isinstance(mod, torch.nn.Linear):
                key, arr = "kernel", arr.T.copy()
            elif leaf == "weight":
                key = "scale"
            elif leaf.startswith("running_"):
                collection, key = "batch_stats", leaf[len("running_"):]
            node = tree[collection]
            for part in name.split("."):
                node = node.setdefault(part, {})
            node[key] = arr
    return tree


def _jax_mean_grads(opt_state, params):
    """The mean gradient that JAX's sharded step fed AdamW, clipped, as the
    port's named tensors: AdamW's first moment after one step is (1 - b1)
    times it, kept flat in the order of ``optax.flatten``."""
    mu = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert len(mu) == 1
    leaves, treedef = jax.tree_util.tree_flatten(params)
    flat = np.asarray(mu[0]) / (1 - JaxTrainConfig().adam_b1)
    parts = np.split(flat, np.cumsum([leaf.size for leaf in leaves])[:-1])
    tree = jax.tree_util.tree_unflatten(
        treedef, [part.reshape(leaf.shape) for part, leaf in zip(parts, leaves)])
    return params_from_jax({"params": tree})


def test_dp_remat_step_matches_jax_sharded_step(tmp_path):
    """The whole slice: JAX's ``make_sharded_train_step`` on a 2-device data
    mesh at ``remat=True``, dropout off, against 2 gloo ranks of the port from
    the same weights (the port's init, moved off it, carried into flax): the
    loss components and ``grad_norm`` within rel 1e-5, the running statistics
    within rtol 1e-4 / atol 1e-6, the mean gradients against JAX's own (read
    from AdamW's first moment) within rtol 1e-3 / atol 1e-7 of the global
    gradient norm (each leaf's L2 error within 1e-4 of its norm and as much),
    and the updated parameters (bit-equal across the ranks) within rtol 1e-5
    / atol 1e-7 plus what AdamW's first step, lr g / (|g| + eps), makes of
    the two steps' clipped gradients.  That term may count only where JAX's
    clipped gradient is below 100 eps (the clip scales g by about 1e-3
    here), and for at most 1e-3 of the entries.  A leaf whose gradient the
    port lost fails the gradient check.  The ranks run while JAX traces and
    compiles its step (about 25 s and 40 s here; the persistent compilation
    cache of ``conftest.py`` takes the compile away after the first run)."""
    batch = _frames(2, 4)
    model = MoCoPCI(dataclasses.replace(tiny_model_config(NPOINTS), **NO_DROPOUT), device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.mul_(torch.from_numpy(np.asarray(rng.uniform(0.5, 1.5, t.shape), np.float32)))
            else:
                t.add_(torch.from_numpy(np.asarray(0.05 * rng.normal(size=t.shape), np.float32)))
    weights = model.state_dict()
    variables = _jax_variables(model)
    assert all(torch.equal(v, weights[k]) for k, v in params_from_jax(variables).items())
    run = {"name": "jax", "npoints": NPOINTS, "model": dict(NO_DROPOUT, remat=True),
           "train": {}, "batch": _tensors(batch), "dropout": False, "n_data": WORLD,
           "weights": weights}
    ranks = Ranks(tmp_path, {"ports": [_free_port()], "runs": [run]})

    cfg = dataclasses.replace(jax_tiny(NPOINTS), remat=True, **NO_DROPOUT)
    tcfg = JaxTrainConfig()
    tx = make_optimizer(tcfg, 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          opt_state=tx.init(params), tx=tx, apply_fn=JaxMoCoPCI(cfg).apply)
    mesh = make_mesh(n_data=WORLD, n_model=1)
    step = make_sharded_train_step(mesh, state.apply_fn, cfg, tcfg)
    args = (jax.device_put(state, replicated(mesh)), shard_batch(mesh, batch),
            jax.random.PRNGKey(0))
    new_state, aux = step(*args)
    want = params_from_jax({"params": np_tree(new_state.params),
                            "batch_stats": np_tree(new_state.batch_stats)})
    want_grads = _jax_mean_grads(new_state.opt_state, params)

    results, _ = ranks.results()
    got = results[0]["runs"]["jax"]
    for k, v in aux.items():
        assert np.isfinite(got["aux"][k])
        np.testing.assert_allclose(got["aux"][k], float(v), rtol=1e-5, err_msg=k)
    tcfg_port = TrainConfig()
    norm = float(aux["grad_norm"])
    clip = [min(1.0, tcfg_port.grad_clip / g) for g in (got["aux"]["grad_norm"], norm)]
    assert set(got["grads"]) == set(want_grads) == set(got["params"])
    lr, eps = tcfg_port.lr, tcfg_port.adam_eps
    n_slack = n_all = 0
    for n, p in got["params"].items():
        assert torch.equal(p, results[1]["runs"]["jax"]["params"][n]), n
        g_port, g_jax = got["grads"][n].numpy(), want_grads[n].numpy() / clip[1]
        np.testing.assert_allclose(g_port, g_jax, rtol=1e-3, atol=1e-7 * norm, err_msg=n)
        assert np.linalg.norm(g_port - g_jax) <= (1e-4 * np.linalg.norm(g_jax)
                                                  + 1e-7 * norm), n
        # AdamW's first step moves p by lr g / (|g| + eps), g clipped
        clipped = (clip[0] * g_port, clip[1] * g_jax)
        move = [lr * g / (np.abs(g) + eps) for g in clipped]
        gap = np.abs(p.numpy() - want[n].numpy())
        base = 1e-7 + 1e-5 * np.abs(want[n].numpy())
        over = gap > base + np.abs(move[0] - move[1])
        assert not over.any(), (n, gap[over][:4], g_port[over][:4], g_jax[over][:4])
        # above 100 eps a gradient error within rtol 1e-3 moves p by at most
        # lr 1e-3 eps / |g| <= lr 1e-5, inside the base tolerance
        needs = gap > base
        assert (np.abs(clipped[1][needs]) < 100 * eps).all(), n
        n_slack, n_all = n_slack + int(needs.sum()), n_all + gap.size
    assert n_slack <= 1e-3 * n_all, (n_slack, n_all)
    for n, b in got["buffers"].items():
        np.testing.assert_allclose(b.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)


def test_train_cli_data_parallel_remat_and_resume(tmp_path):
    """``cli.train.main`` under 2 gloo ranks with ``--remat --dp_impl shard_map
    --batch_policy per_device --grad_accum 2``: one epoch (global batch 4, one
    step), then ``--resume`` to a second.  Rank 0 alone prints, writes the CSV
    and the checkpoints; both ranks end alike."""
    save, csv = tmp_path / "run", tmp_path / "m.csv"
    common = ["--synthetic", "4", "--tiny", "--npoints", str(NPOINTS), "--device", "cpu",
              "--batch_size", "2", "--save_dir", str(save), "--log_every", "1",
              "--knn_mode", "exact", "--remat", "--dp_impl", "shard_map",
              "--batch_policy", "per_device", "--grad_accum", "2", "--multihost",
              "--metrics_csv", str(csv)]
    ranks = Ranks(tmp_path, {"ports": [_free_port(), _free_port()],
                             "cli": [common + ["--epochs", "1"],
                                     common + ["--epochs", "2", "--resume"]]})
    results, stdout = ranks.results()
    first, second = results[0]["cli"]
    for mine, theirs in zip(results[0]["cli"], results[1]["cli"]):
        for e in mine["epochs"] + theirs["epochs"]:
            del e["epoch_time_s"]
        assert mine == theirs
    assert first["step"] == 1 and first["start_epoch"] == 0
    assert second["start_epoch"] == 1 and second["step"] == 2
    assert all(np.isfinite(v) for e in first["epochs"] + second["epochs"] for v in e.values()
               if not isinstance(v, int))
    assert "dp_impl: shard_map over 2 data shard(s)" in stdout[0]
    assert "global batch 4 (2/device x 2 data shards)" in stdout[0]
    assert "resumed from epoch 0" in stdout[0] and "Epoch 2 finished" in stdout[0]
    assert stdout[1] == ""
    assert sorted(os.listdir(save / "ckpt")) == ["epoch_0.pt", "epoch_1.pt"]
    assert len(csv.read_text().splitlines()) == 3


def test_train_cli_rank_without_rows(tmp_path):
    """``--multihost`` under 2 gloo ranks with a global batch of 1: one rank
    holds the rows (``dp_impl: shard_map over 1 data shard(s)``), the other
    loads batches of 0 rows and adds zeros, and both end alike."""
    argv = ["--synthetic", "2", "--tiny", "--npoints", str(NPOINTS), "--device", "cpu",
            "--batch_size", "1", "--epochs", "1", "--save_dir", str(tmp_path / "run"),
            "--knn_mode", "exact", "--multihost"]
    results, stdout = Ranks(tmp_path, {"ports": [_free_port()], "cli": [argv]}).results()
    (mine,), (theirs,) = results[0]["cli"], results[1]["cli"]
    for e in mine["epochs"] + theirs["epochs"]:
        del e["epoch_time_s"]
    assert mine == theirs and mine["step"] == 2
    assert all(np.isfinite(v) for v in mine["epochs"][0].values())
    assert "dp_impl: shard_map over 1 data shard(s)" in stdout[0] and stdout[1] == ""


def test_batches_host_slice_loads_only_its_rows():
    """``batches(host_slice=)``: each rank's rows of the same seeded global
    batches, and batches of 0 rows for a rank that holds none."""
    from mocopci_torch.data import SyntheticInterpolationDataset, batches

    ds = SyntheticInterpolationDataset(length=8, num_points=16, seed=0)
    whole = list(batches(ds, 4, shuffle=True, seed=7))
    for sl in (parallel.host_batch_slice(4, 2, 1), parallel.host_batch_slice(4, 2, 0)):
        part = list(batches(ds, 4, shuffle=True, seed=7, host_slice=sl))
        assert len(part) == len(whole) == 2
        for p, w in zip(part, whole):
            for k in w:
                np.testing.assert_array_equal(p[k], w[k][sl])
    idle = list(batches(ds, 4, shuffle=True, seed=7, host_slice=parallel.host_batch_slice(
        4, 1, 1)))
    assert len(idle) == 2 and all(len(b[k]) == 0 for b in idle for k in b)


def test_train_cli_refuses_spmd_above_one_rank(monkeypatch):
    """``--dp_impl spmd`` is JAX's XLA-partitioned step: the plain step on one
    rank, refused with its reason above one."""
    from mocopci_torch.cli import train as cli_train

    monkeypatch.setattr(parallel, "world", lambda: (0, 2))
    with pytest.raises(SystemExit, match="spmd over 2 ranks .*ROADMAP.*shard_map"):
        cli_train.main(["--synthetic", "2", "--tiny", "--npoints", str(NPOINTS), "--device",
                        "cpu", "--dp_impl", "spmd", "--save_dir", "unused"])
