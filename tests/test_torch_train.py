"""The port's train step held against the JAX package on the CPU.

One JAX value-and-grad of the loss at ``tiny_model_config(64)``, B=2, dropout
rates 0 (its compile dominates, so one test makes every assertion from it),
against the port's ``loss_and_grads`` on the same weights (bridged, perturbed
off init) and batch: the loss components within
rel 1e-5, every gradient leaf within rtol 1e-3 / atol 1e-5, and the BatchNorm
running statistics after the step.  Then the optimizer against optax,
gradient accumulation, and the train CLI with a resume.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mocopci_tpu.config import TrainConfig as JaxTrainConfig
from mocopci_tpu.config import tiny_model_config as jax_tiny
from mocopci_tpu.models import MoCoPCI as JaxMoCoPCI
from mocopci_tpu.training.loop import _make_optimizer_inner
from mocopci_tpu.training.loss import mocopci_loss as jax_loss
from mocopci_torch import MoCoPCI, tiny_model_config
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.config import TrainConfig
from mocopci_torch.training.loop import TrainState, apply_update, loss_and_grads
from tests.torch_parity import (  # noqa: F401  (fixtures)
    dynamo_importable,
    exact_knn,
    init_jax,
    np_tree,
)

NPOINTS, B = 64, 2
NO_DROPOUT = dict(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)


def _batch():
    rng = np.random.default_rng(0)
    pc1 = rng.normal(size=(B, NPOINTS, 3)).astype(np.float32)
    flow = (0.3 * rng.normal(size=(B, 1, 3))).astype(np.float32)
    gt = np.stack([pc1 + flow * s for s in (0.25, 0.5, 0.75)], axis=1).astype(np.float32)
    return {"pc1": pc1, "pc2": pc1 + flow, "gt": gt}


def test_train_step_matches_jax_grad():
    """The loss components (rel 1e-5), every gradient leaf (rtol 1e-3, atol
    1e-5) and the BatchNorm running statistics after the step (rtol 1e-4)."""
    batch = _batch()
    cfg = dataclasses.replace(jax_tiny(NPOINTS), **NO_DROPOUT)
    tcfg = JaxTrainConfig()
    jm = JaxMoCoPCI(cfg)
    variables = init_jax(jm, np.random.default_rng(1), batch["pc1"], batch["pc2"])

    def loss_fn(params, stats):
        result, mut = jm.apply({"params": params, "batch_stats": stats}, batch["pc1"],
                               batch["pc2"], train=True, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=["batch_stats"])
        total, aux = jax_loss(result, jnp.asarray(batch["gt"]), cfg, tcfg)
        return total, (aux, mut["batch_stats"])

    (_, (aux, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    want_grads = params_from_jax({"params": np_tree(grads)})
    want_stats = params_from_jax({"batch_stats": np_tree(stats)})

    model = MoCoPCI(dataclasses.replace(tiny_model_config(NPOINTS), **NO_DROPOUT), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    got_aux = loss_and_grads(model, batch, None, model.cfg, TrainConfig())
    assert set(got_aux) == set(aux)
    for k, v in aux.items():
        assert np.isfinite(float(got_aux[k]))
        np.testing.assert_allclose(float(got_aux[k]), float(v), rtol=1e-5, err_msg=k)
    got_grads = dict(model.named_parameters())
    assert set(got_grads) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got_grads[name].grad.numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    got_stats = dict(model.named_buffers())
    assert set(got_stats) == set(want_stats)
    for name, v in want_stats.items():
        np.testing.assert_allclose(got_stats[name].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_clip_adamw_schedule_match_optax():
    """Three updates of a toy parameter set from the same gradients: the first
    two clipped (norm above 2.0), the third not; the schedule crosses a StepLR
    boundary (1 step per epoch, lr_step 2)."""
    rng = np.random.default_rng(3)
    cfg = TrainConfig(lr_step=2, lr_gamma=0.5)
    jcfg = JaxTrainConfig(lr_step=2, lr_gamma=0.5)
    shapes = {"a": (4, 3), "b": (3,), "c": ()}
    params = {k: np.array(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    grad_steps = [{k: np.array(rng.normal(size=s) * m, np.float32) for k, s in shapes.items()}
                  for m in (5.0, 3.0, 0.1)]

    tx = _make_optimizer_inner(jcfg, 1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grad_steps:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    state = TrainState(module, torch.optim.AdamW(
        module.parameters(), lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
        weight_decay=cfg.weight_decay), None, cfg, steps_per_epoch=1)
    norms = []
    for g in grad_steps:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(apply_update(state)))
    want_norms = [float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
                  for g in grad_steps]
    np.testing.assert_allclose(norms, want_norms, rtol=1e-6)
    assert norms[0] > cfg.grad_clip > norms[2]
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_train_cli_trains_checkpoints_and_resumes(tmp_path):
    from mocopci_torch.cli import train as cli_train

    common = ["--synthetic", "4", "--tiny", "--npoints", "64", "--device", "cpu",
              "--batch_size", "2", "--save_dir", str(tmp_path), "--log_every", "1",
              "--knn_mode", "exact"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        first = cli_train.main(common + ["--epochs", "1"])
        assert first["step"] == 2 and first["start_epoch"] == 0
        assert (tmp_path / "ckpt" / "epoch_0.pt").exists()
        second = cli_train.main(common + ["--epochs", "2", "--resume"])
    finally:
        torch.set_num_threads(threads)
    assert second["start_epoch"] == 1 and second["step"] == 4
    assert [e["epoch"] for e in second["epochs"]] == [1]
    assert all(np.isfinite(v) for v in second["epochs"][0].values())
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli_train.main(common + ["--compute_dtype", "bfloat16"])


def test_grad_accum_matches_full_batch_on_duplicated_sample():
    """grad_accum=2 over [X], [X] gives the gradient of one B=2 step on [X, X]:
    the batch statistics of [X] and [X, X] are the same, so only the order of
    the sums differs (the JAX package's own test, on the port)."""
    cfg = dataclasses.replace(tiny_model_config(NPOINTS), **NO_DROPOUT)
    one = {k: v[:1] for k, v in _batch().items()}
    two = {k: np.concatenate([v, v]) for k, v in one.items()}
    grads, aux = [], []
    for k in (1, 2):
        model = MoCoPCI(cfg, device="cpu", seed=3)
        aux.append(loss_and_grads(model, two, None, cfg, TrainConfig(grad_accum=k)))
        grads.append([p.grad.clone() for p in model.parameters()])
    np.testing.assert_allclose(float(aux[1]["loss"]), float(aux[0]["loss"]), rtol=2e-5)
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3, atol=1e-5)
