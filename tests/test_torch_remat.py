"""Remat in the port (``ModelConfig.remat``): the decoder stages
``multi_frame_up_2``, ``multi_frame_up_1``, ``_refine`` and ``_fusion`` under
``torch.utils.checkpoint``, held on the CPU against the step without remat.

The recompute must replay the forward's dropout draws from the explicit
generator and must not move the BatchNorm running statistics a second time,
so with dropout on the two steps agree: the loss, the gradients, the running
statistics and the generator's state after the step.  A count of the stages'
entries shows that each ran twice.
"""
import dataclasses

import numpy as np
import torch

from mocopci_torch import MoCoPCI, tiny_model_config
from mocopci_torch.config import TrainConfig
from mocopci_torch.training import create_train_state, train_step
from tests.torch_parity import dynamo_importable, exact_knn  # noqa: F401  (fixtures)

NPOINTS, B = 64, 2
STAGES = ("multi_frame_up_2", "multi_frame_up_1", "_refine", "_fusion")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pc1 = rng.normal(size=(B, NPOINTS, 3)).astype(np.float32)
    flow = (0.3 * rng.normal(size=(B, 1, 3))).astype(np.float32)
    gt = np.stack([pc1 + flow * s for s in (0.25, 0.5, 0.75)], axis=1).astype(np.float32)
    return {"pc1": pc1, "pc2": pc1 + flow, "gt": gt}


def _count_stages(model):
    """Counts each stage's entries (a recompute that stops early never
    returns, so entries, not returns)."""
    est, calls = model.estimator, dict.fromkeys(STAGES, 0)

    def pre_hook(name):
        def hook(module, args, kwargs):
            calls[name] += 1
        return hook

    def counting(name, method):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return method(*args, **kwargs)
        return wrapper

    for name in STAGES[:2]:
        getattr(est, name).register_forward_pre_hook(pre_hook(name), with_kwargs=True)
    for name in STAGES[2:]:
        setattr(est, name, counting(name, getattr(est, name)))
    return calls


def _step(remat, batch):
    cfg = dataclasses.replace(tiny_model_config(NPOINTS), remat=remat)
    model, state = create_train_state(cfg, TrainConfig(), steps_per_epoch=1, device="cpu")
    calls = _count_stages(model)
    rng = torch.Generator().manual_seed(7)
    _, aux = train_step(state, batch, rng)
    return {"aux": {k: float(v) for k, v in aux.items()}, "calls": calls,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()},
            "rng": rng.get_state()}


def test_remat_step_equals_the_step_without_remat():
    """Dropout on (the tiny config's rates), one generator seed: the loss
    within rel 1e-6, the gradients within rtol 1e-5 / atol 1e-7, the running
    statistics equal, the generator's state equal after the step, and each of
    the four stages entered twice as often (forward and recompute)."""
    batch = _batch()
    plain, remat = _step(False, batch), _step(True, batch)
    assert plain["calls"] == {"multi_frame_up_2": 2, "multi_frame_up_1": 2, "_refine": 1,
                              "_fusion": 1}
    assert remat["calls"] == {k: 2 * v for k, v in plain["calls"].items()}
    for k, v in plain["aux"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(remat["aux"][k], v, rtol=1e-6, err_msg=k)
    for n, g in plain["grads"].items():
        np.testing.assert_allclose(remat["grads"][n].numpy(), g.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)
        np.testing.assert_allclose(remat["params"][n].numpy(), plain["params"][n].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    assert set(remat["stats"]) == set(plain["stats"])
    for n, s in plain["stats"].items():
        assert torch.equal(remat["stats"][n], s), n
    assert torch.equal(remat["rng"], plain["rng"])


def test_remat_leaves_the_eval_forward_alone():
    """remat=True changes neither the eval forward nor a train forward
    without autograd: the same outputs as remat=False, no stage run twice."""
    batch = _batch(1)
    x1, x2 = torch.from_numpy(batch["pc1"]), torch.from_numpy(batch["pc2"])
    outs = {}
    for remat in (False, True):
        model = MoCoPCI(dataclasses.replace(tiny_model_config(NPOINTS), remat=remat),
                        device="cpu", seed=3)
        calls = _count_stages(model)
        with torch.no_grad():
            evals = model(x1, x2)["out"]
            trains = model(x1, x2, train=True, rng=torch.Generator().manual_seed(1))["out"]
        outs[remat] = (evals, trains, dict(calls))
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])
    assert outs[True][2] == outs[False][2] == {"multi_frame_up_2": 4, "multi_frame_up_1": 4,
                                               "_refine": 2, "_fusion": 2}
