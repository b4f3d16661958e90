"""The port's whole eval forward held against the JAX package on the CPU.

``MoCoPCI`` at ``tiny_model_config(128)``, weights from ``jax.jit(model.init)``
(perturbed off init, BatchNorm statistics and Injector gammas included) and
carried over by the bridge; outputs within atol 1e-4 (reassociation over
~40 layers compounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocopci_tpu.config import ModelConfig as JaxModelConfig
from mocopci_tpu.models import MoCoPCI as JaxMoCoPCI
from mocopci_torch import MoCoPCI, ModelConfig, interpolate, tiny_model_config
from mocopci_torch.bridge import params_from_jax
from tests.torch_parity import exact_knn, tiny_model_variables  # noqa: F401  (fixture)


def test_tiny_eval_forward_matches_jax():
    npoints = 128
    jm, x1, x2, variables = tiny_model_variables(npoints)
    want = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False)["out"])(
        variables, x1, x2))
    model = MoCoPCI(tiny_model_config(npoints), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    got = interpolate(model, x1, x2)
    assert got.shape == (1, 3, npoints, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_full_width_weights_load_strictly():
    """Every parameter of the production ModelConfig() maps one to one."""
    x = jax.ShapeDtypeStruct((1, JaxModelConfig().npoints, 3), jnp.float32)
    shapes = jax.eval_shape(JaxMoCoPCI(JaxModelConfig()).init, jax.random.PRNGKey(0), x, x)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = params_from_jax(variables)
    model = MoCoPCI(ModelConfig(), device="cpu")
    model.load_state_dict(state, strict=True)
    assert len(state) == len(model.state_dict()) == 306
