"""Shared helpers for the tests that hold the PyTorch port against the JAX package.

Inputs and weights are made with numpy, run through the JAX module on the CPU
(plain XLA) and through its port counterpart with the weights carried over by
``mocopci_torch.bridge``, both in the kNN mode a module's fixture sets.
"""
import contextlib
import functools
import sys

import jax
import numpy as np
import pytest
import torch

from mocopci_tpu.ops import distance as jax_distance
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.ops import distance as port_distance


@contextlib.contextmanager
def knn_mode(mode):
    """JAX and the port in kNN ``mode``, restored afterwards so other tests on
    the same worker see the mode they expect.  PyTorch runs on one thread:
    the shapes are tiny, and idle pool threads would spin on cores the other
    test workers need."""
    saved = (jax_distance._KNN_MODE, jax_distance._KNN_RECALL)
    saved_port = port_distance.get_knn_mode()
    jax_distance.set_knn_mode(mode)
    port_distance.set_knn_mode(mode)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        port_distance.set_knn_mode(saved_port)
        jax_distance.set_knn_mode(*saved)


@pytest.fixture(scope="module", autouse=True)
def exact_knn():
    """Both packages in exact kNN mode for this module's tests."""
    with knn_mode("exact"):
        yield


@pytest.fixture(scope="module", autouse=True)
def approx_knn():
    """Both packages in approx kNN mode, the default, for this module's tests
    (on the CPU the JAX package then still selects exactly)."""
    with knn_mode("approx"):
        yield


@pytest.fixture(scope="module", autouse=True)
def dynamo_importable():
    """A ``torch.optim`` optimizer imports ``torch._dynamo`` on first use, which
    reads the import spec of every module it knows, ``sklearn`` among them;
    ``tests/ref_torch.py`` (imported at collection by the reference parity
    tests, so in every test process) registers a spec-less stub under that
    name.  Import it once with the stubs set aside."""
    stubs = {name: mod for name, mod in sys.modules.items()
             if name.split(".")[0] == "sklearn" and getattr(mod, "__spec__", True) is None}
    for name in stubs:
        del sys.modules[name]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.modules.update(stubs)
    yield


def np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def perturb(variables, rng, scale=0.05):
    """Move every leaf off its init value (BN stats, gamma, alpha included) so
    no parameter hides behind a zero or identity initialisation."""

    def one(path, a):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        return (a + scale * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, np_tree(variables))


def init_jax(module, rng, *args, **kwargs):
    """``jax.jit(module.init)`` on numpy inputs, then perturbed numpy variables."""
    v = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)
    return perturb(v, rng)


@functools.lru_cache(maxsize=None)
def tiny_model_variables(npoints):
    """The JAX ``MoCoPCI`` at ``tiny_model_config(npoints)``, one frame pair
    (seed 0) and its perturbed variables: built once per test process and
    shared by the modules that hold the tiny eval forward against it (its
    ``init`` trace is the larger part of their time).  Read-only."""
    from mocopci_tpu.config import tiny_model_config
    from mocopci_tpu.models import MoCoPCI

    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(1, npoints, 3)).astype(np.float32)
    x2 = (x1 + 0.05 * rng.normal(size=x1.shape)).astype(np.float32)
    jm = MoCoPCI(tiny_model_config(npoints))
    return jm, x1, x2, init_jax(jm, rng, x1, x2)


def load(torch_module, variables):
    """Carry flax variables into ``torch_module`` (strict) and return it in eval."""
    torch_module.load_state_dict(params_from_jax(variables), strict=True)
    return torch_module.eval()


def t(x):
    return torch.from_numpy(np.array(x, order="C"))


def assert_close(got, want, atol=1e-5, rtol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)
