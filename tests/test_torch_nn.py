"""Port modules held against their flax counterparts on the CPU, f32.

Weights come from ``jax.jit(module.init)``, are perturbed off their init
values and carried over by ``bridge.params_from_jax``.  Tolerance atol 1e-5,
rtol 1e-4: the two frameworks sum in different orders.
"""
import functools

import jax
import numpy as np
import pytest

from mocopci_tpu import nn as jnn
from mocopci_tpu.nn import attention as jattention
from mocopci_torch import nn as pnn
from mocopci_torch.nn import attention as pattention
from tests.torch_parity import assert_close, exact_knn, init_jax, load, t  # noqa: F401


def _run(jax_module, torch_module, inputs, jax_kwargs=None, seed=0):
    """Init + apply the flax module, load the port module, compare outputs."""
    rng = np.random.default_rng(seed)
    kw = jax_kwargs or {}
    variables = init_jax(jax_module, rng, *inputs, **kw)
    want = jax.jit(functools.partial(jax_module.apply, **kw))(variables, *inputs)
    got = load(torch_module, variables)(*map(t, inputs))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        assert_close(g, w)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


BASIC = {
    "conv_lrelu": (lambda: jnn.ConvLReLU(16), lambda: pnn.ConvLReLU(8, 16)),
    "weightnet": (lambda: jnn.WeightNet(8), lambda: pnn.WeightNet(8)),
    "mlp": (lambda: jnn.Mlp(4, 8), lambda: pnn.Mlp(8, 4, 8)),
    "easy_mlp": (lambda: jnn.EasyMlp(12, 6), lambda: pnn.EasyMlp(8, 12, 6)),
    "mlp_t": (lambda: jnn.MlpT(12, 6), lambda: pnn.MlpT(8, 12, 6)),
    "prelu": (lambda: jnn.PReLU(), lambda: pnn.PReLU()),
    "frame_bn": (lambda: jnn.FrameBatchNorm(), lambda: pnn.FrameBatchNorm(8)),
}


@pytest.mark.parametrize("name", sorted(BASIC))
def test_basic_module_matches_jax(name):
    make_jax, make_torch = BASIC[name]
    width = 3 if name == "weightnet" else 8
    _run(make_jax(), make_torch(), [_x(2, 5, 7, width)])


def test_frame_batchnorm_grouped_cf_matches_jax():
    x = _x(3, 2, 8, 20)                                     # (G, B, C, P)
    jm = jnn.FrameBatchNorm(eps=1e-3)
    variables = init_jax(jm, np.random.default_rng(0), x, train=False, grouped_cf=True)
    want = jm.apply(variables, x, train=False, grouped_cf=True)
    got = load(pnn.FrameBatchNorm(8, eps=1e-3), variables)(t(x), grouped_cf=True)
    assert_close(got, want)


def test_pointconv_matches_jax():
    xyz, feat = _x(2, 64, 3), _x(2, 64, 6, seed=2)
    _run(jnn.PointConv(8, 16, 8), pnn.PointConv(8, 6, 16, 8), [xyz, feat])


def test_pointconv_d_matches_jax():
    xyz, feat = _x(2, 64, 3), _x(2, 64, 6, seed=2)
    _run(jnn.PointConvD(16, 8, 16, 8), pnn.PointConvD(16, 8, 6, 16, 8), [xyz, feat])


def test_ei_crossformer_matches_jax():
    _run(jnn.EICrossformer(16), pnn.EICrossformer(16),
         [_x(2, 24, 16), _x(2, 24, 16, seed=2)])


def test_cross_frame_block_matches_jax():
    _run(jnn.CrossFrameBlock(16), pnn.CrossFrameBlock(16), [_x(2, 2, 24, 16)])


def test_multi_frame_block_matches_jax():
    _run(jnn.MultiFrameBlock(16, 24), pnn.MultiFrameBlock(16, 24), [_x(2, 5, 24, 16)])


def test_chunked_mha_matches_jax(monkeypatch):
    q, k, v = _x(1, 2, 300, 2, 4), _x(1, 2, 30, 2, 4, seed=2), _x(1, 2, 30, 2, 4, seed=3)
    want = jattention._chunked_mha(q, k, v, 0.5)
    assert_close(pattention._chunked_mha(t(q), t(k), t(v), 0.5), want)
    # force three query chunks in the port
    monkeypatch.setattr(pattention, "_DENSE_ATTN_LIMIT", 128 * 30)
    assert_close(pattention._chunked_mha(t(q), t(k), t(v), 0.5), want)


def _cross_inputs(n, width, knn_width):
    return [_x(2, n, 3, seed=1), _x(2, n, 3, seed=2), _x(2, n, width, seed=3),
            _x(2, n, width, seed=4), _x(2, n, knn_width, seed=5), _x(2, n, knn_width, seed=6)]


def test_cross_layer_matches_jax():
    _run(jnn.CrossLayerFeatCosine(8, (16, 16), (16, 16)),
         pnn.CrossLayerFeatCosine(8, 20, (16, 16), (16, 16)), _cross_inputs(40, 20, 12))


@pytest.mark.parametrize("n", [40, 1024])
def test_bidirectional_layer_matches_jax(n):
    # n = 1024 takes the port's cross_tail path (the JAX Pallas dispatch width)
    _run(jnn.BidirectionalLayerFeatCosine(4, (8, 8)),
         pnn.BidirectionalLayerFeatCosine(4, 12, (8, 8)), _cross_inputs(n, 12, 4))


@pytest.mark.parametrize("n", [40, 1024])
def test_flow_embedding_matches_jax(n):
    _run(jnn.FlowEmbeddingLayer(4, (8, 8)), pnn.FlowEmbeddingLayer(4, 12, (8, 8)),
         _cross_inputs(n, 12, 4))


@pytest.mark.parametrize("n", [64, 1024])
def test_point_transformer_matches_jax(n):
    # n = 1024 takes the port's transformer_tail path
    _run(jnn.PointTransformerBlock(8, 4), pnn.PointTransformerBlock(8, 4),
         [_x(2, n, 8), _x(2, n, 3, seed=2)])
