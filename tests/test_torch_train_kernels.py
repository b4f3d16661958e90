"""The train kernels' plain versions, forward and backward, held against the JAX
package's Pallas kernels run in interpret mode (as their own tests run them),
at those tests' small shapes.  Gradients of the port come through each
kernel's ``torch.autograd.Function`` on the CPU (the plain forward, autograd
through it for the backward, the gather's scatter for table gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocopci_tpu.ops.pallas.attention_train import attention_train as jax_attention_train
from mocopci_tpu.ops.pallas.attention_train import keep_mask_reference
from mocopci_tpu.ops.pallas.chamfer_pair import chamfer_pair as jax_chamfer_pair
from mocopci_tpu.ops.pallas.cross_tail import cross_tail as jax_cross_tail
from mocopci_tpu.ops.pallas.fusion_head_train import fusion_head_train as jax_fht
from mocopci_tpu.ops.pallas.fusion_planes import gather_pair_planes
from mocopci_tpu.ops.pallas.scatter_bucket import bucket_scatter_add, bucket_scatter_add_planes
from mocopci_tpu.ops.pallas.transformer_tail import transformer_tail as jax_transformer_tail
from mocopci_torch import kernels
from mocopci_torch.kernels.attention_train import keep_mask_plain
from mocopci_torch.kernels.scatter_add import gather_backward
from tests.torch_parity import assert_close, exact_knn, t  # noqa: F401  (fixture)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _leaves(*arrays):
    return [t(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("planes", [False, True])
def test_scatter_add_matches_bucket_scatter_with_dropped_indices(planes):
    rng = np.random.default_rng(0)
    G, S, C, N = 2, 700, 3, 256
    v = _np(rng, G, C, S) if planes else _np(rng, G, S, C)
    idx = rng.integers(-20, N + 20, size=(G, S)).astype(np.int32)   # some out of range
    idx[:, :50] = 7                                                   # a crowded row
    fn = bucket_scatter_add_planes if planes else bucket_scatter_add
    want = fn(jnp.asarray(v), jnp.asarray(idx), N, 3, True)
    got = kernels.scatter_add(t(v), t(idx), N, planes=planes)
    assert got.shape == (G, N, C)
    assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("L", [65, 4097])
def test_scatter_add_plain_sums_each_row_in_ascending_source_order(L):
    """The order the card kernel is held to bit for bit in its card sweep
    (``tests/test_torch_card_scatter.py``): one row takes L sources among
    about 20 a row and about 0.5 a row; each row is the float32
    sum of its sources in ascending position (numpy's unbuffered ``add.at``),
    -1 and >= N targets are dropped, and rows with no source are exactly 0."""
    rng = np.random.default_rng(L)
    for N in (512, 20000):
        flat = np.concatenate([np.full(L, 3), rng.integers(4, N, size=10000),
                               np.tile([-1, N, N + 7], 10)]).astype(np.int32)
        idx = np.stack([rng.permutation(flat) for _ in range(2)])
        G, S = idx.shape
        for planes, C in ((False, 3), (True, 5)):
            v = _np(rng, *((G, C, S) if planes else (G, S, C)), scale=np.exp(2 * rng.normal()))
            rows = v.transpose(0, 2, 1) if planes else v
            want = np.zeros((G, N, C), np.float32)
            for g in range(G):
                keep = (idx[g] >= 0) & (idx[g] < N)
                np.add.at(want[g], idx[g][keep], rows[g][keep])
            got = kernels.scatter_add(t(v), t(idx), N, planes=planes).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gather_backward_takes_the_kernel_where_jax_does():
    rng = np.random.default_rng(1)
    for (B, S, C, N) in ((1, 32768, 3, 256), (1, 40000, 64, 2048), (1, 100, 3, 256)):
        g = t(_np(rng, B, S, C))
        idx = t(rng.integers(0, N, size=(B, S)).astype(np.int32))
        want = torch.zeros(B, N, C).index_add_(1, idx[0].long(), g)
        assert_close(gather_backward(g, idx, N), want.numpy(), atol=1e-4, rtol=1e-5)


def test_keep_mask_bit_equal_negative_seed_and_large_groups():
    seed, n, m, rate = -123456789, 33, 70, 0.05
    got = keep_mask_plain(seed, 300, n, m, rate)
    for g in (0, 1, 255, 256, 299):
        want = np.asarray(keep_mask_reference(jnp.int32(seed), g, n, m, rate))
        np.testing.assert_array_equal(got[g].numpy(), want)
    assert 0.9 < float((got > 0).float().mean()) < 0.99


@pytest.mark.parametrize("rate", [0.05, 0.0])
def test_attention_train_output_and_grads_match_jax(rate):
    """At rate 0 the card's backward takes its kernel without the keep factor
    (no hash); the plain version must still match the Pallas kernel there."""
    rng = np.random.default_rng(2)
    G, N, M, D, seed = 3, 40, 72, 8, -7
    q, k, v, co = _np(rng, G, N, D), _np(rng, G, M, D), _np(rng, G, M, D), _np(rng, G, N, D)

    def loss(q, k, v):
        out = jax_attention_train(q, k, v, jnp.int32(seed), D ** -0.5, rate, True)
        return jnp.sum(out * co), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    leaves = _leaves(q, k, v)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    out = kernels.attention_train(*leaves, seed_t, D ** -0.5, rate)
    (out * t(co)).sum().backward()
    assert_close(out, want, atol=1e-5, rtol=1e-5)
    for leaf, g in zip(leaves, grads):
        assert_close(leaf.grad, g, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("rate", [0.05, 0.0])
def test_attention_train_wide_heads_match_jax(rate):
    """Head dims past the one-pass route's 64 (the card's wide route), and
    not a multiple of 8: output and gradients against the Pallas kernel."""
    rng = np.random.default_rng(3)
    G, N, M, D, seed = 2, 24, 40, 70, 11
    q, k, v, co = _np(rng, G, N, D), _np(rng, G, M, D), _np(rng, G, M, D), _np(rng, G, N, D)

    def loss(q, k, v):
        out = jax_attention_train(q, k, v, jnp.int32(seed), D ** -0.5, rate, True)
        return jnp.sum(out * co), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    leaves = _leaves(q, k, v)
    out = kernels.attention_train(*leaves, torch.tensor([seed], dtype=torch.int32),
                                  D ** -0.5, rate)
    (out * t(co)).sum().backward()
    assert_close(out, want, atol=1e-5, rtol=1e-5)
    for leaf, g in zip(leaves, grads):
        assert_close(leaf.grad, g, atol=1e-5, rtol=1e-4)


def _cross_inputs(rng, G, M, S, K, C, C2):
    tab, base = _np(rng, G, M, C), _np(rng, G, S, C)
    w, b = _np(rng, C, C2, scale=0.2), _np(rng, C2, scale=0.1)
    idx = rng.integers(0, M, size=(G, S, K)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]           # duplicated neighbour: exact max ties
    return tab, idx, base, w, b


def test_cross_tail_vjp_matches_jax_with_duplicate_ties():
    rng = np.random.default_rng(3)
    G, M, S, K, C, C2 = 2, 40, 16, 4, 8, 8
    tab, idx, base, w, b = _cross_inputs(rng, G, M, S, K, C, C2)
    co = _np(rng, G, S, C2)
    idx_km = jnp.asarray(idx.transpose(0, 2, 1).reshape(G, K * S))

    def loss(tab, base, w, b):
        rows = jnp.take_along_axis(tab, idx_km[..., None], axis=1)
        out = jax_cross_tail(rows, base, w, b, K, True)
        return jnp.sum(jnp.sin(out) * co), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        tab, base, w, b)
    leaves = _leaves(tab, base, w, b)
    out = kernels.cross_tail(leaves[0], t(idx), *leaves[1:])
    (torch.sin(out) * t(co)).sum().backward()
    assert_close(out, want, atol=1e-5, rtol=1e-5)
    for leaf, g, name in zip(leaves, grads, ("tab", "base", "w", "b")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_transformer_tail_vjp_matches_jax():
    rng = np.random.default_rng(4)
    G, M, S, K, D = 2, 40, 24, 4, 8
    table, xq, q = _np(rng, G, M, 3 + 2 * D), _np(rng, G, S, 3), _np(rng, G, S, D)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [_np(rng, ci, co, scale=0.2), _np(rng, co, scale=0.1)]
    idx = rng.integers(0, M, size=(G, S, K)).astype(np.int32)
    cot = _np(rng, G, S, D)
    idx_km = jnp.asarray(idx.transpose(0, 2, 1).reshape(G, K * S))

    def loss(table, xq, q, *ws):
        rows = jnp.take_along_axis(table, idx_km[..., None], axis=1)
        out = jax_transformer_tail(rows, xq, q, *ws, K, True)
        return jnp.sum(jnp.cos(out) * cot), out

    (_, want), grads = jax.value_and_grad(loss, argnums=tuple(range(11)), has_aux=True)(
        table, xq, q, *ws)
    leaves = _leaves(table, xq, q, *ws)
    out = kernels.transformer_tail(leaves[0], t(idx), *leaves[1:])
    (torch.cos(out) * t(cot)).sum().backward()
    assert_close(out, want, atol=1e-5, rtol=1e-5)
    for i, (leaf, g) in enumerate(zip(leaves, grads)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=1e-5, rtol=2e-4,
                                   err_msg=f"input {i}")


def test_fusion_head_train_logits_stats_and_vjp_match_jax():
    rng = np.random.default_rng(5)
    G, F, P = 6, 3, 300
    x = _np(rng, G, 4, P)
    params, cin = [], 4
    for c in (8, 8, 16):
        params += [_np(rng, cin, c, scale=0.5), _np(rng, c, scale=0.1),
                   (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32), _np(rng, c, scale=0.1)]
        cin = c
    co = _np(rng, G, P)

    def loss(x, params):
        o, stats = jax_fht(x, params, F, interpret=True)
        return jnp.sum(o * co), (o, stats)

    (_, (want, stats)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), tuple(jnp.asarray(p) for p in params))
    leaves = _leaves(x, *params)
    o, got_stats = kernels.fusion_head_train(leaves[0], leaves[1:], F)
    (o * t(co)).sum().backward()
    assert_close(o, want, atol=1e-4, rtol=1e-4)
    for (m, v), (mj, vj) in zip(got_stats, stats):
        assert_close(m, mj, atol=1e-5, rtol=1e-4)
        assert_close(v, vj, atol=1e-5, rtol=1e-3)     # JAX's kernel forms E[z²] − mean²
    assert_close(leaves[0].grad, grads[0], atol=2e-4, rtol=2e-4)
    for i, (leaf, g) in enumerate(zip(leaves[1:], grads[1])):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=3e-4, rtol=3e-4,
                                   err_msg=f"param {i}")


def test_chamfer_pair_vjp_matches_jax():
    """(2, 256, 384) scatters through scatter_add, as JAX through its bucket
    scatter; (2, 64, 256) through the one-hot scatter (N % 128 != 0) on both."""
    rng = np.random.default_rng(6)
    for G, N, M in ((2, 256, 384), (2, 64, 256)):
        pc1, pc2 = _np(rng, G, N, 3, scale=3.0), _np(rng, G, M, 3, scale=3.0)
        c1, c2 = _np(rng, G, N), _np(rng, G, M)

        def loss(a, b):
            d12, d21 = jax_chamfer_pair(a, b, True)
            return jnp.sum(d12 * c1) + jnp.sum(d21 * c2), (d12, d21)

        (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(pc1), jnp.asarray(pc2))
        leaves = _leaves(pc1, pc2)
        d12, d21 = kernels.chamfer_pair(*leaves)
        ((d12 * t(c1)).sum() + (d21 * t(c2)).sum()).backward()
        assert_close(d12, want[0], atol=1e-6, rtol=1e-5)
        assert_close(d21, want[1], atol=1e-6, rtol=1e-5)
        for leaf, g in zip(leaves, grads):
            assert_close(leaf.grad, g, atol=1e-5, rtol=1e-5)


def test_fusion_pair_planes_vjp_matches_jax():
    rng = np.random.default_rng(7)
    G, N, N2, K2 = 2, 128, 256, 3
    p2, p1 = _np(rng, G, N2, 3, scale=4.0), _np(rng, G, N, 3, scale=4.0)
    idx = rng.integers(0, N2, size=(G, N, K2)).astype(np.int32)
    co = _np(rng, G, 4, N * K2)
    idx_km = jnp.asarray(idx.transpose(0, 2, 1).reshape(G, K2 * N))

    def loss(p2, p1):
        x = gather_pair_planes(p2, idx_km, p1.transpose(0, 2, 1), True)
        return jnp.sum(x * co), x

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p2), jnp.asarray(p1))
    leaves = _leaves(p2, p1)
    planes = kernels.fusion_pair_planes(leaves[0], t(idx), leaves[1])
    (planes * t(co)).sum().backward()
    assert_close(planes, want, atol=1e-5, rtol=1e-5)
    for leaf, g in zip(leaves, grads):
        assert_close(leaf.grad, g, atol=1e-4, rtol=1e-4)
