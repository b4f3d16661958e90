"""The op-level kernels held against the JAX package on the CPU: ``select_min_k``
and the selection functions around it (``_topk_min_indices``,
``_select_blocked``, exact kNN above the kernel's reference limit), the one-hot
row scatter, and ``build_pair_planes`` with its own backward.  The Pallas
kernels run in interpret mode, as their own tests run them.  Tolerances are
atol 1e-5 / rtol 1e-5; selections must be index-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocopci_tpu import ops as jops
from mocopci_tpu.ops import distance as jax_distance
from mocopci_tpu.ops.pallas.fusion_planes import build_pair_planes as jax_build_pair_planes
from mocopci_tpu.ops.pallas.scatter import onehot_scatter_rows as jax_onehot
from mocopci_tpu.ops.pallas.select_k import select_min_k_pallas
from mocopci_torch import kernels, ops
from mocopci_torch.kernels import knn as knn_kernel
from mocopci_torch.ops import distance
from tests.torch_parity import assert_close, exact_knn, knn_mode, t  # noqa: F401  (fixture)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,k,dup", [((2, 50, 96), 5, False), ((3, 300, 200), 17, True)])
def test_select_min_k_plain_equals_pallas(shape, k, dup):
    """(3, 300, 200): rows and lanes off the kernel's 256 / 128 tiles, values
    drawn from 7 levels so most rows hold many ties."""
    rng = np.random.default_rng(0)
    vals = (rng.integers(0, 7, size=shape) if dup else rng.normal(size=shape)).astype(np.float32)
    idxs = rng.integers(0, 10_000, size=shape).astype(np.int32)
    want = np.asarray(select_min_k_pallas(jnp.asarray(vals), jnp.asarray(idxs), k,
                                          interpret=True))
    got = kernels.select_min_k(t(vals), t(idxs), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.argsort(vals, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(kernels.select_min_k(t(vals), None, k).numpy(), pos)
    with pytest.raises(ValueError):
        kernels.select_min_k(t(vals), None, shape[-1] + 1)


def test_approx_bins_match_xla():
    """L, the candidates per row of ``approx_min_k(..., aggregate_to_topk=False)``,
    as XLA shapes it (no computation: ``jax.eval_shape``)."""
    for M in (100, 200, 1300, 3000, 8192, 16384, 100000, 131072):
        for k in (1, 8, 32):
            for shape in ((M,), (2, 4, M)):
                out = jax.eval_shape(
                    lambda d: jax.lax.approx_min_k(d, k, recall_target=0.95,
                                                   aggregate_to_topk=False),
                    jax.ShapeDtypeStruct(shape, jnp.float32))
                assert distance.approx_bins(M, k, len(shape)) == out[0].shape[-1], (M, k, shape)


def _tpu_approx_reference(d, k):
    """The JAX package's TPU path of ``_topk_min_indices`` in approx mode: the
    bins of ``approx_min_k`` (numpy) and the Pallas select kernel.  The bin
    layout (bin j holds columns j, j + L, ...) is an assumption taken from the
    JAX package's comments, not read from XLA: on the CPU ``approx_min_k(...,
    aggregate_to_topk=False)`` returns the L smallest of the row, sorted, so
    only L (``test_approx_bins_match_xla``) and the recall can be held against
    XLA here."""
    L = distance.approx_bins(d.shape[-1], k, d.ndim)
    n = -(-d.shape[-1] // L)
    padded = np.full(d.shape[:-1] + (n * L,), np.inf, np.float32)
    padded[..., :d.shape[-1]] = d
    binned = padded.reshape(d.shape[:-1] + (n, L))
    arg = binned.argmin(-2)
    vals = np.take_along_axis(binned, arg[..., None, :], -2)[..., 0, :]
    idx = (arg * L + np.arange(L)).astype(np.int32)
    return np.asarray(select_min_k_pallas(jnp.asarray(vals), jnp.asarray(idx), k,
                                          interpret=True))


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_topk_min_indices_matches_jax(mode):
    """Exact: one selection over the row (M <= 16384; JAX chunks at 3072)
    and the 1024-chunk merge (M = 17408) equal JAX's.  Approx: where the bins are the columns (M <= 128) JAX's CPU
    result; where they fold, the TPU route under the assumed bin layout (see
    ``_tpu_approx_reference``), with recall >= 0.95 against JAX's CPU result,
    which is exact."""
    rng = np.random.default_rng(1)
    cases = [((2, 40, 100), 9), ((1, 10, 50), 30), ((1, 24, 3072), 16), ((1, 3, 17408), 16)]
    with knn_mode(mode):
        for shape, k in cases:
            d = (rng.normal(size=shape) ** 2).astype(np.float32)
            got = distance._topk_min_indices(t(d), k).numpy()
            want = np.asarray(jax_distance._topk_min_indices(jnp.asarray(d), k))
            assert got.shape == shape[:-1] + (k,)
            if mode == "exact" or shape[-1] <= 128:
                np.testing.assert_array_equal(got, want)
                continue
            np.testing.assert_array_equal(got, _tpu_approx_reference(d, k))
            hits = (got[..., :, None] == want[..., None, :]).any(-1).mean()
            assert hits >= 0.95


@pytest.fixture
def small_blocks(monkeypatch):
    """Tiny blocking thresholds on both sides, as ``tests/test_ops_blocked.py``
    sets them, and a kernel reference limit of 100."""
    for mod in (jax_distance, distance):
        monkeypatch.setattr(mod, "_DENSE_LIMIT", 4096)
        monkeypatch.setattr(mod, "_REF_CHUNK", 64)
    monkeypatch.setattr(knn_kernel, "MAX_M", 100)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_select_blocked_matches_jax(small_blocks, mode):
    """Query chunks (M = 50) and reference chunks (M = 200, 4 chunks of <= 64:
    their bins are the columns, so approx mode is exact as in JAX on the CPU),
    Euclidean and cosine."""
    rng = np.random.default_rng(2)
    cases = [(jops.square_distance, distance.square_distance, (2, 50, 3), (2, 300, 3), 5),
             (jops.square_distance, distance.square_distance, (1, 200, 3), (1, 150, 3), 7),
             (jops.cosine_distance, distance.cosine_distance, (1, 130, 16), (1, 140, 16), 4)]
    with knn_mode(mode):
        for jax_fn, port_fn, rshape, qshape, k in cases:
            ref, q = _np(rng, *rshape), _np(rng, *qshape)
            want = np.asarray(jax_distance._select_blocked(jax_fn, k, jnp.asarray(ref),
                                                           jnp.asarray(q)))
            got = distance._select_blocked(port_fn, k, t(ref), t(q)).numpy()
            np.testing.assert_array_equal(got, want)


def test_exact_knn_above_the_kernel_limit_takes_the_blocked_route(small_blocks):
    """Exact mode above ``knn.MAX_M`` (patched to 100) goes to
    ``_select_blocked``, as JAX's TPU path does above ``EXACT_MAX_M``."""
    rng = np.random.default_rng(3)
    ref, q = _np(rng, 1, 200, 3), _np(rng, 1, 150, 3)
    got = ops.knn(7, t(ref), t(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.knn(7, ref, q)))
    fr, fq = _np(rng, 1, 130, 16), _np(rng, 1, 140, 16)
    np.testing.assert_array_equal(ops.knn_cosine(4, t(fr), t(fq)).numpy(),
                                  np.asarray(jops.knn_cosine(4, fr, fq)))


def test_onehot_scatter_plain_matches_pallas_with_dropped_targets():
    rng = np.random.default_rng(4)
    G, S, N = 2, 2048, 512
    v = _np(rng, G, S, 3)
    idx = rng.integers(-20, N + 20, size=(G, S)).astype(np.int32)     # some out of range
    want = jax_onehot(jnp.asarray(v), jnp.asarray(idx), N, interpret=True)
    got = kernels.onehot_scatter_rows(t(v), t(idx), N)
    assert got.shape == (G, 3, N)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        kernels.onehot_scatter_rows(t(v), t(idx), 600)


def _planes_inputs(rng, G, N, k2):
    return _np(rng, G, N * k2, 3, scale=8.0), _np(rng, G, 3, N, scale=8.0)


def test_build_pair_planes_forward_and_vjp_match_jax():
    rng = np.random.default_rng(5)
    G, N, k2 = 2, 128, 3
    nbr, p1t = _planes_inputs(rng, G, N, k2)
    nbr[0, N + 5] = p1t[0, :, 5]                       # a zero-distance pair
    co = _np(rng, G, 4, N * k2)

    def loss(a, b):
        x = jax_build_pair_planes(a, b, interpret=True)
        return jnp.sum(jnp.sin(x) * co), x

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(nbr), jnp.asarray(p1t))
    leaves = [t(a).requires_grad_() for a in (nbr, p1t)]
    x = kernels.build_pair_planes(*leaves)
    (torch.sin(x) * t(co)).sum().backward()
    assert_close(x, want, atol=1e-5, rtol=1e-5)
    for leaf, g in zip(leaves, grads):
        assert torch.isfinite(leaf.grad).all()
        assert_close(leaf.grad, g, atol=1e-5, rtol=1e-5)


def test_build_pair_planes_refuses_unaligned_n():
    rng = np.random.default_rng(6)
    nbr, p1t = _planes_inputs(rng, 2, 128, 1)
    with pytest.raises(ValueError, match="N % 128 == 0"):
        kernels.build_pair_planes(t(nbr[:, :60]), t(p1t[:, :, :60]))
