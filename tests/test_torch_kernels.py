"""Each CUDA kernel's plain twin held against the TPU kernel it replaces, run
in Pallas interpret mode on the CPU with the same numpy inputs.

The twins are what the kernels are compared with on the card (chip_smoke.py,
tests/test_torch_cuda.py), so this closes the chain kernel = twin = Pallas.
Indices and packed keys must be equal; values agree to atol 1e-5, rtol 1e-4
(sum order).  The cosine kNN ranks by a dot product whose sum order differs,
so there only swaps at float-rounding distance gaps are allowed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocopci_tpu.ops.pallas.attention import fused_attention_pallas
from mocopci_tpu.ops.pallas.chamfer_pair import _pair_keys
from mocopci_tpu.ops.pallas.chamfer_pair import chamfer_pair as jax_chamfer_pair
from mocopci_tpu.ops.pallas.cross_tail import cross_tail as jax_cross_tail
from mocopci_tpu.ops.pallas.fps import (
    farthest_point_sample_pallas,
    farthest_point_sample_pyramid_pallas,
)
from mocopci_tpu.ops.pallas.fusion_head import fold_bn_dense as jax_fold
from mocopci_tpu.ops.pallas.fusion_head import fusion_head_pallas
from mocopci_tpu.ops.pallas.gather_planes import bucket_gather_pair_planes
from mocopci_tpu.ops.pallas.knn import exact_knn_pallas, fused_knn_pallas
from mocopci_tpu.ops.pallas.transformer_tail import transformer_tail as jax_tt
from mocopci_torch import kernels
from mocopci_torch.ops.distance import _normalise
from mocopci_torch.ops.sampling import gather
from tests.torch_parity import assert_close, exact_knn, t  # noqa: F401  (fixture)


def _x(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("metric,C,k", [("euclidean", 3, 16), ("cosine", 16, 8)])
def test_knn_twin_matches_pallas_exact(metric, C, k):
    rng = np.random.default_rng(0)
    q, r = t(_x(rng, 2, 64, C)), t(_x(rng, 2, 200, C))
    if metric == "cosine":
        q, r = _normalise(q), _normalise(r)
    got = kernels.knn_plain(q, r, k, metric).numpy()
    want = exact_knn_pallas(jnp.asarray(q.numpy()), jnp.asarray(r.numpy()), k, metric,
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fps_twin_matches_pallas():
    rng = np.random.default_rng(1)
    xyz = _x(rng, 2, 256, 3)
    got = kernels.fps_plain(t(xyz), 32).numpy()
    want = farthest_point_sample_pallas(jnp.asarray(xyz), 32, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    levels = (64, 32, 16, 8)
    want = farthest_point_sample_pyramid_pallas(jnp.asarray(xyz), levels, interpret=True)
    pc = t(xyz)
    for n, w in zip(levels, want):
        i = kernels.fps_plain(pc, n)
        np.testing.assert_array_equal(i.numpy(), np.asarray(w))
        pc = gather(pc, i)


@pytest.mark.parametrize("B,N,levels", [(2, 256, (64, 32, 16, 8)), (3, 300, (100, 100, 7, 1))])
def test_fps_pyramid_twin_matches_pallas(B, N, levels):
    """The pyramid kernel's twin, level for level (equal levels and a one-point
    level included), against the one-launch Pallas pyramid."""
    xyz = _x(np.random.default_rng(10), B, N, 3)
    got = kernels.fps_pyramid_plain(t(xyz), levels)
    want = farthest_point_sample_pyramid_pallas(jnp.asarray(xyz), levels, interpret=True)
    assert len(got) == len(levels)
    for g, w, n in zip(got, want, levels):
        assert g.shape == (B, n) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_attention_twin_matches_pallas():
    rng = np.random.default_rng(2)
    q, k, v = _x(rng, 3, 40, 8), _x(rng, 3, 200, 8), _x(rng, 3, 200, 8)
    got = kernels.attention_plain(t(q), t(k), t(v), 8 ** -0.5)
    want = fused_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  8 ** -0.5, interpret=True)
    assert_close(got, want)


def test_cross_tail_twin_matches_pallas():
    rng = np.random.default_rng(3)
    G, M, N, K, C, C2 = 2, 80, 64, 4, 8, 16
    tab, base = _x(rng, G, M, C), _x(rng, G, N, C)
    w, b = _x(rng, C, C2, scale=0.2), _x(rng, C2, scale=0.1)
    idx = rng.integers(0, M, size=(G, N, K)).astype(np.int32)
    got = kernels.cross_tail_plain(t(tab), t(idx), t(base), t(w), t(b))
    rows = gather(t(tab), t(idx.transpose(0, 2, 1).reshape(G, -1))).numpy()   # k-major
    want = jax_cross_tail(jnp.asarray(rows), jnp.asarray(base), jnp.asarray(w),
                          jnp.asarray(b), K, True)
    assert_close(got, want)


def test_transformer_tail_twin_matches_pallas():
    rng = np.random.default_rng(4)
    G, M, N, K, D = 2, 80, 64, 4, 8
    table, xq, q = _x(rng, G, M, 3 + 2 * D), _x(rng, G, N, 3), _x(rng, G, N, D)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [_x(rng, ci, co, scale=0.2), _x(rng, co, scale=0.1)]
    idx = rng.integers(0, M, size=(G, N, K)).astype(np.int32)
    got = kernels.transformer_tail_plain(t(table), t(idx), t(xq), t(q), *map(t, ws))
    rows = gather(t(table), t(idx.transpose(0, 2, 1).reshape(G, -1))).numpy()
    want = jax_tt(jnp.asarray(rows), jnp.asarray(xq), jnp.asarray(q),
                  *map(jnp.asarray, ws), K, True)
    assert_close(got, want)


def test_fusion_pair_twin_matches_pallas():
    rng = np.random.default_rng(5)
    G, N2, N, K2 = 2, 128, 128, 4
    p2, p1 = _x(rng, G, N2, 3, scale=4.0), _x(rng, G, N, 3, scale=4.0)
    idx = rng.integers(0, N2, size=(G, N, K2)).astype(np.int32)
    folded_np = []
    for ci, co in [(4, 64), (64, 64), (64, 128)]:
        w, b = _x(rng, ci, co, scale=ci ** -0.5), _x(rng, co, scale=0.1)
        scale, bn_bias = 1.0 + _x(rng, co, scale=0.1), _x(rng, co, scale=0.1)
        mean, var = _x(rng, co, scale=0.1), rng.uniform(0.5, 1.5, co).astype(np.float32)
        folded_np += [np.asarray(a) for a in jax_fold(w, b, scale, bn_bias, mean, var, 1e-3)]
        pw, pb = kernels.fold_bn_dense(*map(t, (w, b, scale, bn_bias, mean, var)), 1e-3)
        assert_close(pw, folded_np[-2])
        assert_close(pb, folded_np[-1])
    planes, logits = kernels.fusion_pair_plain(t(p2), t(idx), t(p1), *map(t, folded_np))
    idx_km = jnp.asarray(idx.transpose(0, 2, 1).reshape(G, -1))
    want_planes = bucket_gather_pair_planes(jnp.asarray(p2), idx_km,
                                            jnp.asarray(p1.transpose(0, 2, 1)), True)
    assert_close(planes, want_planes)
    want = fusion_head_pallas(want_planes, *map(jnp.asarray, folded_np), interpret=True)
    assert_close(logits, want)


@pytest.mark.parametrize("case", ["one_tile", "fold", "duplicates", "cosine"])
def test_knn_approx_twin_matches_pallas(case):
    """M <= tr (no fold), M > 1024 (fold, ragged last tile), duplicated
    reference points, and the cosine metric at C = 32."""
    rng = np.random.default_rng(6)
    B, N, M, C, k, metric = {
        "one_tile": (2, 70, 300, 3, 9, "euclidean"),
        "fold": (1, 64, 1500, 3, 8, "euclidean"),
        "duplicates": (2, 48, 256, 3, 12, "euclidean"),
        "cosine": (2, 40, 200, 32, 8, "cosine"),
    }[case]
    q, r = _x(rng, B, N, C, scale=4.0), _x(rng, B, M, C, scale=4.0)
    if case == "duplicates":
        r[:, M // 2:] = r[:, :M // 2]          # every point twice
        q[:, :8] = r[:, 3:11]                  # queries on reference points
    q, r = t(q), t(r)
    if metric == "cosine":
        q, r = _normalise(q), _normalise(r)
    got = kernels.knn_approx_plain(q, r, k, metric).numpy()
    want = np.asarray(fused_knn_pallas(jnp.asarray(q.numpy()), jnp.asarray(r.numpy()), k,
                                       metric, interpret=True))
    assert got.dtype == np.int32 and got.shape == (B, N, k)
    if metric == "euclidean":
        np.testing.assert_array_equal(got, want)
        return
    # cosine: a swap is allowed only where the two distances agree to float rounding
    d = kernels.knn.distances(q.double(), r.double(), "cosine").numpy()
    dg = np.take_along_axis(d, got.astype(np.int64), 2)
    dw = np.take_along_axis(d, want.astype(np.int64), 2)
    assert (got == want).mean() > 0.98
    np.testing.assert_allclose(dg, dw, atol=1e-6, rtol=0)


@pytest.mark.parametrize("G,N,M", [(3, 64, 64), (3, 128, 256)])
def test_chamfer_pair_twin_matches_pallas(G, N, M):
    rng = np.random.default_rng(7)
    p1, p2 = _x(rng, G, N, 3, scale=5.0), _x(rng, G, M, 3, scale=5.0)
    k12, k21 = kernels.chamfer_pair_keys_plain(t(p1), t(p2))
    w12, w21 = _pair_keys(jnp.asarray(p1), jnp.asarray(p2.transpose(0, 2, 1)), True)
    np.testing.assert_array_equal(k12.numpy(), np.asarray(w12))
    np.testing.assert_array_equal(k21.numpy(), np.asarray(w21))
    d12, d21 = kernels.chamfer_pair(t(p1), t(p2))
    j12, j21 = jax_chamfer_pair(jnp.asarray(p1), jnp.asarray(p2), True)
    assert_close(d12, j12, atol=1e-6, rtol=1e-6)
    assert_close(d21, j21, atol=1e-6, rtol=1e-6)
