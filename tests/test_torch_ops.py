"""Port ops held against the JAX package on the CPU: kNN, FPS, gathers, 3-NN
interpolation, Chamfer and EMD.  kNN and FPS indices must be exactly equal."""
import numpy as np
import pytest

from mocopci_tpu import ops as jops
from mocopci_torch import ops
from tests.torch_parity import assert_close, exact_knn, t  # noqa: F401  (fixture)


def _cloud(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("B,N,M,k", [(2, 96, 80, 16), (1, 40, 5, 8), (1, 16, 3072, 32)])
def test_knn_euclidean_indices_equal(B, N, M, k):
    rng = np.random.default_rng(1)
    ref, query = _cloud(rng, B, M, 3), _cloud(rng, B, N, 3)
    got = ops.knn(k, t(ref), t(query)).numpy()
    want = np.asarray(jops.knn(k, ref, query))
    assert got.dtype == np.int32 and got.shape == (B, N, min(k, M))
    np.testing.assert_array_equal(got, want)


def test_knn_cosine_indices_equal():
    rng = np.random.default_rng(2)
    ref, query = _cloud(rng, 2, 70, 32), _cloud(rng, 2, 50, 32)
    got = ops.knn_cosine(8, t(ref), t(query)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.knn_cosine(8, ref, query)))


def test_knn_ties_go_to_the_lowest_index():
    rng = np.random.default_rng(3)
    # integer grid points: exact distances, many duplicates and equal distances
    ref = rng.integers(0, 3, size=(1, 60, 3)).astype(np.float32)
    query = rng.integers(0, 3, size=(1, 20, 3)).astype(np.float32)
    got = ops.knn(12, t(ref), t(query)).numpy()
    d = ((query[0, :, None] - ref[0, None]) ** 2).sum(-1)
    cols = np.broadcast_to(np.arange(60), d.shape)
    want = np.stack([np.lexsort((c, r))[:12] for r, c in zip(d, cols)])
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got, np.asarray(jops.knn(12, ref, query)))


def test_distances_match_jax():
    rng = np.random.default_rng(4)
    a, b = _cloud(rng, 2, 30, 8), _cloud(rng, 2, 20, 8)
    assert_close(ops.square_distance(t(a), t(b)), jops.square_distance(a, b))
    assert_close(ops.cosine_distance(t(a), t(b)), jops.cosine_distance(a, b))


def test_fps_indices_equal():
    rng = np.random.default_rng(5)
    xyz = _cloud(rng, 2, 200, 3)
    got = ops.farthest_point_sample(t(xyz), 50).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.farthest_point_sample(xyz, 50)))


def test_fps_pyramid_indices_equal():
    rng = np.random.default_rng(6)
    xyz = _cloud(rng, 2, 256, 3)
    levels = (64, 32, 16, 8)
    got = ops.farthest_point_sample_pyramid(t(xyz), levels)
    want = jops.farthest_point_sample_pyramid(xyz, levels)
    assert len(got) == 4
    for g, w, n in zip(got, want, levels):
        assert g.shape == (2, n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fps_ties_go_to_the_lowest_index():
    rng = np.random.default_rng(7)
    half = _cloud(rng, 1, 64, 3)
    xyz = np.concatenate([half, half], axis=1)          # every point twice
    got = ops.farthest_point_sample(t(xyz), 64).numpy()
    assert (got < 64).all(), "a duplicate beat its lower-index twin"
    np.testing.assert_array_equal(got, np.asarray(jops.farthest_point_sample(xyz, 64)))


def test_gathers_match_jax():
    rng = np.random.default_rng(8)
    pts = _cloud(rng, 2, 30, 5)
    feat = _cloud(rng, 2, 30, 2)
    idx = rng.integers(0, 30, size=(2, 12, 4)).astype(np.int32)
    np.testing.assert_array_equal(ops.gather(t(pts), t(idx[:, :, 0])).numpy(),
                                  np.asarray(jops.gather(pts, idx[:, :, 0])))
    np.testing.assert_array_equal(ops.group(t(pts), t(idx)).numpy(),
                                  np.asarray(jops.group(pts, idx)))
    for g, w in zip(ops.group_multi(t(idx), t(pts), t(feat)),
                    jops.group_multi(idx, pts, feat)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_interpolation_matches_jax():
    rng = np.random.default_rng(9)
    dense, sparse = _cloud(rng, 2, 64, 3), _cloud(rng, 2, 16, 3)
    f1, f2 = _cloud(rng, 2, 16, 6), _cloud(rng, 2, 16, 9)
    assert_close(ops.upsample(t(dense), t(sparse), t(f1)), jops.upsample(dense, sparse, f1))
    for g, w in zip(ops.upsample_multi(t(dense), t(sparse), [t(f1), t(f2)]),
                    jops.upsample_multi(dense, sparse, [f1, f2])):
        assert_close(g, w)
    assert_close(ops.three_interpolate(t(dense), t(sparse), t(f1)),
                 jops.three_interpolate(dense, sparse, f1))
    d, i = ops.three_nn(t(dense), t(sparse))
    jd, ji = jops.three_nn(dense, sparse)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert_close(d, jd)
    flow = 0.1 * _cloud(rng, 2, 16, 3)
    x2 = _cloud(rng, 2, 24, 3)
    assert_close(ops.point_warp(t(sparse), t(x2), t(flow)), jops.point_warp(sparse, x2, flow))


@pytest.mark.parametrize("n", [128, 64])
def test_chamfer_per_sample_matches_jax(n):
    """n = 128 takes the chamfer_pair route, n = 64 the two directed 1-NN
    queries; JAX on the CPU takes its dense path.  rtol 3e-3: the packed keys
    may pick a marginally farther neighbour among near ties."""
    from mocopci_torch.kernels.chamfer_pair import supported

    assert supported(n, n) == (n == 128)
    rng = np.random.default_rng(10)
    a = 5.0 * _cloud(rng, 3, n, 3)
    b = (a + 0.3 * _cloud(rng, 3, n, 3)).astype(np.float32)
    got = ops.chamfer_distance_per_sample(t(a), t(b))
    want = np.asarray(jops.chamfer_distance_per_sample(a, b))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-3)
    np.testing.assert_allclose(float(ops.chamfer_distance(t(a), t(b))), want.mean(), rtol=3e-3)
    many = ops.chamfer_many([(t(a[:1]), t(b[:1])), (t(a[1:2]), t(b[1:2]))])
    np.testing.assert_allclose(many.numpy(), want[:2], rtol=3e-3)
    np.testing.assert_allclose(float(ops.chamfer_distance_blocked(t(a), t(b), 32)),
                               float(jops.chamfer_distance_blocked(a, b, 32)), rtol=1e-5)


@pytest.mark.parametrize("n,m", [(60, 48), (40, 96)])
def test_emd_dense_and_blocked_match_jax(n, m):
    """n != m exercises the integer-division capacity init on both sides."""
    rng = np.random.default_rng(11)
    a, b = 2.0 * _cloud(rng, 2, n, 3), 2.0 * _cloud(rng, 2, m, 3)
    want = np.asarray(jops.earth_mover_distance(a, b))
    np.testing.assert_allclose(ops.earth_mover_distance(t(a), t(b)).numpy(), want, rtol=1e-4)
    assert_close(ops.approx_match(t(a), t(b)), jops.approx_match(a, b), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(ops.earth_mover_distance_blocked(t(a), t(b)).numpy(),
                               np.asarray(jops.earth_mover_distance_blocked(a, b)), rtol=1e-4)
    np.testing.assert_allclose(float(ops.emd(t(a), t(b))), float(jops.emd(a, b)), rtol=1e-4)
