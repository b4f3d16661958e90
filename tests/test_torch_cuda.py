"""Card-only checks: each CUDA kernel against its plain twin on the GPU, at
small shapes, and a small model forward on the card against the CPU.

Skipped without a CUDA device.  This file imports no JAX, so on a machine
with a card and no JAX it runs without the repository conftest:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

from mocopci_torch import (MoCoPCI, interpolate, kernels, ops, stress_model_config,
                           tiny_model_config)
from mocopci_torch.kernels.knn_approx import tiling
from mocopci_torch.ops import distance
from mocopci_torch.ops.distance import _normalise
from mocopci_torch.training import eval_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def test_fps_kernel_equals_twin(card):
    g = torch.Generator().manual_seed(0)
    xyz = _x(g, 2, 3000, 3, scale=10.0).to(card)
    np.testing.assert_array_equal(kernels.fps(xyz, 500).cpu().numpy(),
                                  kernels.fps_plain(xyz, 500).cpu().numpy())


@pytest.mark.parametrize("B,N,npoint,dup", [(2, 4096, 1024, False), (6, 8192, 2048, False),
                                            (3, 1, 1, False), (2, 700, 700, False),
                                            (2, 1000, 600, True)])
def test_fps_kernel_equals_twin_at_the_edges(card, B, N, npoint, dup):
    """A cloud whose planes take exactly 48 KB of shared memory (first, before
    a larger cloud has raised the kernel's limit in this process), the train
    step's (6, 8192) -> 2048, a one-point cloud, every point sampled, and a
    cloud of duplicate points, where a tie must go to the lowest index (the
    duplicates sit in the upper half)."""
    g = torch.Generator().manual_seed(20)
    xyz = _x(g, B, N, 3, scale=10.0)
    if dup:
        xyz[:, N // 2:] = xyz[:, :N - N // 2]
    xyz = xyz.to(card)
    got = kernels.fps(xyz, npoint).cpu()
    np.testing.assert_array_equal(got.numpy(), kernels.fps_plain(xyz, npoint).cpu().numpy())
    if dup:
        assert (got < N // 2).all()


@pytest.mark.parametrize("B,N,levels", [(2, 8192, (2048, 512, 256, 64)),
                                        (7, 3000, (1000, 100, 10, 1))])
def test_fps_pyramid_kernel_equals_twin(card, B, N, levels):
    g = torch.Generator().manual_seed(21)
    xyz = _x(g, B, N, 3, scale=10.0).to(card)
    kernels.reset_launches()
    got = kernels.fps_pyramid(xyz, levels)
    assert kernels.LAUNCHES["fps_pyramid"] == 1 and kernels.LAUNCHES["fps"] == 0
    want = kernels.fps_pyramid_plain(xyz, levels)
    for a, w, n in zip(got, want, levels):
        assert a.shape == (B, n) and a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), w.cpu().numpy())


def _fps_over(xyz, npoint, c):
    """The ``fps_cluster`` entry at a cluster of ``c`` blocks."""
    from mocopci_torch.kernels import _lib
    out = torch.empty((xyz.shape[0], npoint), dtype=torch.int32, device=xyz.device)
    _lib.launch("fps_cluster", xyz.data_ptr(), xyz.shape[0], xyz.shape[1], npoint, c,
                out.data_ptr(), _lib.stream(xyz))
    return out


def _fps_pyramid_over(xyz, levels, c):
    """The ``fps_pyramid_cluster`` entry at a cluster of ``c`` blocks."""
    from mocopci_torch.kernels import _lib
    B = xyz.shape[0]
    out = torch.empty(B * sum(levels), dtype=torch.int32, device=xyz.device)
    lv = torch.tensor(levels, dtype=torch.int32)
    _lib.launch("fps_pyramid_cluster", xyz.data_ptr(), B, xyz.shape[1], lv.data_ptr(),
                len(levels), c, out.data_ptr(), _lib.stream(xyz))
    return tuple(part.view(B, n) for part, n in zip(out.split([B * n for n in levels]), levels))


def _cluster_sizes(N):
    """Of the cluster sizes timed (2, 4 and 8), those whose blocks hold N
    points."""
    fps_mod = importlib.import_module("mocopci_torch.kernels.fps")
    return [c for c in (2, 4, 8) if -(-N // c) <= fps_mod.BLOCK_MAX_N]


def _dup_cloud(g, B, N, dup):
    """(B, N, 3) on the CPU; with ``dup`` the upper half repeats the lower
    half, so every tie spans two blocks' spans and must go to the lower
    index."""
    xyz = _x(g, B, N, 3, scale=10.0)
    if dup:
        xyz[:, N // 2:] = xyz[:, :N - N // 2].clone()
    return xyz


@pytest.mark.parametrize("B,N,npoint,dup", [(2, 8193, 2048, False), (2, 12288, 12288, False),
                                            (3, 16384, 4096, False), (2, 20000, 5000, True),
                                            (3, 32768, 8192, False), (2, 32768, 4096, True),
                                            (2, 32768, 8192, True), (2, 32767, 8191, False),
                                            (1, 65536, 2048, False)])
def test_fps_cluster_kernel_equals_twin(card, B, N, npoint, dup):
    """Above 8192 points, level 0 over a cluster: one ``fps_cluster`` launch
    at the chosen size, then the entry at every size that holds the cloud
    (2, 4, 8), each launched 3 times and each launch bit-equal to the plain
    version (a slot read before its mbarrier completes shows only as a rare
    mismatch); every point sampled at 12288, the cap (65536: 8 blocks of
    8192 points), N not a multiple of the size (20000, 32767), and clouds
    whose upper half repeats the lower half."""
    g = torch.Generator().manual_seed(22)
    xyz = _dup_cloud(g, B, N, dup).to(card)
    want = kernels.fps_plain(xyz, npoint)
    kernels.reset_launches()
    got = kernels.fps(xyz, npoint)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"fps_cluster": 1}
    assert torch.equal(got, want)
    for c in _cluster_sizes(N):
        for rep in range(3):
            assert torch.equal(_fps_over(xyz, npoint, c), want), (c, rep)
    if dup:
        assert (got < N // 2).all()


@pytest.mark.parametrize("N,dup", [(16384, False), (32768, False), (32768, True),
                                   (20000, True), (32767, False)])
def test_fps_pyramid_cluster_kernel_equals_twin(card, N, dup):
    """The encoder's pyramid at the stress ratios (n/4, n/16, n/32, n/128) in
    one launch, level 0 over a cluster and the later levels on its first
    block, at the chosen cluster size and through the entry at every size
    that holds the cloud, 3 launches each."""
    g = torch.Generator().manual_seed(23)
    xyz = _dup_cloud(g, 2, N, dup).to(card)
    levels = (N // 4, N // 16, N // 32, N // 128)
    want = kernels.fps_pyramid_plain(xyz, levels)
    kernels.reset_launches()
    got = kernels.fps_pyramid(xyz, levels)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"fps_pyramid_cluster": 1}
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    for c in _cluster_sizes(N):
        for rep in range(3):
            assert all(torch.equal(a, w) for a, w in zip(_fps_pyramid_over(xyz, levels, c),
                                                         want)), (c, rep)


def test_knn_kernels_at_the_stress_shapes(card):
    """knn_approx at (2, 32768, 32768, 3) k=32 (tr 1024, 15 index bits, the
    fold) and exact knn at (2, 16384, 16384, 3) k=32, each bit-equal to its
    plain version."""
    g = torch.Generator().manual_seed(24)
    p = _x(g, 2, 32768, 3, scale=10.0).to(card)
    q = (p + 0.05 * _x(g, 2, 32768, 3).to(card)).contiguous()
    assert tiling(32768, 32) == (1024, 15, True)
    assert torch.equal(kernels.knn_approx(q, p, 32, "euclidean"),
                       kernels.knn_approx_plain(q, p, 32, "euclidean"))
    q, p = q[:, :16384].contiguous(), p[:, :16384].contiguous()
    assert torch.equal(kernels.knn_exact(q, p, 32, "euclidean"),
                       kernels.knn_plain(q, p, 32, "euclidean"))


def test_stress_forward_on_card_launches_the_cluster_routes(card):
    """stress_model_config(16384), B=1, approx mode: the encoder's pyramid and
    the refine head's FPS each one cluster launch, every eval kernel
    launched, the output finite."""
    cfg = stress_model_config(16384)
    rng = np.random.default_rng(0)
    x1 = (rng.normal(size=(1, cfg.npoints, 3)) * 10).astype(np.float32)
    x2 = (x1 + 0.1 * rng.normal(size=x1.shape)).astype(np.float32)
    saved = distance.get_knn_mode()
    distance.set_knn_mode("approx")
    try:
        model = MoCoPCI(cfg, device="cuda")
        kernels.reset_launches()
        got = interpolate(model, x1, x2)
        torch.cuda.synchronize()
    finally:
        distance.set_knn_mode(saved)
    launched = {name: n for name, n in kernels.LAUNCHES.items() if n > 0}
    assert launched["fps_pyramid_cluster"] == 1 and launched["fps_cluster"] == 1, launched
    assert set(launched) == (FORWARD_KERNELS["approx"] - {"fps", "fps_pyramid"}) | {
        "fps_cluster", "fps_pyramid_cluster"}, launched
    assert got.shape == (1, 3, cfg.npoints, 3) and torch.isfinite(got).all()


@pytest.mark.parametrize("metric,C,k", [("euclidean", 3, 32), ("euclidean", 3, 3),
                                        ("cosine", 64, 16), ("euclidean", 20, 8)])
def test_knn_kernel_matches_twin(card, metric, C, k):
    g = torch.Generator().manual_seed(1)
    q, r = _x(g, 2, 500, C).to(card), _x(g, 2, 1500, C).to(card)
    if metric == "cosine":
        q, r = _normalise(q).contiguous(), _normalise(r).contiguous()
    got = kernels.knn_exact(q, r, k, metric)
    want = kernels.knn_plain(q, r, k, metric)
    # index swaps are allowed only between equally distant neighbours
    d = kernels.knn.distances(q.double(), r.double(), metric)
    dg, dw = d.gather(2, got.long()), d.gather(2, want.long())
    assert torch.allclose(dg, dw, atol=1e-5, rtol=1e-5)
    assert (got == want).float().mean() > 0.999


@pytest.mark.parametrize("k", [1, 3, 16, 32])
@pytest.mark.parametrize("M", [1500, 8192, 20000])
def test_knn_xyz_kernel_equals_twin(card, M, k):
    """The filtered scan (Euclidean, C = 3): indices equal to the plain
    version's, on a ragged number of queries, the whole cloud staged (1500,
    8192) and streamed past the planes (20000), in one launch."""
    g = torch.Generator().manual_seed(30 + k)
    q, r = _x(g, 2, 301, 3, scale=10.0).to(card), _x(g, 2, M, 3, scale=10.0).to(card)
    kernels.reset_launches()
    got = kernels.knn_exact(q, r, k, "euclidean")
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"knn": 1}
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  kernels.knn_plain(q, r, k, "euclidean").cpu().numpy())


@pytest.mark.parametrize("metric,B,N,M,C,k", [("cosine", 1, 2048, 2048, 64, 16),
                                              ("cosine", 1, 256, 256, 256, 16),
                                              ("euclidean", 2, 300, 1000, 20, 32)])
def test_knn_dot_form_splits_keep_the_result(card, monkeypatch, metric, B, N, M, C, k):
    """The dot form over reference spans, merged, returns what one span
    returns: each pair's distance is the same whatever the split."""
    knn_mod = importlib.import_module("mocopci_torch.kernels.knn")
    g = torch.Generator().manual_seed(32)
    q, r = _x(g, B, N, C).to(card), _x(g, B, M, C).to(card)
    if metric == "cosine":
        q, r = _normalise(q).contiguous(), _normalise(r).contiguous()
    split = kernels.knn_exact(q, r, k, metric)
    assert knn_mod.launch_grid(B, N, M, C, metric)[1] > 1
    monkeypatch.setattr(knn_mod, "launch_grid", lambda *a: (-(-M // 32) * 32, 1, 0))
    assert torch.equal(split, kernels.knn_exact(q, r, k, metric))


@pytest.mark.parametrize("M,C", [(3000, 3), (20000, 3), (3000, 5)])
def test_knn_kernel_takes_the_overflow_route_on_duplicates(card, M, C):
    """200 copies of one point and exact ties: a query at that point has more
    candidates than the buffer holds and takes the overflow route, counted;
    the indices stay equal to the plain version's (ties to the lowest index)."""
    knn_mod = importlib.import_module("mocopci_torch.kernels.knn")
    g = torch.Generator().manual_seed(31)
    r = torch.round(_x(g, 2, M, C, scale=10.0))       # integer grid: many exact ties
    r[:, 1000:1200] = r[:, 500:501]
    q = torch.cat([r[:, 490:510], _x(g, 2, 77, C, scale=10.0)], dim=1)
    q, r = q.to(card).contiguous(), r.to(card).contiguous()
    knn_mod.reset_overflows()
    got = kernels.knn_exact(q, r, 32, "euclidean")
    assert knn_mod.overflows() >= 2          # the copied point, in each cloud
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  kernels.knn_plain(q, r, 32, "euclidean").cpu().numpy())


@pytest.mark.parametrize("G,N,M,D", [
    (6, 100, 300, 8),
    (2, 33, 64, 256),      # the wide route
    (3, 40, 4096, 16),     # M = 4096, the TPU kernel's MAX_SEQ
    (2, 100, 4160, 8),     # past it
    (1, 64, 8192, 8),      # the 32768-point forward's L1 keys
    (3, 333, 517, 32),     # N, M not multiples of the query tile or key tile
    (2, 129, 70, 64),
    (2, 129, 70, 6),       # D % 4 != 0, padded to 8
    (2, 150, 333, 12),     # padded to 16
    (2, 100, 77, 70),      # the wide route, D not a multiple of 8
    (1, 1, 300, 8),        # one query
    (4, 50, 1, 16),        # one key
    (1, 1, 1, 256),
    (8, 256, 256, 32),     # a grid smaller than the SM count: two key splits
    (8, 512, 512, 16),
    (8, 2048, 2048, 8),
    (8, 256, 256, 256),    # the eval forward's wide call
    (1, 100, 4096, 256),   # the wide route at M = 4096
    (1, 40, 4160, 256),    # and past it
    (1, 40, 50, 512),      # more head dims than a block holds: two slices
])
def test_attention_kernel_matches_twin(card, G, N, M, D):
    """Each route against the plain version (one pass up to D = 64, the wide
    route above), the route counted and its bits repeated."""
    from mocopci_torch.kernels.attention import route

    g = torch.Generator().manual_seed(2)
    q, k, v = (_x(g, G, L, D).to(card) for L in (N, M, M))
    kernels.reset_launches()
    got = kernels.attention(q, k, v, D ** -0.5)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {route(D): 1}, kernels.LAUNCHES
    torch.testing.assert_close(got, kernels.attention_plain(q, k, v, D ** -0.5),
                               atol=1e-5, rtol=1e-4)
    assert _bits_equal(got, kernels.attention(q, k, v, D ** -0.5))


@pytest.mark.parametrize("N", [301, 1])
@pytest.mark.parametrize("K", [4, 32, 300])
@pytest.mark.parametrize("C,C2", [(64, 64), (32, 96), (8, 16), (6, 20)])
def test_cross_tail_kernel_matches_twin(card, N, K, C, C2):
    """The forward against the plain version over ragged units (N = 301 at
    B = 2: units of whole queries cross the batch), K = 4 (units of 16
    queries, half the rows padding), 32 (the model's) and 300 (a query in
    chunks of 128 rows, an int32 argmax), several passes of 64 channels (C2
    = 96), the 4-byte gather (C = 6) and one query; the instance with the
    argmax returns the same bits and an argmax in range."""
    from mocopci_torch.kernels.cross_tail import argmax_dtype, cross_tail_fwd

    g = torch.Generator().manual_seed(3)
    tab, base = _x(g, 2, 700, C).to(card), _x(g, 2, N, C).to(card)
    w, b = _x(g, C, C2, scale=C ** -0.5).to(card), _x(g, C2, scale=0.1).to(card)
    idx = torch.randint(0, 700, (2, N, K), generator=g, dtype=torch.int32).to(card)
    kernels.reset_launches()
    got = kernels.cross_tail(tab, idx, base, w, b)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"cross_tail": 1}
    torch.testing.assert_close(got, kernels.cross_tail_plain(tab, idx, base, w, b),
                               atol=1e-4, rtol=1e-4)
    amax = torch.empty((2, N, C2), dtype=argmax_dtype(K), device=card)
    assert _bits_equal(cross_tail_fwd(tab, idx, base, w, b, amax), got)
    assert int(amax.min()) >= 0 and int(amax.max()) < K


@pytest.mark.parametrize("N,K,C,C2", [(300, 32, 64, 64), (301, 32, 32, 96), (50, 300, 8, 16)])
def test_cross_tail_argmax_matches_twin(card, N, K, C, C2):
    """The forward's argmax (one byte for K <= 255, else int32) against the
    twin's first argmax: where the indices differ, the two pre-max values
    must agree within 1e-5 (a near tie summed in another order)."""
    from mocopci_torch.kernels.cross_tail import (
        _tail_pre,
        argmax_dtype,
        cross_tail_argmax_plain,
        cross_tail_fwd,
    )

    g = torch.Generator().manual_seed(22)
    tab, base = _x(g, 2, 700, C).to(card), _x(g, 2, N, C).to(card)
    w, b = _x(g, C, C2, scale=C ** -0.5).to(card), _x(g, C2, scale=0.1).to(card)
    idx = torch.randint(0, 700, (2, N, K), generator=g, dtype=torch.int32)
    idx[:, :, 1] = idx[:, :, 0]
    idx = idx.to(card)
    amax = torch.empty((2, N, C2), dtype=argmax_dtype(K), device=card)
    out = cross_tail_fwd(tab, idx, base, w, b, amax)
    torch.testing.assert_close(out, cross_tail_fwd(tab, idx, base, w, b), atol=0, rtol=0)
    want = cross_tail_argmax_plain(tab, idx, base, w, b)
    assert amax.dtype == want.dtype and int(amax.max()) < K
    h = _tail_pre(kernels._lib.group_rows(tab, idx), base, w, b)
    hg, hw = h.gather(2, amax.long()[:, :, None]), h.gather(2, want.long()[:, :, None])
    torch.testing.assert_close(hg, hw, atol=1e-5, rtol=0)
    torch.testing.assert_close(hg[:, :, 0], out, atol=1e-5, rtol=1e-5)
    assert (amax == want).float().mean() > 0.99


def _cross_tail_inputs(g, card, B, N, K, C, C2, M=700):
    tab, base = _x(g, B, M, C).to(card), _x(g, B, N, C).to(card)
    w, b = _x(g, C, C2, scale=C ** -0.5).to(card), _x(g, C2, scale=0.1).to(card)
    idx = torch.randint(0, M, (B, N, K), generator=g, dtype=torch.int32)
    idx[:, :, 1] = idx[:, :, 0]                  # a duplicate neighbour: exact ties
    return tab, idx.to(card), base, w, b


@pytest.mark.parametrize("B,N,K,C,C2", [(1, 1024, 32, 256, 256),   # cross3 at 32768 points
                                        (2, 301, 30, 192, 64),     # K padded to 8, ragged
                                        (2, 37, 5, 256, 300)])     # more channels than threads
def test_cross_tail_wide_route_matches_twin(card, B, N, K, C, C2):
    """Past the tiled forward's shared memory, one ``cross_tail_wide``
    launch: within 1e-4 of the plain version; the instance with the argmax
    returns the same bits and, where its first j differs from the twin's,
    the two pre-max values agree within 1e-5."""
    from mocopci_torch.kernels.cross_tail import (
        _tail_pre,
        argmax_dtype,
        cross_tail_argmax_plain,
        cross_tail_fwd,
        fwd_route,
    )

    assert fwd_route(K, C, C2) == "cross_tail_wide"
    g = torch.Generator().manual_seed(25)
    tab, idx, base, w, b = _cross_tail_inputs(g, card, B, N, K, C, C2)
    kernels.reset_launches()
    got = kernels.cross_tail(tab, idx, base, w, b)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"cross_tail_wide": 1}
    torch.testing.assert_close(got, kernels.cross_tail_plain(tab, idx, base, w, b),
                               atol=1e-4, rtol=1e-4)
    amax = torch.empty((B, N, C2), dtype=argmax_dtype(K), device=card)
    assert _bits_equal(cross_tail_fwd(tab, idx, base, w, b, amax), got)
    want = cross_tail_argmax_plain(tab, idx, base, w, b)
    h = _tail_pre(kernels._lib.group_rows(tab, idx), base, w, b)
    hg, hw = h.gather(2, amax.long()[:, :, None]), h.gather(2, want.long()[:, :, None])
    torch.testing.assert_close(hg, hw, atol=1e-5, rtol=0)
    assert (amax == want).float().mean() > 0.99


@pytest.mark.parametrize("B,N,K,C,C2", [(2, 301, 32, 64, 64), (2, 50, 300, 8, 16),
                                        (2, 301, 4, 32, 96), (2, 101, 13, 30, 40)])
def test_cross_tail_wide_route_repeats_the_tiled_bits(card, monkeypatch, B, N, K, C, C2):
    """The wide route runs the tiled kernel's chains: where both fit, its
    output and argmax are bit-equal to the tiled kernel's (also with C not a
    multiple of 4, where its last channels run one at a time)."""
    ct = importlib.import_module("mocopci_torch.kernels.cross_tail")
    g = torch.Generator().manual_seed(26)
    tab, idx, base, w, b = _cross_tail_inputs(g, card, B, N, K, C, C2)
    outs = []
    for route in ("cross_tail", "cross_tail_wide"):
        monkeypatch.setattr(ct, "fwd_route", lambda *a, r=route: r)
        amax = torch.empty((B, N, C2), dtype=ct.argmax_dtype(K), device=card)
        kernels.reset_launches()
        outs.append((ct.cross_tail_fwd(tab, idx, base, w, b, amax), amax))
        assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {route: 1}
    (o1, a1), (o2, a2) = outs
    assert _bits_equal(o1, o2) and torch.equal(a1, a2)


@pytest.mark.parametrize("kernel", ["chamfer_pair", "fusion_pair", "cross_tail",
                                    "transformer_tail"])
def test_eval_kernels_at_the_stress_shapes(card, kernel):
    """The eval kernels at the calls of stress_model_config(32768) against
    their plain versions, with the tolerances of their own card tests: the
    Chamfer keys of eval_step's (3, 32768)² bit-equal, the fusion head at
    (3, 32768, 64) pairs, the cost-volume tail at L1's (3, 8192, 32), the
    transformer tail at the refine head's (3, 8192, 16)."""
    g = torch.Generator().manual_seed(27)
    kernels.reset_launches()
    if kernel == "chamfer_pair":
        p1, p2 = _x(g, 3, 32768, 3, scale=5.0).to(card), _x(g, 3, 32768, 3, scale=5.0).to(card)
        got, want = kernels.chamfer_pair_keys(p1, p2), kernels.chamfer_pair_keys_plain(p1, p2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    elif kernel == "fusion_pair":
        p2, p1 = _x(g, 3, 32768, 3, scale=5.0).to(card), _x(g, 3, 32768, 3, scale=5.0).to(card)
        idx = torch.randint(0, 32768, (3, 32768, 64), generator=g, dtype=torch.int32).to(card)
        ws = []
        for ci, co in [(4, 64), (64, 64), (64, 128)]:
            ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
        planes, logits = kernels.fusion_pair(p2, idx, p1, *ws)
        want_planes, want_logits = kernels.fusion_pair_plain(p2, idx, p1, *ws)
        torch.testing.assert_close(planes, want_planes, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(logits, want_logits, atol=1e-4, rtol=1e-4)
    elif kernel == "cross_tail":
        tab, idx, base, w, b = _cross_tail_inputs(g, card, 3, 8192, 32, 64, 64, M=8192)
        torch.testing.assert_close(kernels.cross_tail(tab, idx, base, w, b),
                                   kernels.cross_tail_plain(tab, idx, base, w, b),
                                   atol=1e-4, rtol=1e-4)
    else:
        D = 64
        table = _x(g, 3, 8192, 3 + 2 * D).to(card)
        xq, q = _x(g, 3, 8192, 3).to(card), _x(g, 3, 8192, D).to(card)
        ws = []
        for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
            ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
        idx = torch.randint(0, 8192, (3, 8192, 16), generator=g, dtype=torch.int32).to(card)
        torch.testing.assert_close(kernels.transformer_tail(table, idx, xq, q, *ws),
                                   kernels.transformer_tail_plain(table, idx, xq, q, *ws),
                                   atol=1e-4, rtol=1e-4)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {kernel: 1}


@pytest.mark.parametrize("N,K,D", [(300, 16, 64), (301, 4, 64), (2048, 16, 64), (300, 8, 64),
                                   (300, 16, 32)])
def test_transformer_tail_kernel_matches_twin(card, N, K, D):
    """On the tiled route at the refine head's K = 16 (8 queries a tile) and
    the tiny configs' K = 4 (32 a tile), with a ragged last tile at N = 300
    and 301; on the general route at refine_k = 8 and at D = 32."""
    from mocopci_torch.kernels.transformer_tail import BWD_SHAPES

    g = torch.Generator().manual_seed(4)
    table = _x(g, 2, 700, 3 + 2 * D).to(card)
    xq, q = _x(g, 2, N, 3).to(card), _x(g, 2, N, D).to(card)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
    idx = torch.randint(0, 700, (2, N, K), generator=g, dtype=torch.int32).to(card)
    kernels.reset_launches()
    got = kernels.transformer_tail(table, idx, xq, q, *ws)
    route = "transformer_tail" if (K, D) in BWD_SHAPES else "transformer_tail_general"
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {route: 1}, kernels.LAUNCHES
    torch.testing.assert_close(got, kernels.transformer_tail_plain(table, idx, xq, q, *ws),
                               atol=1e-4, rtol=1e-4)
    assert _bits_equal(got, kernels.transformer_tail(table, idx, xq, q, *ws))


@pytest.mark.parametrize("N,N2,K2", [(400, 900, 8),      # ragged: the last query tile of 16
                                     (8192, 8192, 64),   # the eval forward: units of 8 slots
                                     (129, 300, 13),     # ragged queries, a unit a slot
                                     (1000, 2000, 13)])  # units of 3 slots, the last of 1
def test_fusion_pair_kernel_matches_twin(card, N, N2, K2):
    """One launch; the planes within 1e-5 of the plain version's and bit-equal
    to the planes entry's, the logits (3xTF32 products) within 1e-4."""
    g = torch.Generator().manual_seed(5)
    p2, p1 = _x(g, 3, N2, 3, scale=5.0).to(card), _x(g, 3, N, 3, scale=5.0).to(card)
    idx = torch.randint(0, N2, (3, N, K2), generator=g, dtype=torch.int32).to(card)
    ws = []
    for ci, co in [(4, 64), (64, 64), (64, 128)]:
        ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
    kernels.reset_launches()
    planes, logits = kernels.fusion_pair(p2, idx, p1, *ws)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"fusion_pair": 1}
    want_planes, want_logits = kernels.fusion_pair_plain(p2, idx, p1, *ws)
    torch.testing.assert_close(planes, want_planes, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits, want_logits, atol=1e-4, rtol=1e-4)
    assert torch.equal(planes, kernels.fusion_pair_planes(p2, idx, p1))


@pytest.mark.parametrize("metric,C,B,N,M,k", [
    ("euclidean", 3, 2, 500, 300, 9),        # one tile, no fold
    ("euclidean", 3, 2, 700, 3000, 32),      # fold, ragged last tile
    ("euclidean", 3, 2, 300, 1024, 16),      # exactly one full tile
    ("euclidean", 5, 2, 200, 2000, 8),       # direct form, C < 8
    ("cosine", 64, 2, 300, 2048, 16),
    ("euclidean", 20, 2, 200, 700, 8),       # dot form
    ("euclidean", 3, 12, 8192, 8192, 32),    # the train step's largest call
    ("cosine", 64, 2, 2048, 2048, 16),       # the step's cosine calls (up_1's cost volume)
    ("euclidean", 3, 2, 64, 512, 32),        # a small grid
    ("euclidean", 3, 2, 333, 5000, 1),       # k = 1
    ("cosine", 256, 2, 256, 256, 1),         # k = 1, the widest cosine rows of the step
    ("euclidean", 3, 1, 100, 20000, 16),     # a reference streamed in chunks of planes
])
def test_knn_approx_kernel_matches_twin(card, metric, C, B, N, M, k):
    g = torch.Generator().manual_seed(6)
    q, r = _x(g, B, N, C, scale=4.0).to(card), _x(g, B, M, C, scale=4.0).to(card)
    if metric == "cosine":
        q, r = _normalise(q).contiguous(), _normalise(r).contiguous()
    kernels.reset_launches()
    got = kernels.knn_approx(q, r, k, metric)
    assert kernels.LAUNCHES["knn_approx"] == 1
    want = kernels.knn_approx_plain(q, r, k, metric)
    assert torch.equal(got, kernels.knn_approx(q, r, k, metric))
    if metric == "euclidean" and C <= 8:
        assert torch.equal(got, want)     # the same distance bits, the same keys
        return
    # the dot is summed in another order: a swap may span two quantisation
    # steps of a key (23 - idx_bits mantissa bits)
    d = kernels.knn.distances(q.double(), r.double(), metric)
    dg, dw = d.gather(2, got.long()), d.gather(2, want.long())
    bits = tiling(M, k)[1]
    assert torch.allclose(dg, dw, atol=1e-6, rtol=2.0 ** (bits - 22))
    assert (got == want).float().mean() > 0.99


@pytest.mark.parametrize("G,N,M,ties", [(3, 2048, 2048, False), (2, 1000, 1500, False),
                                        (1, 64, 5000, False), (30, 2048, 2048, False),
                                        (12, 256, 256, False), (3, 2048, 2048, True),
                                        (2, 9000, 3000, False), (2, 300, 20000, False)])
def test_chamfer_pair_kernel_matches_twin(card, G, N, M, ties):
    """At the loss's and the eval's shapes; N != M with M over many spans
    (20000 points, 313 chunks) and N past one block (9000 queries: k21 merged
    by atomics); and clouds of duplicated points, where many keys tie on the
    distance and only the index decides."""
    g = torch.Generator().manual_seed(7)
    p1, p2 = _x(g, G, N, 3, scale=5.0), _x(g, G, M, 3, scale=5.0)
    if ties:        # each cloud its first half twice; the queries lie on the points
        p2[:, M // 2:] = p2[:, :M // 2]
        p1 = p2[:, torch.randperm(M, generator=g)[:N]].clone()
    p1, p2 = p1.contiguous().to(card), p2.contiguous().to(card)
    k12, k21 = kernels.chamfer_pair_keys(p1, p2)
    w12, w21 = kernels.chamfer_pair_keys_plain(p1, p2)
    assert torch.equal(k12, w12) and torch.equal(k21, w21)


# the kernels the eval forward launches in each kNN mode (the eval attention
# on both its routes: Cross_Frame_Att's heads are c3 = 256 wide)
FORWARD_KERNELS = {
    "approx": {"fps", "fps_pyramid", "knn_approx", "attention", "attention_wide", "cross_tail",
               "transformer_tail", "fusion_pair"},
    "exact": {"fps", "fps_pyramid", "knn", "attention", "attention_wide", "cross_tail",
              "transformer_tail", "fusion_pair"},
}


def _tiny_forward_on_card_and_cpu(mode):
    """tiny_model_config(4096) (level 1 and refine at 1024: both tails run) on
    the card and on the CPU in kNN ``mode``; asserts the card's launches."""
    cfg = tiny_model_config(4096)
    rng = np.random.default_rng(0)
    x1 = (rng.normal(size=(1, cfg.npoints, 3)) * 10).astype(np.float32)
    x2 = (x1 + 0.1 * rng.normal(size=x1.shape)).astype(np.float32)
    saved = distance.get_knn_mode()
    distance.set_knn_mode(mode)
    try:
        kernels.reset_launches()
        got = interpolate(MoCoPCI(cfg, device="cuda"), x1, x2).cpu()
        launched = {name for name, n in kernels.LAUNCHES.items() if n > 0}
        assert launched == FORWARD_KERNELS[mode], kernels.LAUNCHES
        want = interpolate(MoCoPCI(cfg, device="cpu"), x1, x2)
    finally:
        distance.set_knn_mode(saved)
    assert torch.isfinite(got).all()
    return got, want


def test_tiny_model_on_card_matches_cpu(card):
    got, want = _tiny_forward_on_card_and_cpu("exact")
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def _chamfer64(a, b):
    a, b = a.double(), b.double()
    d = ((a[:, None] - b[None]) ** 2).sum(-1)
    return float(d.min(1).values.mean() + d.min(0).values.mean())


def test_tiny_model_approx_on_card_matches_cpu(card):
    """Approx mode: card and CPU features differ at float rounding, and a
    packed key quantises its distance to 2^-(23 - idx_bits), so a rounding
    difference can swap two feature-space neighbours whose distances share a
    quantisation step.  A few points then move; every frame must still agree
    to a Chamfer distance of 1e-4 (the chip_smoke.py limit), and all but
    0.1% of coordinates to 1e-3."""
    got, want = _tiny_forward_on_card_and_cpu("approx")
    assert float(((got - want).abs() > 1e-3).float().mean()) < 1e-3
    for j in range(3):
        assert _chamfer64(got[0, j], want[0, j]) < 1e-4


def test_tiny_eval_step_on_card_matches_cpu(card):
    cfg = tiny_model_config(1024)
    rng = np.random.default_rng(1)
    x1 = (rng.normal(size=(1, cfg.npoints, 3)) * 10).astype(np.float32)
    x2 = (x1 + 0.1 * rng.normal(size=x1.shape)).astype(np.float32)
    gt = np.stack([x1 + 0.05 * j for j in range(3)], axis=1).astype(np.float32)
    batch = {"pc1": x1, "pc2": x2, "gt": gt}
    kernels.reset_launches()
    got = eval_step(MoCoPCI(cfg, device="cuda"), batch)
    assert kernels.LAUNCHES["chamfer_pair"] == 1
    want = eval_step(MoCoPCI(cfg, device="cpu"), batch)
    for key, v in want.items():
        torch.testing.assert_close(got[key].cpu(), v, rtol=1e-4, atol=1e-6)


# ---- train kernels (slice 3) ----

def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("planes", [False, True])
def test_scatter_add_kernel_matches_twin_and_repeats(card, planes):
    """Held against the plain version on the CPU, whose index_add_ sums in
    the kernel's order (ascending source position); on the card its atomics
    add in another order each run, 1.2e-4 apart on the crowded row."""
    g = torch.Generator().manual_seed(10)
    G, S, C, N = 3, 20000, 3, 1024
    v = _x(g, *((G, C, S) if planes else (G, S, C))).to(card)
    idx = torch.randint(-5, N + 5, (G, S), generator=g, dtype=torch.int32)
    idx[:, :3000] = 17                                   # one crowded row
    idx = idx.to(card)
    got = kernels.scatter_add(v, idx, N, planes=planes)
    want = kernels.scatter_add_plain(v.cpu(), idx.cpu(), N, planes)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)
    assert _bits_equal(got, kernels.scatter_add(v, idx, N, planes=planes))


@pytest.mark.parametrize("rate", [0.05, 0.0])
@pytest.mark.parametrize("G,N,M,D", [
    (300, 20, 40, 8),      # G >= 256: the hash's group mixing
    (4, 100, 300, 16),
    (2, 2048, 2048, 8),    # Multi_Frame_Att's L1 sequence
    (3, 333, 517, 16),     # N, M not multiples of the query chunk or key tile
    (3, 333, 517, 32),
    (2, 129, 70, 6),       # D % 4 != 0, padded to 8
    (2, 150, 333, 12),     # D padded to 16
    (2, 100, 130, 64),
    (1, 70, 4096, 8),      # M = 4096: the TPU kernel's counter, its last key
    (1, 129, 4096, 64),
    (2, 70, 4160, 8),      # past it: the port's counter (shift 13)
    (1, 64, 8192, 16),     # the 32768-point step's L1 keys
    (2, 33, 64, 256),      # the wide route
    (16, 256, 256, 256),   # its train step shape (CrossFrameBlock at L3)
    (3, 100, 77, 70),      # D not a multiple of 8
    (2, 70, 130, 128),
    (1, 40, 50, 512),      # more head dims than a block holds: two slices
    (1, 100, 4096, 256),   # the wide route at M = 4096, N not a multiple of its 64
    (1, 40, 4160, 256),    # and past it
])
def test_attention_train_kernel_matches_twin(card, G, N, M, D, rate):
    """Output, its log-sum-exp and the gradients against the plain version,
    both directions' bits repeated, and each direction's route (one pass up
    to D = 64, wide above) counted."""
    from mocopci_torch.kernels.attention_train import (MAX_BWD_D, MAX_FWD_D,
                                                       attention_train_bwd,
                                                       attention_train_bwd_plain,
                                                       attention_train_fwd)

    g = torch.Generator().manual_seed(11)
    q, k, v, do = (_x(g, G, L, D).to(card) for L in (N, M, M, N))
    seed = torch.tensor([-987654], dtype=torch.int32, device=card)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launches()
    out = kernels.attention_train(*leaves, seed, D ** -0.5, rate)
    out.backward(do)
    fwd = "attention_train_fwd" if D <= MAX_FWD_D else "attention_train_fwd_wide"
    bwd = "attention_train_bwd" if D <= MAX_BWD_D else "attention_train_bwd_wide"
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {fwd: 1, bwd: 1}, kernels.LAUNCHES
    want = kernels.attention_train_plain(q, k, v, -987654, D ** -0.5, rate)
    torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=1e-4)
    for leaf, w in zip(leaves, attention_train_bwd_plain(q, k, v, -987654, D ** -0.5, rate, do)):
        torch.testing.assert_close(leaf.grad, w, atol=1e-4, rtol=1e-4)
    o, lse = attention_train_fwd(q, k, v, seed, D ** -0.5, rate)
    assert _bits_equal(o, out.detach())
    torch.testing.assert_close(lse, torch.logsumexp(q @ k.transpose(1, 2) * D ** -0.5, -1),
                               atol=1e-5, rtol=1e-4)
    again = attention_train_bwd(q, k, v, o, lse, do, seed, D ** -0.5, rate)
    for leaf, a in zip(leaves, again):
        assert _bits_equal(leaf.grad, a)


@pytest.mark.parametrize("N,K,C,C2", [(300, 32, 64, 64), (301, 32, 32, 96), (50, 300, 8, 16)])
def test_cross_tail_bwd_kernel_matches_twin_with_ties(card, N, K, C, C2):
    """The backward from the forward's saved argmax, at N = 300 (4-query
    tiles), at a ragged N = 301 with C = 32 (8-query tiles), C2 = 96, and at
    K = 300 (an int32 argmax; tiles cut to what shared memory holds)."""
    from mocopci_torch.kernels.cross_tail import (
        argmax_dtype,
        cross_tail_bwd,
        cross_tail_bwd_plain,
        cross_tail_fwd,
    )
    from mocopci_torch.kernels.scatter_add import gather_backward

    g = torch.Generator().manual_seed(12)
    tab, base = _x(g, 2, 700, C).to(card), _x(g, 2, N, C).to(card)
    w, b = _x(g, C, C2, scale=C ** -0.5).to(card), _x(g, C2, scale=0.1).to(card)
    idx = torch.randint(0, 700, (2, N, K), generator=g, dtype=torch.int32)
    idx[:, :, 1] = idx[:, :, 0]
    idx = idx.to(card)
    dout = _x(g, 2, N, C2).to(card)
    amax = torch.empty((2, N, C2), dtype=argmax_dtype(K), device=card)
    out = cross_tail_fwd(tab, idx, base, w, b, amax)
    got = cross_tail_bwd(tab, idx, base, w, out, amax, dout)
    want = cross_tail_bwd_plain(tab, idx, base, w, b, dout)
    # ties between duplicate neighbours: the kernel routes the gradient to the
    # first, the twin splits it; their sums into the table agree
    d_tab = [gather_backward(r.reshape(2, N * K, C), idx.reshape(2, -1), 700)
             for r in (got[0], want[0])]
    torch.testing.assert_close(d_tab[0], d_tab[1], atol=1e-4, rtol=1e-4)
    for a, c in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-4)
    again = cross_tail_bwd(tab, idx, base, w, out, amax, dout)
    assert all(_bits_equal(a, c) for a, c in zip(got, again))


def _wide_bwd_case(ct, card, B, N, K, C, C2, dup, force, monkeypatch):
    """(the wide backward's outputs, the tiled backward's where ``force``,
    inputs) at (B, N, K, C, C2): neighbour 1 a duplicate of neighbour 0
    (``dup`` "one"), or every neighbour (``dup`` "all": every channel's max
    ties at j = 0, one bucket); forced onto the wide route with
    ``monkeypatch`` where ``force``."""
    g = torch.Generator().manual_seed(14)
    M = 700
    tab, base = _x(g, B, M, C).to(card), _x(g, B, N, C).to(card)
    w, b = _x(g, C, C2, scale=C ** -0.5).to(card), _x(g, C2, scale=0.1).to(card)
    idx = torch.randint(0, M, (B, N, K), generator=g, dtype=torch.int32)
    if dup == "all":
        idx[:] = idx[:, :, :1]
    else:
        idx[:, :, 1 % K] = idx[:, :, 0]
    idx = idx.to(card)
    dout = _x(g, B, N, C2).to(card)
    amax = torch.empty((B, N, C2), dtype=ct.argmax_dtype(K), device=card)
    out = ct.cross_tail_fwd(tab, idx, base, w, b, amax)
    tiled = ct.cross_tail_bwd(tab, idx, base, w, out, amax, dout) if force else None
    with monkeypatch.context() as m:
        if force:
            m.setattr(ct, "bwd_route", lambda *a: "cross_tail_bwd_wide")
        assert ct.bwd_route(K, C, C2) == "cross_tail_bwd_wide"
        kernels.reset_launches()
        got = ct.cross_tail_bwd(tab, idx, base, w, out, amax, dout)
        assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"cross_tail_bwd_wide": 1}
        again = ct.cross_tail_bwd(tab, idx, base, w, out, amax, dout)
    assert all(_bits_equal(a, c) for a, c in zip(got, again))
    return got, tiled, (tab, idx, base, w, b, dout, M)


_CT = importlib.import_module("mocopci_torch.kernels.cross_tail")
# the largest K the wide backward's bucketed form admits at C2 = 256 (129)
_WIDE_K = max(k for k in range(1, 256) if _CT._bwd_wide_smem(k, 256) <= _CT._MAX_SMEM)


@pytest.mark.parametrize("B,N,K,C,C2,dup", [
    (2, 301, 32, 256, 256, "one"),        # cross3's channels, a ragged last group
    (2, 300, 4, 256, 256, "one"),
    (2, 300, 32, 256, 256, "all"),        # every channel in one bucket
    (2, 300, 1, 256, 256, "one"),         # K = 1
    (2, 1021, 32, 256, 256, "one"),       # spans of 7 and 8 groups, the last group 2 queries
    (2, 40, _WIDE_K, 300, 256, "one"),    # K at its limit; C past 256, a ragged last slice
    (2, 50, 100, 8, 16, "one"),           # a slice of 8 channels, C2 = 16
    (2, 41, 8, 30, 20, "one"),            # C % 4 != 0: 4-byte copies; C2 % 4 != 0
    (2, 100, 32, 128, 512, "one"),        # C2 > 256: the general form by size
    (2, 50, 300, 8, 16, "one"),           # K = 300: the general form, an int32 argmax
])
def test_cross_tail_bwd_wide_matches_twin_and_the_tiled_bits(card, monkeypatch, B, N, K, C, C2,
                                                             dup):
    """The wide backward against the plain version after the scatter (the
    table's gradient within 1e-4, base, W and b within 1e-3 + 1e-4 rel), its
    bits repeated, at each case's shape (forced where the tiled backward
    also fits; the bucketed form, or the general one past its footprint);
    then at the same (B, N, K) and neighbours with C = C2 = 64, forced (at
    the case's own shape where no wide form fits C = C2 = 64, K = 300), its
    d_rows and d_base bit-equal to the tiled kernel's and its dW, db within
    1e-5 (1 + max) of the tiled sums."""
    ct = _CT
    from mocopci_torch.kernels.scatter_add import gather_backward

    force = ct._bwd_smem(K, C, C2) <= ct._MAX_SMEM
    got, tiled, (tab, idx, base, w, b, dout, M) = _wide_bwd_case(
        ct, card, B, N, K, C, C2, dup, force, monkeypatch)
    want = ct.cross_tail_bwd_plain(tab, idx, base, w, b, dout)
    d_tab = [gather_backward(r.reshape(B, N * K, C), idx.reshape(B, -1), M)
             for r in (got[0], want[0])]
    torch.testing.assert_close(d_tab[0], d_tab[1], atol=1e-4, rtol=1e-4)
    for a, c in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-4)
    if ct.bwd_wide_form(K, 64, 64) is None:     # K = 300: the tiled bits at the case's shape
        assert force
    else:
        got, tiled, _ = _wide_bwd_case(ct, card, B, N, K, 64, 64, dup, True, monkeypatch)
    assert _bits_equal(got[0], tiled[0]) and _bits_equal(got[1], tiled[1])
    for a, c in zip(got[2:], tiled[2:]):
        assert float((a - c).abs().max()) <= 1e-5 * (1 + float(c.abs().max()))


@pytest.mark.parametrize("N,K,D", [(300, 16, 64), (301, 4, 64), (2048, 16, 64), (300, 8, 64),
                                   (301, 28, 64), (200, 16, 32), (2048, 8, 64)])
def test_transformer_tail_bwd_kernel_matches_twin(card, N, K, D):
    """At the refine head's K = 16 (8 queries a tile) and the tiny configs'
    K = 4 (32 a tile), with a ragged last tile at N = 300 and 301, on the
    tensor cores; at refine_k = 8, at K = 28 (the largest that fits at
    D = 64) and at D = 32, on the general route."""
    from mocopci_torch.kernels.transformer_tail import (
        BWD_SHAPES,
        transformer_tail_bwd,
        transformer_tail_bwd_plain,
    )

    g = torch.Generator().manual_seed(13)
    table = _x(g, 2, 700, 3 + 2 * D).to(card)
    xq, q = _x(g, 2, N, 3).to(card), _x(g, 2, N, D).to(card)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
    idx = torch.randint(0, 700, (2, N, K), generator=g, dtype=torch.int32).to(card)
    dout = _x(g, 2, N, D).to(card)
    kernels.reset_launches()
    got = transformer_tail_bwd(table, idx, xq, q, *ws, dout)
    route = "transformer_tail_bwd" if (K, D) in BWD_SHAPES else "transformer_tail_bwd_general"
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {route: 1}, kernels.LAUNCHES
    want = transformer_tail_bwd_plain(table, idx, xq, q, *ws, dout)
    for i, (a, c) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-3, msg=f"output {i}")
    again = transformer_tail_bwd(table, idx, xq, q, *ws, dout)
    assert all(_bits_equal(a, c) for a, c in zip(got, again))


def _fusion_head_inputs(g, card, G=6, P=5000):
    x = _x(g, G, 4, P, scale=3.0).to(card)
    params, cin = [], 4
    for c in (64, 64, 128):
        params += [_x(g, cin, c, scale=cin ** -0.5).to(card), _x(g, c, scale=0.1).to(card),
                   (1 + 0.1 * _x(g, c)).to(card), _x(g, c, scale=0.1).to(card)]
        cin = c
    return x, params


def test_fusion_head_train_kernels_match_twin(card):
    from mocopci_torch.kernels.fusion_head_train import fusion_head_train_bwd_plain

    g = torch.Generator().manual_seed(14)
    x, params = _fusion_head_inputs(g, card)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    o, stats = kernels.fusion_head_train(leaves[0], leaves[1:], 3)
    want_o, want_stats = kernels.fusion_head_train_plain(x, params, 3)
    torch.testing.assert_close(o.detach(), want_o, atol=1e-4, rtol=1e-4)
    for (m, v), (wm, wv) in zip(stats, want_stats):
        torch.testing.assert_close(m, wm, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(v, wv, atol=1e-5, rtol=1e-3)
    d_o = _x(g, *o.shape).to(card)
    o.backward(d_o)
    want = fusion_head_train_bwd_plain(x, params, 3, 1e-3, d_o)
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        torch.testing.assert_close(leaf.grad, w, atol=1e-3, rtol=1e-3, msg=f"grad {i}")


@pytest.mark.parametrize("F", [1, 3])
def test_fusion_head_train_fwd_ragged_tiles_match_twin_and_repeat(card, F):
    """The forward sweeps at P = 5000 (no multiple of a tile) with F groups:
    o and each layer's (mean, var) against the plain version, and a second
    run equal bit for bit."""
    fht = importlib.import_module("mocopci_torch.kernels.fusion_head_train")
    g = torch.Generator().manual_seed(18)
    x, params = _fusion_head_inputs(g, card)
    o, stats, _ = fht.fusion_head_train_fwd(x, params, F)
    want_o, want_stats = fht.fusion_head_train_plain(x, params, F)
    torch.testing.assert_close(o, want_o, atol=1e-4, rtol=1e-4)
    for (m, v), (wm, wv) in zip(stats, want_stats):
        torch.testing.assert_close(m, wm, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(v, wv, atol=1e-5, rtol=1e-3)
    o2, stats2, _ = fht.fusion_head_train_fwd(x, params, F)
    assert _bits_equal(o, o2)
    assert all(_bits_equal(a, b) for s1, s2 in zip(stats, stats2) for a, b in zip(s1, s2))


def test_fusion_head_train_bwd_ragged_tiles_match_twin_and_repeat(card):
    """The backward at P = 5000 (no multiple of a tile) and F = 3 groups,
    held as chip_smoke.py holds it at the train shape: pairs within 1e-4 of a
    channel-max tie or a ReLU kink get no gradient, every output but the
    biases within 1e-3 over max(1, |value|), the biases (exactly 0 before a
    train-mode BatchNorm) below 1e-2 of their weight's largest gradient, and
    a second run equal bit for bit."""
    fht = importlib.import_module("mocopci_torch.kernels.fusion_head_train")
    g = torch.Generator().manual_seed(17)
    x, params = _fusion_head_inputs(g, card)
    _, _, (packed, st) = fht.fusion_head_train_fwd(x, params, 3)
    h3, _, kink = fht.fusion_head_train_channels(x, params, 3)
    top2 = h3.topk(2, dim=1).values
    near = ((top2[:, 0] - top2[:, 1]) <= 1e-4 * top2[:, 0]) | (kink < 1e-4)
    d_o = _x(g, x.shape[0], x.shape[2]).to(card) * (~near)
    got = fht.fusion_head_train_bwd(x, params, 3, packed, st, d_o)
    want = fht.fusion_head_train_bwd_plain(x, params, 3, 1e-3, d_o)
    for i, (a, w) in enumerate(zip(got, want)):
        if i in (2, 6, 10):
            assert float(a.abs().max()) < 1e-2 * float(want[i - 1].abs().max()), f"bias {i}"
        else:
            err = float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
            assert err <= 1e-3, f"output {i}: {err}"
    again = fht.fusion_head_train_bwd(x, params, 3, packed, st, d_o)
    assert all(_bits_equal(a, c) for a, c in zip(got, again))


def test_fusion_pair_planes_kernel_matches_twin(card):
    g = torch.Generator().manual_seed(15)
    p2, p1 = _x(g, 3, 900, 3, scale=5.0).to(card), _x(g, 3, 400, 3, scale=5.0).to(card)
    idx = torch.randint(0, 900, (3, 400, 8), generator=g, dtype=torch.int32).to(card)
    torch.testing.assert_close(kernels.fusion_pair_planes(p2, idx, p1),
                               kernels.pair_planes(p2, idx, p1), atol=1e-5, rtol=1e-5)
    leaves = [t.clone().requires_grad_() for t in (p2, p1)]
    cot = _x(g, 3, 4, 400 * 8).to(card)
    (kernels.fusion_pair_planes(leaves[0], idx, leaves[1]) * cot).sum().backward()
    cpu = [t.cpu().requires_grad_() for t in (p2, p1)]
    (kernels.fusion_pair_planes(cpu[0], idx.cpu(), cpu[1]) * cot.cpu()).sum().backward()
    for a, c in zip(leaves, cpu):
        torch.testing.assert_close(a.grad.cpu(), c.grad, atol=1e-4, rtol=1e-4)


def test_forward_only_kernels_refuse_grad(card):
    g = torch.Generator().manual_seed(16)
    q = _x(g, 2, 30, 8).to(card).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.attention(q, q, q, 0.3)
    with torch.no_grad():
        assert kernels.attention(q, q, q, 0.3).shape == q.shape
    p2 = _x(g, 1, 50, 3).to(card).requires_grad_()
    idx = torch.zeros(1, 20, 4, dtype=torch.int32, device=card)
    ws = []
    for ci, co in [(4, 64), (64, 64), (64, 128)]:
        ws += [_x(g, ci, co).to(card), _x(g, co).to(card)]
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.fusion_pair(p2, idx, p2[:, :20].detach(), *ws)


# the kernels one train step launches (exact kNN mode)
TRAIN_KERNELS = {"fps", "fps_pyramid", "knn", "cross_tail", "cross_tail_bwd",
                 "transformer_tail", "transformer_tail_bwd", "attention_train_fwd",
                 "attention_train_fwd_wide", "attention_train_bwd", "attention_train_bwd_wide",
                 "fusion_pair_planes", "fusion_head_train_fwd", "fusion_head_train_bwd",
                 "chamfer_pair", "scatter_add"}


def test_tiny_train_step_on_card_matches_cpu(card):
    """One step's loss and gradients at tiny_model_config(4096) (level 1 and
    the refine head at 1024: both tails run), exact kNN, no dropout: the
    limits of chip_smoke.py's train parity (the whole gradient within rel L2
    1e-3, each leaf within 5e-2 plus 1e-6: a near tie of a max, a ReLU kink or
    a kNN selection can go the other way on the other device).  The biases
    before the fusion head's train-mode BatchNorms have a gradient of exactly
    zero: below 1e-5 of their weight's on both devices."""
    import dataclasses

    from mocopci_torch.config import TrainConfig
    from mocopci_torch.training.loop import loss_and_grads

    cfg = dataclasses.replace(tiny_model_config(4096), attn_drop=0.0, proj_drop=0.0,
                              drop_path=0.0)
    rng = np.random.default_rng(2)
    x1 = (rng.normal(size=(2, cfg.npoints, 3)) * 5).astype(np.float32)
    flow = (0.3 * rng.normal(size=(2, 1, 3))).astype(np.float32)
    batch = {"pc1": x1, "pc2": x1 + flow,
             "gt": np.stack([x1 + flow * s for s in (0.25, 0.5, 0.75)], 1).astype(np.float32)}
    saved = distance.get_knn_mode()
    distance.set_knn_mode("exact")
    try:
        card_model = MoCoPCI(cfg, device="cuda")
        cpu_model = MoCoPCI(cfg, device="cpu")
        kernels.reset_launches()
        got = loss_and_grads(card_model, batch, None, cfg, TrainConfig())
        launched = {name for name, n in kernels.LAUNCHES.items() if n > 0}
        assert TRAIN_KERNELS <= launched, kernels.LAUNCHES
        want = loss_and_grads(cpu_model, batch, None, cfg, TrainConfig())
    finally:
        distance.set_knn_mode(saved)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    cpu_params = dict(cpu_model.named_parameters())
    d2 = g2 = 0.0
    for name, p in card_model.named_parameters():
        q = cpu_params[name].grad
        if name in {f"estimator.fusion_conv{i}.bias" for i in range(3)}:
            # before a train-mode BatchNorm: the gradient is exactly zero
            w = torch.linalg.vector_norm(cpu_params[name[:-4] + "weight"].grad)
            assert max(torch.linalg.vector_norm(p.grad), torch.linalg.vector_norm(q)) <= 1e-5 * w
            continue
        err = torch.linalg.vector_norm(p.grad.cpu() - q)
        assert err <= 5e-2 * torch.linalg.vector_norm(q) + 1e-6, name
        d2, g2 = d2 + err ** 2, g2 + torch.linalg.vector_norm(q) ** 2
    assert (d2 / g2) ** 0.5 <= 1e-3


def _train_batch(npoints, seed):
    rng = np.random.default_rng(seed)
    x1 = (rng.normal(size=(2, npoints, 3)) * 5).astype(np.float32)
    flow = (0.3 * rng.normal(size=(2, 1, 3))).astype(np.float32)
    return {"pc1": x1, "pc2": x1 + flow,
            "gt": np.stack([x1 + flow * s for s in (0.25, 0.5, 0.75)], 1).astype(np.float32)}


# leaves whose gradient is exactly 0 in exact arithmetic: the biases before a
# train-mode BatchNorm, and the refine head's last logit bias, one constant
# over the neighbours of a softmax
ROUNDING_LEAVES = {f"estimator.fusion_conv{i}.bias" for i in range(3)} | {
    "estimator.shape1.fc_gamma2.bias"}


def test_remat_step_on_card_equals_the_step_without_remat(card):
    """tiny_model_config(4096), B=2, approx kNN, dropout on, one generator
    seed: ``loss_and_grads`` with remat against without, on the card.  The
    loss bit-equal, the whole gradient within rel L2 1e-6 and each leaf
    within 1e-4 (the backward's sums may run in another order; the
    ``ROUNDING_LEAVES`` within 1e-4 of their weight's gradient), the running
    statistics and the generator's state equal, and every forward kernel of
    the four stages launched more often (the recompute)."""
    import dataclasses

    from mocopci_torch.config import TrainConfig
    from mocopci_torch.training.loop import loss_and_grads

    batch = _train_batch(4096, 5)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tiny_model_config(4096), remat=remat)
        model = MoCoPCI(cfg, device="cuda", seed=1)
        rng = torch.Generator(device="cuda").manual_seed(3)
        kernels.reset_launches()
        aux = loss_and_grads(model, batch, rng, cfg, TrainConfig())
        runs.append((aux, {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: b.clone() for n, b in model.named_buffers()}, rng.get_state(),
                     dict(kernels.LAUNCHES)))
    (a0, g0, s0, r0, l0), (a1, g1, s1, r1, l1) = runs
    assert all(torch.equal(a1[k], v) for k, v in a0.items())
    assert all(torch.equal(s1[n], b) for n, b in s0.items())
    assert torch.equal(r1, r0)
    d2 = n2 = 0.0
    for name, g in g0.items():
        err, norm = torch.linalg.vector_norm(g1[name] - g), torch.linalg.vector_norm(g)
        if name in ROUNDING_LEAVES:
            # exactly zero but for rounding: against their weight's gradient
            assert err <= 1e-4 * torch.linalg.vector_norm(g0[name[:-4] + "weight"]), name
            continue
        assert err <= 1e-4 * norm + 1e-12, name
        d2, n2 = d2 + err ** 2, n2 + norm ** 2
    assert (d2 / n2) ** 0.5 <= 1e-6
    for name in ("knn_approx", "cross_tail", "attention_train_fwd", "transformer_tail",
                 "fusion_pair_planes", "fusion_head_train_fwd"):
        assert l1[name] > l0[name], (name, l0, l1)


def test_dp_step_at_world_one_is_train_step_bit_for_bit(card, monkeypatch):
    """The data-parallel step over NCCL at world size 1 (the environment
    torchrun sets), tiny_model_config(1024), B=2, dropout off: its loss
    components, gradients, parameters and running statistics bit-equal to
    ``train_step``'s from the same weights, both under PyTorch's
    deterministic algorithms (the step's ``index_add_``s sum by atomics)."""
    import dataclasses
    import socket

    from mocopci_torch import parallel
    from mocopci_torch.config import TrainConfig
    from mocopci_torch.training import create_train_state, train_step
    from mocopci_torch.training.loop import dp_train_step

    cfg = dataclasses.replace(tiny_model_config(1024), attn_drop=0.0, proj_drop=0.0,
                              drop_path=0.0)
    batch = _train_batch(1024, 6)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                           WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    outs = []
    assert parallel.init_distributed(card)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert torch.distributed.get_backend() == "nccl"
        for step in (train_step, lambda st, b, r: dp_train_step(st, b, r)):
            model, state = create_train_state(cfg, TrainConfig(), steps_per_epoch=1,
                                              device="cuda")
            _, aux = step(state, batch, None)
            outs.append((aux, {n: p.grad for n, p in model.named_parameters()},
                         dict(model.named_parameters()), dict(model.named_buffers())))
    finally:
        torch.use_deterministic_algorithms(False)
        parallel.shutdown_distributed()
    for want, got in zip(*outs):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


# ---- op kernels (slice 4) ----

@pytest.mark.parametrize("R,L,k,with_idx", [
    (7, 64, 64, True), (50, 200, 9, False), (60, 500, 20, True), (300, 1000, 32, True),
    (30, 2000, 32, False), (20, 3000, 8, True), (40, 5000, 16, False), (8, 16384, 32, True),
    (4, 20000, 32, True)])
def test_select_min_k_kernel_equals_twin(card, R, L, k, with_idx):
    """Every register width of a warp per row (L <= 1024) and of a block per
    row (L <= 16384), and the rescan from memory above; ties from 50 value
    levels: the kernel's picks equal the twin's."""
    g = torch.Generator().manual_seed(20)
    vals = torch.randint(0, 50, (R, L), generator=g).float().to(card)
    idxs = torch.randint(0, 1 << 20, (R, L), generator=g, dtype=torch.int32).to(card)
    i = idxs if with_idx else None
    assert torch.equal(kernels.select_min_k(vals, i, k), kernels.select_min_k_plain(vals, i, k))


@pytest.mark.parametrize("G,S,N,dropped", [
    (3, 8192, 64, False), (3, 64, 8192, False), (2, 1024, 512, False), (2, 2560, 96, False),
    (2, 16384, 64, False),   # 8 blocks of 2048 sources in a cluster
    (2, 4096, 512, True),    # every target out of range: all zero
])
def test_onehot_scatter_kernel_matches_twin_and_repeats(card, G, S, N, dropped):
    g = torch.Generator().manual_seed(21)
    v = _x(g, G, S, 3).to(card)
    idx = torch.randint(-5, N + 5, (G, S), generator=g, dtype=torch.int32)
    if dropped:
        idx = torch.where(idx % 2 == 0, -1 - idx.abs(), N + idx.abs())
    idx = idx.to(card)
    got = kernels.onehot_scatter_rows(v, idx, N)
    torch.testing.assert_close(got, kernels.onehot_scatter_rows_plain(v, idx, N),
                               atol=1e-5, rtol=1e-5)
    assert _bits_equal(got, kernels.onehot_scatter_rows(v, idx, N))
    if dropped:
        assert not got.any()


def test_build_pair_planes_kernels_match_twin(card):
    from mocopci_torch.kernels.fusion_pair import build_pair_planes_bwd_plain

    g = torch.Generator().manual_seed(22)
    G, N, K2 = 3, 256, 5
    nbr, p1t = _x(g, G, N * K2, 3, scale=5.0), _x(g, G, 3, N, scale=5.0)
    nbr[1, 2 * N + 7] = p1t[1, :, 7]                    # a zero-distance pair
    nbr, p1t = nbr.to(card), p1t.to(card)
    leaves = [t.clone().requires_grad_() for t in (nbr, p1t)]
    x = kernels.build_pair_planes(*leaves)
    torch.testing.assert_close(x, kernels.build_pair_planes_plain(nbr, p1t), atol=1e-5,
                               rtol=1e-5)
    dx = _x(g, G, 4, N * K2).to(card)
    x.backward(dx)
    for leaf, w in zip(leaves, build_pair_planes_bwd_plain(nbr, p1t, dx)):
        assert torch.isfinite(leaf.grad).all()
        torch.testing.assert_close(leaf.grad, w, atol=1e-5, rtol=1e-5)


def test_exact_selection_of_wide_rows_matches_cpu(card, monkeypatch):
    """Exact ``_topk_min_indices``: one launch up to 16384 columns, the
    1024-column chunk merge (two launches) above."""
    monkeypatch.setattr(distance, "_KNN_MODE", "exact")
    g = torch.Generator().manual_seed(24)
    for M, launches in ((16384, 1), (17408, 2)):
        d = torch.randint(0, 400, (2, 3, M), generator=g).float()      # many ties
        kernels.reset_launches()
        got = distance._topk_min_indices(d.to(card), 32).cpu()
        assert kernels.LAUNCHES["select_min_k"] == launches
        np.testing.assert_array_equal(got.numpy(), distance._topk_min_indices(d, 32).numpy())


def test_ops_path_launches_the_op_kernels(card, monkeypatch):
    """The op paths that reach the four kernels, on the card against the CPU:
    exact kNN above the kernel's reference limit (patched small, with small
    blocks), the Chamfer VJP at a size off the 128 multiples, approx
    selection, and build_pair_planes under grad."""
    from mocopci_torch.kernels import knn as knn_kernel

    monkeypatch.setattr(distance, "_DENSE_LIMIT", 1 << 14)
    monkeypatch.setattr(distance, "_REF_CHUNK", 256)
    monkeypatch.setattr(knn_kernel, "MAX_M", 512)
    monkeypatch.setattr(distance, "_KNN_MODE", "exact")
    g = torch.Generator().manual_seed(23)
    ref, q = _x(g, 1, 1500, 3), _x(g, 1, 300, 3)
    pred, gt = _x(g, 2, 64, 3, scale=3.0), _x(g, 2, 1024, 3, scale=3.0)
    d = _x(g, 2, 100, 4096).abs()
    nbr, p1t = _x(g, 2, 256, 3), _x(g, 2, 3, 128)
    kernels.reset_launches()
    got_knn = distance.knn(8, ref.to(card), q.to(card)).cpu()
    leaves = [t.to(card).requires_grad_() for t in (pred, gt)]
    ops.chamfer_distance(*leaves).backward()
    monkeypatch.setattr(distance, "_KNN_MODE", "approx")
    got_sel = distance._topk_min_indices(d.to(card), 16).cpu()
    got_narrow = distance._topk_min_indices(d[..., :50].to(card), 30).cpu()     # L <= 2k
    planes = [t.to(card).requires_grad_() for t in (nbr, p1t)]
    kernels.build_pair_planes(*planes).sum().backward()
    launched = dict(kernels.LAUNCHES)
    assert launched["onehot_scatter"] == 2 and launched["chamfer_pair"] == 1, launched
    assert launched["pair_planes_rows"] == 1 and launched["pair_planes_bwd"] == 1, launched
    # (300 / 128 -> 3 query chunks) x (6 reference chunks + 1 merge) + 2 selections
    assert launched["select_min_k"] == 3 * 7 + 2, launched
    np.testing.assert_array_equal(got_sel.numpy(), distance._topk_min_indices(d, 16).numpy())
    np.testing.assert_array_equal(got_narrow.numpy(),
                                  distance._topk_min_indices(d[..., :50], 30).numpy())
    monkeypatch.setattr(distance, "_KNN_MODE", "exact")
    np.testing.assert_array_equal(got_knn.numpy(), distance.knn(8, ref, q).numpy())
    cpu = [t.clone().requires_grad_() for t in (pred, gt)]
    ops.chamfer_distance(*cpu).backward()
    for a, c in zip(leaves, cpu):
        torch.testing.assert_close(a.grad.cpu(), c.grad, atol=1e-6, rtol=1e-5)
