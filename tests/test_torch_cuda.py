"""Card-only checks: each CUDA kernel against its plain twin on the GPU, at
small shapes, and a small model forward on the card against the CPU.

Skipped without a CUDA device.  This file imports no JAX, so on a machine
with a card and no JAX it runs without the repository conftest:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mocopci_torch import MoCoPCI, interpolate, kernels, tiny_model_config
from mocopci_torch.ops.distance import _normalise

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


def test_attention_kernel_matches_twin(card):
    g = torch.Generator().manual_seed(2)
    for G, N, M, D in ((6, 100, 300, 8), (2, 33, 64, 256), (3, 40, 4096, 16)):
        q, k, v = (_x(g, G, L, D).to(card) for L in (N, M, M))
        got = kernels.attention(q, k, v, D ** -0.5)
        torch.testing.assert_close(got, kernels.attention_plain(q, k, v, D ** -0.5),
                                   atol=1e-5, rtol=1e-4)


def test_cross_tail_kernel_matches_twin(card):
    g = torch.Generator().manual_seed(3)
    tab, base = _x(g, 2, 700, 64).to(card), _x(g, 2, 300, 64).to(card)
    w, b = _x(g, 64, 64, scale=0.125).to(card), _x(g, 64, scale=0.1).to(card)
    idx = torch.randint(0, 700, (2, 300, 32), generator=g, dtype=torch.int32).to(card)
    torch.testing.assert_close(kernels.cross_tail(tab, idx, base, w, b),
                               kernels.cross_tail_plain(tab, idx, base, w, b),
                               atol=1e-4, rtol=1e-4)


def test_transformer_tail_kernel_matches_twin(card):
    g = torch.Generator().manual_seed(4)
    D = 64
    table = _x(g, 2, 700, 3 + 2 * D).to(card)
    xq, q = _x(g, 2, 300, 3).to(card), _x(g, 2, 300, D).to(card)
    ws = []
    for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
        ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
    idx = torch.randint(0, 700, (2, 300, 16), generator=g, dtype=torch.int32).to(card)
    torch.testing.assert_close(kernels.transformer_tail(table, idx, xq, q, *ws),
                               kernels.transformer_tail_plain(table, idx, xq, q, *ws),
                               atol=1e-4, rtol=1e-4)


def test_fusion_pair_kernel_matches_twin(card):
    g = torch.Generator().manual_seed(5)
    p2, p1 = _x(g, 3, 900, 3, scale=5.0).to(card), _x(g, 3, 400, 3, scale=5.0).to(card)
    idx = torch.randint(0, 900, (3, 400, 8), generator=g, dtype=torch.int32).to(card)
    ws = []
    for ci, co in [(4, 64), (64, 64), (64, 128)]:
        ws += [_x(g, ci, co, scale=ci ** -0.5).to(card), _x(g, co, scale=0.1).to(card)]
    planes, logits = kernels.fusion_pair(p2, idx, p1, *ws)
    want_planes, want_logits = kernels.fusion_pair_plain(p2, idx, p1, *ws)
    torch.testing.assert_close(planes, want_planes, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits, want_logits, atol=1e-4, rtol=1e-4)


def test_tiny_model_on_card_matches_cpu(card):
    cfg = tiny_model_config(4096)       # level 1 and refine at 1024: both tails run
    rng = np.random.default_rng(0)
    x1 = (rng.normal(size=(1, cfg.npoints, 3)) * 10).astype(np.float32)
    x2 = (x1 + 0.1 * rng.normal(size=x1.shape)).astype(np.float32)
    kernels.reset_launches()
    got = interpolate(MoCoPCI(cfg, device="cuda"), x1, x2).cpu()
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    want = interpolate(MoCoPCI(cfg, device="cpu"), x1, x2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
