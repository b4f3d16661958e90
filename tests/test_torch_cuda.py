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


@pytest.mark.parametrize("metric,C,N,M,k", [
    ("euclidean", 3, 500, 300, 9),        # one tile, no fold
    ("euclidean", 3, 700, 3000, 32),      # fold, ragged last tile
    ("euclidean", 3, 300, 1024, 16),      # exactly one full tile
    ("euclidean", 5, 200, 2000, 8),       # direct form, C < 8
    ("cosine", 64, 300, 2048, 16),
    ("euclidean", 20, 200, 700, 8),       # dot form
])
def test_knn_approx_kernel_matches_twin(card, metric, C, N, M, k):
    g = torch.Generator().manual_seed(6)
    q, r = _x(g, 2, N, C, scale=4.0).to(card), _x(g, 2, M, C, scale=4.0).to(card)
    if metric == "cosine":
        q, r = _normalise(q).contiguous(), _normalise(r).contiguous()
    got = kernels.knn_approx(q, r, k, metric)
    want = kernels.knn_approx_plain(q, r, k, metric)
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


@pytest.mark.parametrize("G,N,M", [(3, 2048, 2048), (2, 1000, 1500), (1, 64, 5000)])
def test_chamfer_pair_kernel_matches_twin(card, G, N, M):
    g = torch.Generator().manual_seed(7)
    p1, p2 = _x(g, G, N, 3, scale=5.0).to(card), _x(g, G, M, 3, scale=5.0).to(card)
    k12, k21 = kernels.chamfer_pair_keys(p1, p2)
    w12, w21 = kernels.chamfer_pair_keys_plain(p1, p2)
    assert torch.equal(k12, w12) and torch.equal(k21, w21)


# the kernels the eval forward launches in each kNN mode
FORWARD_KERNELS = {
    "approx": {"fps", "knn_approx", "attention", "cross_tail", "transformer_tail",
               "fusion_pair"},
    "exact": {"fps", "knn", "attention", "cross_tail", "transformer_tail", "fusion_pair"},
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
