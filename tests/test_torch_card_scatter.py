"""Card-only sweep of the scatter-add kernel (``csrc/scatter_add.cu``) over the
bucket sizes at which its code changes: one target row takes L sources, on
both sides of each register size of the warp sort (32, 64, 128 and 256
entries), into the sort of a long bucket in shared memory beyond it and into
its sort in place past 4096 entries, with -1 and >= N targets
dropped, on each of the kernel's routes (the one-launch small route; the
counting sort with shared-memory histograms; the counting sort with global
atomics), with values read as rows (3 channels, gathered through shared rows;
131 channels, the lanes taking the channels in two passes) and as planes (5
channels).  Every result equals the plain version on the CPU bit for bit
(``index_add_``, each row summed in ascending source position) and a second
run on the card.

Skipped without a CUDA device.  This file imports no JAX, so on a machine
with a card and no JAX it runs without the repository conftest:
    python -m pytest --noconftest -m cuda tests/test_torch_card_scatter.py
"""
import pytest
import torch

from mocopci_torch import kernels

pytestmark = pytest.mark.cuda

# (rows N, background sources): the counting sort with shared-memory
# histograms (about 20 sources a row); the small route (at most 16384 sources,
# fewer than 4 a row, at most 4 channels); the counting sort with global
# atomics (N above the histogram's 16384 bins, more than 16384 sources)
ROUTES = {"histogram": (512, 10000), "small": (20000, 10000), "global": (40000, 20000)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _targets(g, L, N, background):
    """One row (3) takes L sources, the rest spread over the other rows, and
    -1 / >= N targets (dropped) among them, all in a random order."""
    flat = torch.cat([torch.full((L,), 3, dtype=torch.int32),
                      torch.randint(4, N, (background,), generator=g, dtype=torch.int32),
                      torch.tensor([-1, N, N + 7] * 10, dtype=torch.int32)])
    return torch.stack([flat[torch.randperm(flat.numel(), generator=g)] for _ in range(2)])


@pytest.mark.parametrize("L", [1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                               512, 513, 4097, 16385])
def test_scatter_add_bucket_of_L_equals_the_cpu_sum(card, L):
    g = torch.Generator().manual_seed(L)
    for route, (N, background) in ROUTES.items():
        idx = _targets(g, L, N, background)
        G, S = idx.shape
        for planes, C in ((False, 3), (True, 5), (False, 131)):
            v = torch.randn(*((G, C, S) if planes else (G, S, C)), generator=g)
            v *= torch.exp(2.0 * torch.randn(1, generator=g))    # a scale far from 1
            want = kernels.scatter_add_plain(v, idx, N, planes)
            got = kernels.scatter_add(v.to(card), idx.to(card), N, planes=planes)
            where = f"{route}, planes={planes}, C={C}"
            assert _bits_equal(got.cpu(), want), \
                f"{where}: max |diff| {float((got.cpu() - want).abs().max())}"
            assert _bits_equal(got, kernels.scatter_add(v.to(card), idx.to(card), N,
                                                        planes=planes)), where
