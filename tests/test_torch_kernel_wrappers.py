"""The CUDA-side wrappers of the train attention's backward and the train
fusion head, driven with CPU tensors: the launch is replaced by a check of
its arguments against the C signature (``_lib.SIGNATURES``), so the route
each shape takes, the shapes and constants handed to the kernel and the
refusals before any launch are held here; the kernels themselves are held
against their plain versions on the card (``tests/test_torch_cuda.py``).
"""
import importlib

import pytest
import torch

from mocopci_torch.kernels import _lib

attention_train = importlib.import_module("mocopci_torch.kernels.attention_train")
fusion_head_train = importlib.import_module("mocopci_torch.kernels.fusion_head_train")


@pytest.fixture
def launches(monkeypatch):
    """Every launch's (name, arguments), after checking the argument count."""
    calls = []

    def launch(name, *args):
        assert len(args) == len(_lib.SIGNATURES[name]), name
        calls.append((name, args))

    monkeypatch.setattr(_lib, "launch", launch)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("D,route", [(8, "attention_train_bwd"), (64, "attention_train_bwd"),
                                     (65, "attention_train_bwd_wide"),
                                     (256, "attention_train_bwd_wide"),
                                     (2048, "attention_train_bwd_wide")])
def test_attention_train_bwd_takes_its_route_with_the_shape_and_dropout_constants(launches, D,
                                                                                route):
    G, N, M = 2, 33, 40
    q, k = torch.zeros(G, N, D), torch.zeros(G, M, D)
    seed = torch.zeros(1, dtype=torch.int32)
    dq, dk, dv = attention_train.attention_train_bwd(q, k, k, q, torch.zeros(G, N), q, seed,
                                                     0.125, 0.05)
    assert [name for name, _ in launches] == [route]
    args = launches[0][1]
    assert args[10:15] == (G, N, M, D, 0.125)
    assert args[16:18] == attention_train.dropout_constants(0.05)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_attention_train_bwd_refuses_head_dims_past_the_widest(launches):
    q = torch.zeros(1, 8, attention_train.MAX_D + 1)
    with pytest.raises(ValueError):
        attention_train.attention_train_bwd(q, q, q, q, torch.zeros(1, 8), q,
                                            torch.zeros(1, dtype=torch.int32), 1.0, 0.0)
    assert not launches


def _fusion_inputs(G, P):
    x = torch.zeros(G, 4, P)
    return x, [torch.zeros(s) for s in fusion_head_train._param_shapes()]


def test_fusion_head_train_fwd_runs_four_sweeps_on_the_fixed_grid(launches):
    x, params = _fusion_inputs(6, 5000)
    o, stats, _ = fusion_head_train.fusion_head_train_fwd(x, params, 3)
    assert [(name, args[6]) for name, args in launches] == [("fusion_head_train_fwd", m)
                                                             for m in range(4)]
    # mode, G, F, P, blocks
    assert all(args[6:11] == (m, 6, 3, 5000, fusion_head_train.BLOCKS)
               for m, (_, args) in enumerate(launches))
    assert o.shape == (6, 5000)
    assert [tuple(m.shape) for m, _ in stats] == [(3, 64), (3, 64), (3, 128)]


@pytest.mark.parametrize("F,fits", [(1, True), (5, True), (6, False)])
def test_fusion_head_train_refuses_groups_past_shared_memory(launches, F, fits):
    """Both directions' sweeps keep per-group rows in shared memory; the
    wrapper refuses more groups than the larger of the two holds before any
    launch."""
    assert (max(fusion_head_train._fwd_smem(F), fusion_head_train._bwd_smem(F))
            <= fusion_head_train._MAX_SMEM) == fits
    x, params = _fusion_inputs(F, 300)
    if fits:
        fusion_head_train.fusion_head_train_fwd(x, params, F)
        assert len(launches) == 4
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fusion_head_train.fusion_head_train_fwd(x, params, F)
        assert not launches
