"""Fast checks of the PyTorch port's configuration, bridge and dispatch.

No JAX model is built here: these tests run in well under a second each.
"""
import dataclasses
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

from mocopci_tpu import config as jax_config
from mocopci_torch import config as port_config
from mocopci_torch import kernels
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.kernels import _lib


@pytest.mark.parametrize("npoints", [None, 64, 256])
def test_model_config_matches_jax(npoints):
    if npoints is None:
        jc, pc = jax_config.ModelConfig(), port_config.ModelConfig()
    else:
        jc = jax_config.tiny_model_config(npoints)
        pc = port_config.tiny_model_config(npoints)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.levels == jc.levels


def test_timestamps_match_jax():
    assert port_config.timestamps() == jax_config.timestamps()
    assert port_config.timestamps(0.0, 2.0) == jax_config.timestamps(0.0, 2.0)
    cfg = port_config.ModelConfig()
    assert port_config.timestamps() == (cfg.t_forward, cfg.t_backward)
    with pytest.raises(ValueError):
        port_config.timestamps(interval=3)


def test_validate_rejects_growing_pyramid():
    port_config.ModelConfig().validate()
    with pytest.raises(ValueError):
        port_config.ModelConfig(pyramid=(64, 128, 32, 16)).validate()
    with pytest.raises(ValueError):
        port_config.ModelConfig(npoints=1024, pyramid=(256, 64, 32, 16)).validate()


def test_bridge_maps_names_and_orientation():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(3, 5)).astype(np.float32)
    tree = {
        "params": {
            "enc": {"lin": {"kernel": kernel, "bias": np.ones(5, np.float32)}},
            "bn": {"scale": np.full(4, 2.0, np.float32), "bias": np.zeros(4, np.float32)},
            "act": {"alpha": np.asarray(0.3, np.float32)},
            "mlp": {"dw_scale": np.ones(6, np.float32), "dw_bias": np.zeros(6, np.float32)},
            "inj": {"gamma": np.zeros(7, np.float32)},
        },
        "batch_stats": {"bn": {"mean": np.zeros(4, np.float32),
                               "var": np.ones(4, np.float32)}},
    }
    sd = params_from_jax(tree)
    assert sorted(sd) == sorted([
        "enc.lin.weight", "enc.lin.bias", "bn.weight", "bn.bias", "act.alpha",
        "mlp.dw_scale", "mlp.dw_bias", "inj.gamma", "bn.running_mean", "bn.running_var",
    ])
    np.testing.assert_array_equal(sd["enc.lin.weight"].numpy(), kernel.T)
    assert sd["act.alpha"].shape == ()
    with pytest.raises(KeyError):
        params_from_jax({"params": {"x": {"embedding": kernel}}})


def test_wrappers_take_plain_path_only_on_cpu():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError):
        kernels.fps(xyz.to("meta"), 4)
    with pytest.raises(ValueError):
        kernels.knn_exact(xyz, xyz.to("meta"), 2, "euclidean")
    with pytest.raises(ValueError):
        kernels.knn_exact(xyz, xyz, 2, "manhattan")
    with pytest.raises(ValueError):
        kernels.knn_approx(xyz, xyz.to("meta"), 2, "euclidean")
    with pytest.raises(ValueError):
        kernels.knn_approx(xyz, xyz, 2, "manhattan")
    with pytest.raises(ValueError):
        kernels.chamfer_pair_keys(xyz, xyz.to("meta"))
    with pytest.raises(ValueError):
        _lib.check_cuda("x", xyz, torch.float32, 3)


def test_model_needs_a_card_unless_cpu_is_asked():
    from mocopci_torch import MoCoPCI

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        MoCoPCI(port_config.tiny_model_config(64))


def test_time_embedding_and_area_matrix_match_jax():
    from mocopci_tpu.models import area_resize_matrix as jax_area
    from mocopci_tpu.models import time_embedding as jax_emb
    from mocopci_torch.models import area_resize_matrix, time_embedding

    cfg = port_config.ModelConfig()
    for dim in (7, 64, 128):
        np.testing.assert_array_equal(time_embedding(cfg.t_forward, dim),
                                      np.asarray(jax_emb(cfg.t_forward, dim)))
    for n_in, n_out in ((3, 32), (3, 5), (8, 3)):
        np.testing.assert_array_equal(area_resize_matrix(n_in, n_out),
                                      np.asarray(jax_area(n_in, n_out)))


def test_knn_mode_defaults_to_approx_as_jax():
    from mocopci_tpu.ops import distance as jax_distance
    from mocopci_torch.ops import distance

    src = pathlib.Path(jax_distance.__file__).read_text()
    assert re.search(r'^_KNN_MODE = "approx"$', src, re.M)
    assert distance.get_knn_mode() == "approx" and distance.MODES == ("approx", "exact")
    with pytest.raises(ValueError):
        distance.set_knn_mode("fast")


def test_chamfer_supported_and_knn_tiling_match_jax():
    """The port's dispatch sizes: chamfer_pair.supported as JAX's, and the
    approx kNN's tile, index bits and fold condition as fused_knn_pallas's."""
    from mocopci_tpu.ops.pallas import chamfer_pair as jax_cp
    from mocopci_torch.kernels.knn_approx import tiling

    port_cp = importlib.import_module("mocopci_torch.kernels.chamfer_pair")
    for n in (8, 64, 100, 128, 512, 1000, 1024, 1536, 2048, 8192, 16384):
        for m in (64, 128, 256, 1024, 1536, 8192):
            assert port_cp.supported(n, m) == jax_cp.supported(n, m), (n, m)
    assert tiling(300, 9) == (384, 9, False)
    assert tiling(1024, 32) == (1024, 10, False)
    assert tiling(1500, 8) == (1024, 11, True)
    assert tiling(8192, 32) == (1024, 13, True)
    assert tiling(8192, 400) == (1024, 13, False)
    assert tiling(64, 16) == (128, 6, False)
