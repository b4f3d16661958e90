"""The dense-stress configuration (16k-32k points a frame) held against the JAX
package on the CPU: the config itself, FPS's plain versions at stress sizes
against the JAX FPS (the XLA scan), the FPS wrappers' routes by cloud size
(the launch replaced by a record of its arguments, checked against the C
signature), and the eval forward at ``stress_model_config(1024)``.
"""
import ctypes
import dataclasses
import importlib
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mocopci_tpu import config as jax_config
from mocopci_tpu.models import MoCoPCI as JaxMoCoPCI
from mocopci_tpu.ops import sampling as jax_sampling
from mocopci_torch import MoCoPCI, interpolate, stress_model_config
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.kernels import _lib
from tests.torch_parity import exact_knn, init_jax  # noqa: F401  (fixture)

fps = importlib.import_module("mocopci_torch.kernels.fps")
FPS_SOURCE = Path(__file__).resolve().parents[1] / "mocopci_torch" / "csrc" / "fps.cu"


@pytest.mark.parametrize("npoints", [16384, 32768])
def test_stress_model_config_matches_jax(npoints):
    pc, jc = stress_model_config(npoints), jax_config.stress_model_config(npoints)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    pc.validate()
    assert pc.pyramid == (npoints // 4, npoints // 16, npoints // 32, npoints // 128)
    assert pc.refine_npoint == npoints // 4


def _cloud(N, seed, dup):
    """(1, N, 3) f32; with ``dup`` the upper half repeats the lower half, so
    each point has a twin N/2 further on, across every split of the cloud
    into the spans of 2, 4 or 8 blocks, and every step's argmax ties."""
    xyz = (np.random.default_rng(seed).normal(size=(1, N, 3)) * 10).astype(np.float32)
    if dup:
        xyz[:, N // 2:] = xyz[:, :N - N // 2]
    return xyz


@pytest.mark.parametrize("N,npoint,dup", [(16384, 256, False), (20000, 128, True)])
def test_fps_plain_matches_jax_at_stress_sizes(N, npoint, dup):
    xyz = _cloud(N, 11, dup)
    got = fps.fps_plain(torch.from_numpy(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sampling.farthest_point_sample(xyz,
                                                                                      npoint)))
    if dup:
        assert (got < N // 2).all()         # every tie went to the lower twin
    levels = (npoint, npoint // 4, npoint // 8)
    want = jax_sampling.farthest_point_sample_pyramid(xyz, levels)
    for a, b in zip(fps.fps_pyramid_plain(torch.from_numpy(xyz), levels), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture
def launches(monkeypatch):
    """Every launch's (name, arguments, levels read from the host pointer of
    a pyramid's level list), after checking the argument count."""
    calls = []

    def launch(name, *args):
        assert len(args) == len(_lib.SIGNATURES[name]), name
        levels = (tuple((ctypes.c_int * args[4]).from_address(args[3]))
                  if name.startswith("fps_pyramid") else None)
        calls.append((name, args, levels))

    monkeypatch.setattr(_lib, "launch", launch)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "dispatch_device", lambda *t: "cuda")
    monkeypatch.setattr(_lib, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("npoints", [16384, 32768])
def test_stress_pyramid_is_one_cluster_launch_with_every_level(launches, npoints):
    cfg = stress_model_config(npoints)
    idxs = fps.fps_pyramid(torch.zeros(2, npoints, 3), cfg.pyramid)
    assert [(name, levels) for name, _, levels in launches] == [("fps_pyramid_cluster",
                                                                  cfg.pyramid)]
    args = launches[0][1]
    assert args[1:3] == (2, npoints) and args[4:6] == (4, fps.CLUSTER)
    assert [tuple(i.shape) for i in idxs] == [(2, n) for n in cfg.pyramid]
    assert all(i.dtype == torch.int32 and i.is_contiguous() for i in idxs)


def test_stress_refine_fps_is_one_cluster_launch(launches):
    out = fps.fps(torch.zeros(3, 32768, 3), 8192)
    assert [name for name, _, _ in launches] == ["fps_cluster"]
    assert launches[0][1][1:5] == (3, 32768, 8192, fps.CLUSTER)
    assert out.shape == (3, 8192) and out.dtype == torch.int32


def test_fps_at_8192_points_keeps_the_one_block_routes(launches):
    fps.fps_pyramid(torch.zeros(2, 8192, 3), (2048, 512, 256, 64))
    fps.fps(torch.zeros(3, 8192, 3), 2048)
    assert [(name, levels) for name, _, levels in launches] == [
        ("fps_pyramid", (2048, 512, 256, 64)), ("fps", None)]


@pytest.mark.parametrize("call", [lambda x: fps.fps(x, 100),
                                  lambda x: fps.fps_pyramid(x, (100, 10))])
def test_fps_above_the_cap_raises_before_any_launch(launches, call):
    with pytest.raises(ValueError, match="N <="):
        call(torch.zeros(1, fps.MAX_N + 1, 3))
    assert not launches


@pytest.mark.parametrize("levels", [(16384, 4096), (8193, 100), (32768, 9000, 10)])
def test_fps_cluster_refuses_what_a_block_cannot_hold(launches, levels):
    """A pyramid's later levels run on the cluster's first block, at most
    8192 points each: a level after the first over 8192 points raises
    before any launch."""
    with pytest.raises(ValueError, match="fps"):
        fps.fps_pyramid(torch.zeros(1, fps.MAX_N, 3), levels)
    assert not launches


def _constants(src):
    """The ``constexpr`` ints of a CUDA source, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        env[name] = int(eval(expr.replace("/", "//"), {}, env))
    return env


def test_fps_cluster_constants_match_the_kernel_source():
    """The wrapper's sizes against the kernel's, and the exchange's layout:
    an entry of 20 bytes (distance bits, global index, x, y, z) in a room a
    whole number of 16-byte stores wide, a slot for each warp of the cluster
    in each parity, the two mbarriers on 8 bytes after the slots, the bytes
    a step within an mbarrier's tx-count, and the largest cluster launch (8
    blocks of 8192 points, a pyramid whose level 1 takes 8192) within a
    block's 227 KB."""
    c = _constants(FPS_SOURCE.read_text())
    assert fps.BLOCK_MAX_N == c["kMaxThreads"] * 32 == c["kMaxBlockN"]
    assert fps.CLUSTER == c["kMaxCluster"] == 8
    assert fps.MAX_N == fps.CLUSTER * fps.BLOCK_MAX_N
    assert c["kEntryBytes"] == 5 * 4 <= c["kEntryFloats"] * 4
    assert c["kEntryFloats"] * 4 % 16 == 0
    assert c["kSlotsPerParity"] == c["kMaxCluster"] * c["kMaxThreads"] // 32
    slots = 2 * c["kSlotsPerParity"] * c["kEntryFloats"]
    assert c["kExchangeFloats"] == slots + 4 and slots * 4 % 8 == 0
    assert c["kSlotsPerParity"] * c["kEntryBytes"] < 2 ** 20
    smem = 4 * (c["kExchangeFloats"] + c["kSlotFloats"] + 3 * 2 * fps.BLOCK_MAX_N)
    assert smem <= 232448


def _c_signature(name):
    """ctypes argument types of ``mocopci_<name>`` as ``fps.cu`` declares it,
    with each parameter's name."""
    m = re.search(rf"MOCOPCI_API int mocopci_{name}\(([^)]*)\)", FPS_SOURCE.read_text())
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return ([_lib._P if "*" in p else _lib._I for p in params],
            [p.replace("*", " ").split()[-1] for p in params])


@pytest.mark.parametrize("name,call", [
    ("fps_cluster", lambda: fps.fps(torch.zeros(3, 32767, 3), 8191)),
    ("fps_pyramid_cluster", lambda: fps.fps_pyramid(torch.zeros(2, 32767, 3),
                                                    (8191, 2047, 1023, 255)))])
def test_fps_cluster_launch_matches_the_c_signature(launches, name, call):
    """The wrapper's arguments against ``fps.cu``'s C entry: the types and
    order of the parameters as the source declares them, and the launch's
    cluster size, cloud count and size, each block's span ceil(N / cluster)
    within a block."""
    call()
    types, names = _c_signature(name)
    assert _lib.SIGNATURES[name] == types
    [(got, args, _)] = launches
    assert got == name and len(args) == len(names)
    arg = dict(zip(names, args))
    assert names[-1] == "stream" and arg["stream"] == 0    # the fixture's stream
    assert arg["cluster"] == fps.CLUSTER and arg["N"] == 32767
    assert arg["B"] == (3 if name == "fps_cluster" else 2)
    assert -(-arg["N"] // arg["cluster"]) <= fps.BLOCK_MAX_N


def _calm(path, leaf):
    """The aggregation Dense after each PointConv (flax name ``linear``) at
    1/32 of its weights, as the port's own init draws it at 1/K: at K = 32
    and lecun scale a random model's output reaches 1e4 and turns on float
    rounding, in each package alike (``scripts/torch_stress_chaos.py``: the
    inputs moved by one ulp move JAX's own output by 4766 and the port's by
    4765, past the two packages' 2574 on the same inputs)."""
    keys = [getattr(p, "key", "") for p in path]
    return leaf / 32 if keys[-2:] == ["linear", "kernel"] else leaf


def test_stress_eval_forward_matches_jax():
    """The whole eval forward at stress_model_config(1024): the stress ratios
    (pyramid 256/64/32/8, refine head 256) and the production kNN sizes, k
    clamped to the smaller levels in both packages; exact kNN mode."""
    n = 1024
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(1, n, 3)).astype(np.float32)
    x2 = (x1 + 0.05 * rng.normal(size=x1.shape)).astype(np.float32)
    jm = JaxMoCoPCI(jax_config.stress_model_config(n))
    variables = jax.tree_util.tree_map_with_path(_calm, init_jax(jm, rng, x1, x2))
    want = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False)["out"])(
        variables, x1, x2))
    model = MoCoPCI(stress_model_config(n), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    got = interpolate(model, x1, x2)
    assert got.shape == (1, 3, n, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
