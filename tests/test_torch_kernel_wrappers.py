"""The CUDA-side wrappers of the train and eval attention, the train and eval fusion
heads, the cost-volume tail, the transformer tail, exact and approximate kNN, the Chamfer keys
and FPS, driven
with CPU tensors: the launch is replaced by a check of its arguments against the C signature
(``_lib.SIGNATURES``), so the route each shape takes, the shapes and
constants handed to the kernel and the refusals before any launch are held
here; the kernels themselves are held against their plain versions on the
card (``tests/test_torch_cuda.py``).
"""
import importlib

import pytest
import torch

from mocopci_torch.kernels import _lib

attention = importlib.import_module("mocopci_torch.kernels.attention")
attention_train = importlib.import_module("mocopci_torch.kernels.attention_train")
cross_tail = importlib.import_module("mocopci_torch.kernels.cross_tail")
fps = importlib.import_module("mocopci_torch.kernels.fps")
fusion_head_train = importlib.import_module("mocopci_torch.kernels.fusion_head_train")
fusion_pair = importlib.import_module("mocopci_torch.kernels.fusion_pair")
knn = importlib.import_module("mocopci_torch.kernels.knn")
transformer_tail = importlib.import_module("mocopci_torch.kernels.transformer_tail")


@pytest.fixture
def launches(monkeypatch):
    """Every launch's (name, arguments), after checking the argument count."""
    calls = []

    def launch(name, *args):
        assert len(args) == len(_lib.SIGNATURES[name]), name
        calls.append((name, args))

    monkeypatch.setattr(_lib, "launch", launch)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "dispatch_device", lambda *t: "cuda")
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


@pytest.mark.parametrize("D,route", [(8, "attention_train_fwd"), (12, "attention_train_fwd"),
                                     (64, "attention_train_fwd"),
                                     (65, "attention_train_fwd_wide"),
                                     (256, "attention_train_fwd_wide"),
                                     (2048, "attention_train_fwd_wide")])
def test_attention_train_fwd_takes_its_route_with_the_shape_and_dropout_constants(launches, D,
                                                                                route):
    """The one-pass forward up to MAX_FWD_D, the wide route above, by D alone."""
    G, N, M = 2, 33, 40
    q, k = torch.zeros(G, N, D), torch.zeros(G, M, D)
    seed = torch.zeros(1, dtype=torch.int32)
    out, lse = attention_train.attention_train_fwd(q, k, k, seed, 0.125, 0.05)
    assert [name for name, _ in launches] == [route]
    args = launches[0][1]
    assert args[3:5] == (out.data_ptr(), lse.data_ptr())
    assert args[5:10] == (G, N, M, D, 0.125)
    assert args[11:13] == attention_train.dropout_constants(0.05)
    assert out.shape == q.shape and lse.shape == (G, N)


def test_attention_train_bwd_refuses_head_dims_past_the_widest(launches):
    q = torch.zeros(1, 8, attention_train.MAX_D + 1)
    with pytest.raises(ValueError):
        attention_train.attention_train_bwd(q, q, q, q, torch.zeros(1, 8), q,
                                            torch.zeros(1, dtype=torch.int32), 1.0, 0.0)
    with pytest.raises(ValueError):
        attention_train.attention_train_fwd(q, q, q, torch.zeros(1, dtype=torch.int32), 1.0, 0.0)
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


def test_fps_pyramid_is_one_launch_with_every_level(launches):
    xyz = torch.zeros(2, 8192, 3)
    idxs = fps.fps_pyramid(xyz, (2048, 512, 256, 64))
    assert [name for name, _ in launches] == ["fps_pyramid"]
    args = launches[0][1]
    assert args[1:3] == (2, 8192) and args[4] == 4       # B, N; levels
    assert [tuple(i.shape) for i in idxs] == [(2, 2048), (2, 512), (2, 256), (2, 64)]
    assert all(i.dtype == torch.int32 and i.is_contiguous() for i in idxs)
    fps.fps(xyz, 2048)
    assert launches[1][0] == "fps" and launches[1][1][1:4] == (2, 8192, 2048)


@pytest.mark.parametrize("call", [
    lambda x: fps.fps(x, 100), lambda x: fps.fps_pyramid(x, (100,))])
def test_fps_refuses_clouds_past_max_n(launches, call):
    with pytest.raises(ValueError, match="N <="):
        call(torch.zeros(1, fps.MAX_N + 1, 3))
    assert not launches


@pytest.mark.parametrize("levels", [(3000, 512), (2048, 4096), (256, 0), ()])
def test_fps_pyramid_refuses_a_level_past_the_one_before(launches, levels):
    """A level samples 1 to all of the points of the level before (equal
    levels are taken, as the TPU kernel takes them); more, none, or no level
    at all raises before any launch."""
    with pytest.raises(ValueError, match="fps_pyramid"):
        fps.fps_pyramid(torch.zeros(1, 2048, 3), levels)
    assert not launches


def _tail_inputs(B=2, M=50, N=40, K=32, C=64, C2=64):
    return (torch.zeros(B, M, C), torch.zeros(B, N, K, dtype=torch.int32), torch.zeros(B, N, C),
            torch.zeros(C, C2), torch.zeros(C2))


@pytest.mark.parametrize("K,dtype", [(32, torch.uint8), (300, torch.int32)])
def test_cross_tail_fwd_passes_its_argmax_or_none(launches, K, dtype):
    tab, idx, base, w, b = _tail_inputs(K=K, C=8, C2=16)
    assert cross_tail.argmax_dtype(K) == dtype
    cross_tail.cross_tail_fwd(tab, idx, base, w, b)
    amax = torch.empty(2, 40, 16, dtype=dtype)
    cross_tail.cross_tail_fwd(tab, idx, base, w, b, amax)
    (n0, a0), (n1, a1) = launches
    assert n0 == n1 == "cross_tail"
    assert a0[6] == 0 and a1[6] == amax.data_ptr()       # the argmax pointer, or null
    assert a0[7:13] == a1[7:13] == (2, 50, 40, K, 8, 16)  # B, M, N, K, C, C2


@pytest.mark.parametrize("B,N,K,tile,blocks", [
    (6, 2048, 32, 4, 264),    # the train step's call: more units than blocks
    (3, 2048, 32, 4, 264),    # the eval forward's
    (2, 301, 4, 16, 38),      # K padded to 8: 16 queries a unit, the last one ragged
    (2, 301, 30, 4, 151),
    (2, 50, 300, 1, 100),     # a query a unit, in chunks of 128 rows
    (1, 1, 32, 4, 1),
])
def test_cross_tail_fwd_walks_units_on_the_fixed_grid(launches, B, N, K, tile, blocks):
    """Units of whole queries (as many as 128 pair rows hold, K padded to
    8), one block a unit up to FWD_BLOCKS, the grid passed after the shape."""
    tab, idx, base, w, b = _tail_inputs(B=B, N=N, K=K)
    out = cross_tail.cross_tail_fwd(tab, idx, base, w, b)
    assert cross_tail.fwd_tile(K) == tile and cross_tail.fwd_grid(B, N, K) == blocks
    assert [name for name, _ in launches] == ["cross_tail"]
    args = launches[0][1]
    assert args[5:7] == (out.data_ptr(), 0)
    assert args[7:14] == (B, 50, N, K, 64, 64, blocks)
    assert out.shape == (B, N, 64)


@pytest.mark.parametrize("K,C,C2,route", [(32, 64, 64, "cross_tail"),
                                           (32, 128, 128, "cross_tail"),
                                           (4, 192, 64, "cross_tail_wide"),
                                           (32, 128, 256, "cross_tail_wide"),
                                           (32, 256, 256, "cross_tail_wide"),
                                           (64, 256, 256, "cross_tail_wide"),
                                           (300, 256, 64, None)])
def test_cross_tail_fwd_refuses_past_shared_memory(launches, K, C, C2, route):
    """The tiled forward's footprint (W and b in 64-column passes, x
    transposed, a chunk of 128 staged rows, base rows, maxima) past 227 KB
    takes the wide route, whose footprint is x alone (K padded to 8, by C
    padded to 4; cross3 of a 32768-point cloud is (32, 256, 256)); past that too the
    forward and the autograd forward are refused before any launch.  The
    autograd forward that needs a gradient is refused before any launch
    where no backward route fits (the wide backward's footprint is 4
    queries' rows and their gradients and argmax: it fits at (32, 256, 256)
    and not at (64, 256, 256)); at (4, 192, 64) the tiled backward fits."""
    assert (cross_tail._fwd_smem(K, C, C2) <= cross_tail._MAX_SMEM) == (route == "cross_tail")
    tab, idx, base, w, b = _tail_inputs(K=K, C=C, C2=C2)
    if route is None:
        with pytest.raises(ValueError, match="shared memory"):
            cross_tail.cross_tail_fwd(tab, idx, base, w, b)
        with pytest.raises(ValueError, match="shared memory"):
            cross_tail.cross_tail(tab, idx, base, w.requires_grad_(), b)
        assert not launches
        return
    cross_tail.cross_tail_fwd(tab, idx, base, w, b)
    assert [name for name, _ in launches] == [route]
    blocks = (cross_tail.fwd_grid(2, 40, K) if route == "cross_tail"
              else min(cross_tail.WIDE_BLOCKS, 2 * 40))
    assert launches[0][1][6:14] == (0, 2, 50, 40, K, C, C2, blocks)
    if (cross_tail._bwd_smem(K, C, C2) <= cross_tail._MAX_SMEM
            or cross_tail._bwd_wide_smem(K, C, C2) <= cross_tail._MAX_SMEM):
        cross_tail.cross_tail(tab, idx, base, w.requires_grad_(), b)
        assert [name for name, _ in launches] == [route, route]
        assert launches[1][1][6] != 0             # the argmax the backward reads
        return
    with pytest.raises(ValueError, match="backward.*shared memory"):
        cross_tail.cross_tail(tab, idx, base, w.requires_grad_(), b)
    assert len(launches) == 1


@pytest.mark.parametrize("D,route", [(8, "attention"), (6, "attention"), (64, "attention"),
                                     (65, "attention_wide"), (256, "attention_wide"),
                                     (512, "attention_wide")])
def test_attention_takes_its_route_with_the_shape_and_scale(launches, D, route):
    """The eval attention: the one-pass route up to MAX_ONE_PASS_D, the wide
    route above, by D alone; both get (q, k, v, out, G, N, M, D, scale)."""
    G, N, M = 3, 33, 40
    q, k = torch.zeros(G, N, D), torch.zeros(G, M, D)
    out = attention.attention(q, k, k, D ** -0.5)
    assert attention.route(D) == route
    assert [name for name, _ in launches] == [route]
    args = launches[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr())
    assert args[4:9] == (G, N, M, D, D ** -0.5)
    assert out.shape == (G, N, D)


@pytest.mark.parametrize("M", [0, attention.MAX_SEQ + 1])
def test_attention_refuses_keys_past_max_seq(launches, M):
    q, k = torch.zeros(2, 8, 16), torch.zeros(2, M, 16)
    with pytest.raises(ValueError, match="M <="):
        attention.attention(q, k, k, 0.25)
    assert not launches


@pytest.mark.parametrize("amax", [torch.empty(2, 40, 64, dtype=torch.int32),
                                  torch.empty(2, 40, 64, dtype=torch.int64),
                                  torch.empty(2, 40, 63, dtype=torch.uint8),
                                  torch.empty(2, 64, 40, dtype=torch.uint8)])
def test_cross_tail_refuses_an_argmax_of_the_wrong_type_or_shape(launches, amax):
    tab, idx, base, w, b = _tail_inputs()
    with pytest.raises(ValueError, match="argmax"):
        cross_tail.cross_tail_fwd(tab, idx, base, w, b, amax)
    with pytest.raises(ValueError, match="argmax"):
        cross_tail.cross_tail_bwd(tab, idx, base, w, torch.zeros(2, 40, 64), amax,
                                  torch.zeros(2, 40, 64))
    assert not launches


def test_cross_tail_bwd_takes_the_argmax_on_the_fixed_grid(launches):
    tab, idx, base, w, b = _tail_inputs(B=6, N=2048)
    out, amax = torch.zeros(6, 2048, 64), torch.zeros(6, 2048, 64, dtype=torch.uint8)
    d_rows, d_base, dw, db = cross_tail.cross_tail_bwd(tab, idx, base, w, out, amax, out)
    assert [name for name, _ in launches] == ["cross_tail_bwd"]
    args = launches[0][1]
    assert args[4:6] == (out.data_ptr(), amax.data_ptr())
    assert args[11:18] == (6, 50, 2048, 32, 64, 64, cross_tail.BWD_BLOCKS)
    assert d_rows.shape == (6, 2048, 32, 64) and d_base.shape == (6, 2048, 64)
    assert dw.shape == (64, 64) and db.shape == (64,)


def _transformer_tail_inputs(B, M, N, K, D):
    ws = []
    for ci in (3, D, D, D):
        ws += [torch.zeros(ci, D), torch.zeros(D)]
    return (torch.zeros(B, M, 3 + 2 * D), torch.zeros(B, N, K, dtype=torch.int32),
            torch.zeros(B, N, 3), torch.zeros(B, N, D), *ws, torch.zeros(B, N, D))


@pytest.mark.parametrize("B,N,K,blocks", [(6, 2048, 16, 132), (2, 300, 16, 75),
                                          (2, 301, 4, 19), (1, 2048, 4, 64)])
def test_transformer_tail_bwd_grid_and_partial_sums(launches, B, N, K, blocks):
    """One block a tile of 128 pair rows (128 / K queries), at most one an SM;
    a block's partial sums are the eight weight and bias gradients."""
    D = 64
    inputs = _transformer_tail_inputs(B, 50, N, K, D)
    d_rows, dxq, dq, *dws = transformer_tail.transformer_tail_bwd(*inputs)
    assert [name for name, _ in launches] == ["transformer_tail_bwd"]
    args = launches[0][1]
    assert args[18:24] == (B, 50, N, K, D, blocks)
    assert transformer_tail.bwd_grid(B, N, K) == blocks
    nacc = 3 * D * D + 7 * D
    assert [tuple(t.shape) for t in dws] == [(3, D), (D,), (D, D), (D,), (D, D), (D,), (D, D),
                                            (D,)]
    assert sum(t.numel() for t in dws) == nacc
    assert d_rows.shape == (B, N, K, 3 + 2 * D) and dxq.shape == (B, N, 3)
    assert dq.shape == (B, N, D)


@pytest.mark.parametrize("K,D", [(8, 64), (16, 32), (4, 128)])
def test_transformer_tail_bwd_refuses_other_shapes_before_any_launch(launches, K, D):
    """The (K, D) outside ``BWD_SHAPES``: (8, 64) and (16, 32) take the general
    routes of both directions, which the autograd forward lets through; (4, 128)
    needs more shared memory than a block has and is refused, by both, before
    any launch."""
    inputs = _transformer_tail_inputs(1, 50, 40, K, D)
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t for t in inputs[:-1]]
    if (K, D) == (4, 128):
        with pytest.raises(ValueError, match="transformer_tail backward.*shared memory"):
            transformer_tail.transformer_tail_bwd(*inputs)
        with pytest.raises(ValueError, match="transformer_tail backward.*shared memory"):
            transformer_tail.transformer_tail(*leaves)
        assert not launches
        return
    transformer_tail.transformer_tail_bwd(*inputs)
    transformer_tail.transformer_tail(*leaves)
    assert [name for name, _ in launches] == ["transformer_tail_bwd_general",
                                              "transformer_tail_general"]


@pytest.mark.parametrize("B,N,K,D,route,blocks", [
    (6, 2048, 16, 64, "transformer_tail_bwd", 132),        # ModelConfig(): tensor cores
    (2, 301, 4, 64, "transformer_tail_bwd", 19),           # the tiny configs
    (6, 2048, 8, 64, "transformer_tail_bwd_general", 132),  # refine_k = 8
    (1, 40, 28, 64, "transformer_tail_bwd_general", 40),   # the largest K at D = 64
    (2, 30, 16, 32, "transformer_tail_bwd_general", 60),   # a narrower head
])
def test_transformer_tail_bwd_takes_its_route_and_grid(launches, B, N, K, D, route, blocks):
    """The tensor-core kernel at ``BWD_SHAPES``; every other (K, D) that fits
    on the general route, a block a query up to one an SM."""
    inputs = _transformer_tail_inputs(B, 50, N, K, D)
    d_rows, dxq, dq, *dws = transformer_tail.transformer_tail_bwd(*inputs)
    assert [name for name, _ in launches] == [route]
    assert transformer_tail.bwd_route(K, D) == route
    args = launches[0][1]
    assert args[18:24] == (B, 50, N, K, D, blocks)
    assert args[17] is not None and d_rows.shape == (B, N, K, 3 + 2 * D)
    assert [tuple(t.shape) for t in dws] == [(3, D), (D,), (D, D), (D,), (D, D), (D,), (D, D),
                                            (D,)]


@pytest.mark.parametrize("K,D", [(29, 64), (32, 64), (1, 96)])
def test_transformer_tail_bwd_refuses_past_shared_memory(launches, K, D):
    """9 D^2 + 20 D + 6 K + 11 K D floats past 227 KB: refused by the
    backward and by the autograd forward, naming the limit, before any launch."""
    assert transformer_tail.general_floats(K, D) * 4 > 227 * 1024
    inputs = _transformer_tail_inputs(1, 50, 40, K, D)
    with pytest.raises(ValueError, match=f"past the {227 * 1024}"):
        transformer_tail.transformer_tail_bwd(*inputs)
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t for t in inputs[:-1]]
    with pytest.raises(ValueError, match="shared memory"):
        transformer_tail.transformer_tail(*leaves)
    with torch.no_grad():          # the forward alone still runs, on its general route
        transformer_tail.transformer_tail(*inputs[:-1])
    assert [name for name, _ in launches] == ["transformer_tail_general"]


@pytest.mark.parametrize("B,N,K,D,route,blocks", [
    (3, 2048, 16, 64, "transformer_tail", 132),             # the eval forward: tiled
    (6, 2048, 16, 64, "transformer_tail", 132),             # the train step
    (2, 301, 4, 64, "transformer_tail", 19),                # the tiny configs, a ragged tile
    (1, 40, 16, 64, "transformer_tail", 5),
    (6, 2048, 8, 64, "transformer_tail_general", 1536),     # refine_k = 8: 8 queries a block
    (2, 30, 16, 32, "transformer_tail_general", 8),         # a narrower head
    (1, 40, 28, 64, "transformer_tail_general", 5),
])
def test_transformer_tail_fwd_takes_its_route_and_grid(launches, B, N, K, D, route, blocks):
    """The tiled forward at ``BWD_SHAPES`` on a fixed grid (one block an
    SM, at most one a tile of 128 pair rows), passed after the shape; every
    other (K, D) on the general route, whose grid the entry point sets."""
    inputs = _transformer_tail_inputs(B, 50, N, K, D)[:-1]
    out = transformer_tail.transformer_tail_fwd(*inputs)
    assert [name for name, _ in launches] == [route]
    assert transformer_tail.fwd_route(K, D) == route
    assert transformer_tail.fwd_grid(B, N, K, route) == blocks
    args = launches[0][1]
    assert args[12] == out.data_ptr() and out.shape == (B, N, D)
    assert args[13:18] == (B, 50, N, K, D)
    assert args[18:-1] == ((blocks,) if route == "transformer_tail" else ())


@pytest.mark.parametrize("K,D", [(1, 256), (40, 128), (300, 64)])
def test_transformer_tail_fwd_refuses_past_shared_memory(launches, K, D):
    """3 D^2 + 8 D + 3 K + 3 K D floats past 227 KB: the general forward is
    refused, naming the limit, before any launch (with or without a
    gradient)."""
    assert (3 * D * D + 8 * D + 3 * K + 3 * K * D) * 4 > 227 * 1024
    inputs = _transformer_tail_inputs(1, 50, 40, K, D)[:-1]
    with pytest.raises(ValueError, match=f"transformer_tail forward.*past the {227 * 1024}"):
        transformer_tail.transformer_tail_fwd(*inputs)
    with torch.no_grad(), pytest.raises(ValueError, match="shared memory"):
        transformer_tail.transformer_tail(*inputs)
    assert not launches


@pytest.mark.parametrize("B,N,M,C,metric,chunk,blocks,qw", [
    (12, 8192, 8192, 3, "euclidean", 8192, 22, 2),   # the step's largest call: two blocks an SM
    (6, 8192, 8192, 3, "euclidean", 8192, 44, 2),
    (6, 2048, 2048, 3, "euclidean", 2048, 44, 2),
    (2, 512, 2048, 3, "euclidean", 2048, 64, 1),     # small grids: a query a warp
    (2, 64, 512, 3, "euclidean", 512, 8, 1),
    (1, 100, 20000, 3, "euclidean", 8192, 13, 1),    # a streamed reference: a block a group
    (2, 200, 2000, 5, "euclidean", 2048, 25, 1),     # eight planes
    (2, 2048, 2048, 64, "cosine", 0, 128, 1),        # the dot form: a block a group of 16
    (2, 200, 700, 20, "euclidean", 0, 13, 1),
])
def test_knn_approx_launch_arguments_and_grid(launches, B, N, M, C, metric, chunk, blocks, qw):
    knn_approx = importlib.import_module("mocopci_torch.kernels.knn_approx")
    k = 32 if M > 1024 else 16
    q, r = torch.zeros(B, N, C), torch.zeros(B, M, C)
    out = knn_approx.knn_approx(q, r, k, metric)
    assert [name for name, _ in launches] == ["knn_approx"]
    args = launches[0][1]
    tr, bits, fold = knn_approx.tiling(M, k)
    assert args[3:12] == (B, N, M, C, k, 1 if metric == "cosine" else 0, tr, bits, int(fold))
    assert args[12:15] == (chunk, blocks, qw) == knn_approx.launch_grid(B, N, M, C, tr, metric)
    assert args[15] == out.data_ptr() and out.shape == (B, N, k) and out.dtype == torch.int32
    if chunk:
        assert chunk % tr == 0 and chunk * (3 if C == 3 else 8) * 4 <= knn_approx.PLANE_BYTES


@pytest.mark.parametrize("G,N,M,threads,span,spans,query_blocks", [
    (30, 8192, 8192, 512, 12, 11, 2),    # the train step's loss: 5 pairs x B*F = 30 groups
    (3, 8192, 8192, 512, 6, 22, 2),      # the eval sample's CD
    (12, 2048, 2048, 256, 2, 16, 1),     # the loss at the pyramid's levels
    (12, 512, 512, 64, 1, 8, 1),
    (12, 256, 256, 32, 1, 4, 1),
    (2, 20000, 300, 512, 1, 5, 5),       # queries over 5 blocks, points in one span
    (1, 64, 64, 32, 1, 1, 1),            # one block: both outputs by plain stores
])
def test_chamfer_pair_launch_arguments_and_span_count(launches, G, N, M, threads, span, spans,
                                                      query_blocks):
    """The spans fill the card at the path's G (waves x span least, the
    longest span of equals); an output that more than one block writes is
    filled first (k12 with INT_MAX where spans > 1, k21 with the f32 max's
    bits where query blocks > 1), else left empty for plain stores."""
    chamfer_pair = importlib.import_module("mocopci_torch.kernels.chamfer_pair")
    assert chamfer_pair.launch_grid(G, N, M) == (threads, span, spans, query_blocks)
    assert span * (spans - 1) < -(-M // chamfer_pair.CHUNK) <= span * spans
    k12, k21 = chamfer_pair.chamfer_pair_keys(torch.zeros(G, N, 3), torch.zeros(G, M, 3))
    assert [name for name, _ in launches] == ["chamfer_pair"]
    args = launches[0][1]
    assert args[2:8] == (G, N, M, chamfer_pair.index_bits(N, M), threads, span)
    assert args[8:10] == (k12.data_ptr(), k21.data_ptr())
    assert k12.shape == (G, N) and k21.shape == (G, M) and k12.dtype == k21.dtype == torch.int32
    if spans > 1:
        assert bool((k12 == chamfer_pair.INT_MAX).all())
    if query_blocks > 1:
        assert bool((k21 == chamfer_pair.INF_KEY).all())


@pytest.mark.parametrize("G,N,M,D,rate", [(16, 256, 256, 256, 0.05), (16, 256, 256, 256, 0.0),
                                          (2, 33, 4096, 256, 0.05), (1, 40, 50, 512, 0.0)])
def test_attention_train_fwd_wide_launch_constants(launches, G, N, M, D, rate):
    """The wide forward gets the shape, the scale and the TPU kernel's dropout
    constants; rate 0 passes (0, 1.0), which picks the kernel without a hash."""
    q, k = torch.zeros(G, N, D), torch.zeros(G, M, D)
    seed = torch.zeros(1, dtype=torch.int32)
    out, lse = attention_train.attention_train_fwd(q, k, k, seed, D ** -0.5, rate)
    assert [name for name, _ in launches] == ["attention_train_fwd_wide"]
    args = launches[0][1]
    assert args[5:10] == (G, N, M, D, D ** -0.5) and args[10] == seed.data_ptr()
    assert args[11:13] == ((0, 1.0) if rate == 0.0 else attention_train.dropout_constants(rate))
    assert out.shape == (G, N, D) and lse.shape == (G, N)


def _eval_weights(widths=fusion_pair.WIDTHS):
    ws = []
    for ci, co in zip(widths[:-1], widths[1:]):
        ws += [torch.zeros(ci, co), torch.zeros(co)]
    return ws


@pytest.mark.parametrize("G,N,K2", [
    (3, 8192, 64),          # the eval forward: units of 8 slots, one block an SM
    (3, 400, 8),            # ragged: 4 query tiles (the last of 16), a unit a slot
    (2, 129, 9),            # 2 query tiles, 9 slots
    (1, 1, 1),
])
def test_fusion_pair_launch_arguments_and_fixed_grid(launches, G, N, K2):
    """One launch with the clouds, the folded weights, both outputs and the
    shape; the entry in C chooses its fixed grid and slot units from the shape
    (``csrc/fusion_pair.cu``), so no grid argument is passed."""
    torch.set_num_threads(1)
    p2, p1 = torch.zeros(G, 50, 3), torch.zeros(G, N, 3)
    idx = torch.zeros(G, N, K2, dtype=torch.int32)
    planes, logits = fusion_pair.fusion_pair(p2, idx, p1, *_eval_weights())
    assert [name for name, _ in launches] == ["fusion_pair"]
    args = launches[0][1]
    assert args[:3] == (p2.data_ptr(), idx.data_ptr(), p1.data_ptr())
    assert args[9:11] == (planes.data_ptr(), logits.data_ptr())
    assert args[11:] == (G, N, 50, K2, 0)
    assert planes.shape == (G, 4, N * K2) and logits.shape == (G, N * K2)


@pytest.mark.parametrize("widths", [(4, 64, 64, 64), (4, 32, 64, 128)])
def test_fusion_pair_refuses_other_widths_before_any_launch(launches, widths):
    p2, idx = torch.zeros(1, 50, 3), torch.zeros(1, 10, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="widths"):
        fusion_pair.fusion_pair(p2, idx, torch.zeros(1, 10, 3), *_eval_weights(widths))
    assert launches == []


def test_fusion_pair_planes_keeps_its_launch_arguments(launches):
    p2, p1 = torch.zeros(6, 8192, 3), torch.zeros(6, 8192, 3)
    idx = torch.zeros(6, 8192, 64, dtype=torch.int32)
    planes = fusion_pair.fusion_pair_planes_kernel(p2, idx, p1)
    assert [name for name, _ in launches] == ["fusion_pair_planes"]
    assert launches[0][1][3:8] == (planes.data_ptr(), 6, 8192, 8192, 64)


@pytest.mark.parametrize("B,N,M,C,metric,chunk,blocks,qw", [
    (6, 8192, 8192, 3, "euclidean", 8192, 44, 2),    # the fusion query: the cloud staged once
    (2, 500, 1500, 3, "euclidean", 1536, 63, 1),     # a small grid: a query a warp
    (1, 100, 20000, 3, "euclidean", 8192, 13, 1),    # streamed in chunks: a block a group
    (2, 301, 40, 5, "euclidean", 256, 38, 1),        # eight planes, one bin tile
    (2, 200, 9000, 8, "euclidean", 3072, 25, 1),     # eight planes streamed
])
def test_knn_takes_its_route_grid_and_buffer_constants(launches, B, N, M, C, metric, chunk,
                                                       blocks, qw):
    """Euclidean rows of at most 8 channels take the filtered scan with the
    planes grid over 256-column bin tiles and no split lists; the overflow
    counter is one int on the query's device."""
    torch.set_num_threads(1)
    k = min(32, M)
    q, r = torch.zeros(B, N, C), torch.zeros(B, M, C)
    out = knn.knn_exact(q, r, k, metric)
    assert [name for name, _ in launches] == ["knn"]
    args = launches[0][1]
    assert args[2:8] == (B, N, M, C, k, knn.METRICS[metric])
    assert args[8:11] == (chunk, blocks, qw) == knn.launch_grid(B, N, M, C, metric)
    assert args[11] == out.data_ptr() and out.shape == (B, N, k) and out.dtype == torch.int32
    counter = knn._overflow_counter(q.device)
    assert args[13] == counter.data_ptr() and counter.shape == (1,)
    assert counter.dtype == torch.int32
    assert chunk % knn.BIN_TILE == 0 and chunk * (3 if C == 3 else 8) * 4 <= knn.PLANE_BYTES


@pytest.mark.parametrize("B,N,M,C,metric,span,splits", [
    (1, 2048, 2048, 64, "cosine", 256, 8),     # the exact forward's cosine calls
    (1, 512, 512, 128, "cosine", 32, 16),
    (1, 256, 256, 256, "cosine", 32, 8),       # one tile a split
    (2, 2048, 2048, 64, "cosine", 416, 5),
    (2, 200, 700, 20, "euclidean", 64, 11),    # wide Euclidean rows: the dot form
    (6, 8192, 300, 16, "euclidean", 300 // 32 * 32 + 32, 1),   # the query blocks fill the card
])
def test_knn_dot_form_splits_the_reference_over_the_card(launches, B, N, M, C, metric, span,
                                                         splits):
    """The dot form splits the reference into spans of whole 32-row tiles
    until the grid gives about two blocks an SM (at most 16 spans)."""
    torch.set_num_threads(1)
    k = 16
    q, r = torch.zeros(B, N, C), torch.zeros(B, M, C)
    out = knn.knn_exact(q, r, k, metric)
    args = launches[0][1]
    assert args[8:11] == (span, splits, 0) == knn.launch_grid(B, N, M, C, metric)
    assert span % knn.DOT_ROWS == 0 and (splits - 1) * span < M <= splits * span
    assert splits <= knn.MAX_SPLITS and args[11] == out.data_ptr()


def test_knn_buffer_constants_match_the_kernel_source():
    """The wrapper's bin tile, candidate buffer, k limit and planes size are
    the CUDA source's."""
    from pathlib import Path

    src = (Path(knn.__file__).parents[1] / "csrc" / "knn.cu").read_text()
    planes = (Path(knn.__file__).parents[1] / "csrc" / "knn_planes.cuh").read_text()
    assert "constexpr int kBinNT = 8;" in src and knn.BIN_TILE == 32 * 8
    assert f"constexpr int kCap = {knn.CAP};" in src
    assert f"constexpr int kMaxK = {knn.MAX_K};" in src
    assert f"constexpr int kDotQ = {knn.DOT_QUERIES};" in src
    assert f"constexpr int kDotR = {knn.DOT_ROWS};" in src
    assert f"constexpr int kMaxSplits = {knn.MAX_SPLITS};" in src
    assert f"constexpr int kXPlaneBytes = {knn.PLANE_BYTES // 1024} * 1024;" in planes


@pytest.mark.parametrize("k,M,C", [(33, 100, 3), (8, knn.MAX_M + 1, 3), (8, 100, knn.MAX_C + 1)])
def test_knn_refuses_past_its_limits_before_any_launch(launches, k, M, C):
    q, r = torch.zeros(1, 4, C), torch.zeros(1, M, C)
    with pytest.raises(ValueError, match="knn kernel covers"):
        knn.knn_exact(q, r, k, "euclidean")
    assert launches == []
