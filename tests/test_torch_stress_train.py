"""The dense-stress train step's new reach held against the JAX package on the
CPU: the dropout counter past 4096 keys (unique, and the TPU kernel's bits up
to 4096), the train attention, ``CrossAttention`` and ``MultiFrameBlock`` in
train mode past 4096 keys against JAX's train path at rate 0 (its chunked
XLA attention there), the cost-volume tail's VJP at C = C2 = 256, the routes
of the cost-volume tail and of the eval attention by size (the launch
replaced by a record of its arguments), and one train step's loss and
gradients at ``stress_model_config(128)``.
"""
import dataclasses
import functools
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocopci_tpu import config as jax_config
from mocopci_tpu import nn as jnn
from mocopci_tpu.config import TrainConfig as JaxTrainConfig
from mocopci_tpu.models import MoCoPCI as JaxMoCoPCI
from mocopci_tpu.nn import attention as jattention
from mocopci_tpu.ops.pallas.attention_train import keep_mask_reference
from mocopci_tpu.ops.pallas.cross_tail import cross_tail as jax_cross_tail
from mocopci_tpu.training.loss import mocopci_loss as jax_loss
from mocopci_torch import MoCoPCI, kernels, stress_model_config
from mocopci_torch import nn as pnn
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.config import TrainConfig
from mocopci_torch.training.loop import loss_and_grads
from tests.test_torch_stress import _calm, launches  # noqa: F401  (fixture)
from tests.torch_parity import assert_close, exact_knn, init_jax, load, np_tree, t  # noqa: F401

attention_mod = importlib.import_module("mocopci_torch.kernels.attention")
attention_train_mod = importlib.import_module("mocopci_torch.kernels.attention_train")
cross_tail_mod = importlib.import_module("mocopci_torch.kernels.cross_tail")
CSRC = Path(__file__).resolve().parents[1] / "mocopci_torch" / "csrc"
LONG = 4160      # keys past the TPU kernel's 4096 (a 64-key tile and one more)
NO_DROPOUT = dict(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_dropout_counter_is_unique_past_4096_keys():
    """The TPU kernel's (row << 12) ^ col aliases past 4096 keys ((0, 4096)
    against (1, 0)); the port's shift grows with M, so N = 3, M = 8200 gives
    3 x 8200 distinct counters."""
    N, M = 3, 8200
    assert attention_train_mod.row_shift(M) == 14
    assert [attention_train_mod.row_shift(m) for m in (1, 4096, 4097, 8192)] == [12, 12, 13, 13]
    ctr = attention_train_mod.dropout_counter(N, M)
    assert ctr.shape == (N, M) and torch.unique(ctr).numel() == N * M
    assert int(ctr.max()) < 2 ** 32
    assert (1 << 12) ^ 0 == 0 << 12 ^ 4096        # the TPU counter's collision
    assert ctr[1, 0] != ctr[0, 4096]
    mask = attention_train_mod.keep_mask_plain(-5, 2, N, M, 0.05)
    assert not torch.equal(mask[0, 1, :M - 4096], mask[0, 0, 4096:])
    assert 0.9 < float((mask > 0).float().mean()) < 0.99


@pytest.mark.parametrize("M", [4096, 333])
def test_keep_mask_up_to_4096_keys_is_the_tpu_mask(M):
    seed, N, rate = 987654321, 5, 0.05
    got = attention_train_mod.keep_mask_plain(seed, 3, N, M, rate)
    for g in range(3):
        want = np.asarray(keep_mask_reference(jnp.int32(seed), g, N, M, rate))
        np.testing.assert_array_equal(got[g].numpy(), want)


def test_every_cuda_site_takes_the_counter_from_row_shift():
    """The forward bodies (both routes, shared with the eval attention) and
    the backward's keep factor shift the row by ``row_shift(M)``, defined
    once as ``row_shift`` of the wrapper: max(12, ceil(log2 M))."""
    fwd = (CSRC / "attention_fwd.cuh").read_text()
    train = (CSRC / "attention_train.cu").read_text()
    body = re.search(r"int row_shift\(int M\) \{(.*?)\n\}", fwd, re.S).group(1)
    assert "int s = 12;" in body and "(1 << s) < M" in body
    assert "(static_cast<uint32_t>(i) << row_shift(M))" in fwd             # one-pass body
    assert "(static_cast<uint32_t>(i0 + sr) << row_shift(M))" in fwd       # wide body
    assert "<< 12" not in fwd and "<< 12" not in train
    assert train.count("const int sh = row_shift(M);") == 2
    assert "(static_cast<uint32_t>(row) << sh)" in train


def _to_heads(x):
    """(G, L, D) with G heads -> JAX's (1, 1, L, G, D) layout."""
    return jnp.asarray(x.transpose(1, 0, 2)[None, None])


def test_attention_train_past_4096_keys_matches_jax_train_path():
    """(G, N, M, D) = (2, 64, 4160, 8) at rate 0 against JAX's train path
    there, ``_chunked_mha_dropout``: output and gradients within 1e-5."""
    rng = np.random.default_rng(21)
    G, N, M, D, scale = 2, 64, LONG, 8, 8 ** -0.5
    q, k, v, co = _np(rng, G, N, D), _np(rng, G, M, D), _np(rng, G, M, D), _np(rng, G, N, D)

    def loss(q, k, v):
        out = jattention._chunked_mha_dropout(q, k, v, scale, 0.0, jax.random.PRNGKey(0))
        out = out[0, 0].transpose(1, 0, 2)
        return jnp.sum(out * co), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        _to_heads(q), _to_heads(k), _to_heads(v))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = kernels.attention_train(*leaves, torch.zeros(1, dtype=torch.int32), scale, 0.0)
    (out * t(co)).sum().backward()
    assert_close(out, want, atol=1e-5, rtol=1e-5)
    for leaf, g in zip(leaves, grads):
        assert_close(leaf.grad, np.asarray(g)[0, 0].transpose(1, 0, 2), atol=1e-5, rtol=1e-4)


def _train_apply(jax_module, variables, inputs, **kwargs):
    """(outputs, input gradients) of the module in train mode at rate 0, the
    cotangent of every output leaf 1."""
    def f(*xs):
        out, _ = jax_module.apply(variables, *xs, **kwargs,
                                  rngs={"dropout": jax.random.PRNGKey(0)},
                                  mutable=["batch_stats"])
        return sum(jnp.sum(o) for o in jax.tree_util.tree_leaves(out)), out

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(len(inputs))),
                                         has_aux=True)(*inputs)
    return out, grads


def _port_train(module, *inputs):
    leaves = [t(x).requires_grad_() for x in inputs]
    out = module.train()(*leaves, train=True)
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))).backward()
    return out, [leaf.grad for leaf in leaves]


def test_cross_attention_trains_past_4096_keys_like_jax():
    """2048 queries over 4160 keys: JAX trains through its chunked XLA path
    (N·M past 8·2^20), the port through ``attention_train``'s twin."""
    rng = np.random.default_rng(22)
    x, c = _np(rng, 1, 2048, 8), _np(rng, 1, LONG, 8)
    jm = jnn.CrossAttention(8, num_heads=2)
    variables = init_jax(jm, rng, x, c)
    want, grads = _train_apply(jm, variables, (x, c), deterministic=False)
    got, got_grads = _port_train(load(pnn.CrossAttention(8, 2), variables), x, c)
    assert_close(got, want)
    for g, w in zip(got_grads, grads):
        assert_close(g, w)


def test_multi_frame_block_trains_past_4096_keys_like_jax():
    """(B, F, N, C) = (1, 3, 4160, 8), one head, rates 0: every token
    attends over 4160 keys (JAX's chunked XLA path, the port's
    ``attention_train``), BatchNorm on batch statistics."""
    rng = np.random.default_rng(23)
    xs = _np(rng, 1, 3, LONG, 8)
    kw = dict(num_heads=1, drop=0.0, attn_drop=0.0, drop_path=0.0)
    jm = jnn.MultiFrameBlock(8, 8, **kw)
    variables = init_jax(jm, rng, xs)
    want, grads = _train_apply(jm, variables, (xs,), train=True, deterministic=False)
    got, got_grads = _port_train(load(pnn.MultiFrameBlock(8, 8, **kw), variables), xs)
    for g, w in zip(got, want):
        assert_close(g, w)
    assert_close(got_grads[0], grads[0])


def test_cross_tail_vjp_at_256_channels_matches_jax_with_duplicate_ties():
    """C = C2 = 256, K = 32 (cross3 of a 32768-point cloud), neighbour 1 a
    duplicate of neighbour 0 so every max ties: the VJP against the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(24)
    G, M, S, K, C = 1, 64, 6, 32, 256
    tab, base = _np(rng, G, M, C), _np(rng, G, S, C)
    w, b = _np(rng, C, C, scale=C ** -0.5), _np(rng, C, scale=0.1)
    idx = rng.integers(0, M, size=(G, S, K)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    co = _np(rng, G, S, C)
    idx_km = jnp.asarray(idx.transpose(0, 2, 1).reshape(G, K * S))

    def loss(tab, base, w, b):
        rows = jnp.take_along_axis(tab, idx_km[..., None], axis=1)
        out = jax_cross_tail(rows, base, w, b, K, True)
        return jnp.sum(jnp.sin(out) * co), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        tab, base, w, b)
    leaves = [t(a).requires_grad_() for a in (tab, base, w, b)]
    out = kernels.cross_tail(leaves[0], t(idx), *leaves[1:])
    (torch.sin(out) * t(co)).sum().backward()
    assert_close(out, want, atol=1e-5, rtol=1e-5)
    for leaf, g, name in zip(leaves, grads, ("tab", "base", "w", "b")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _tail_leaves(K, C, C2, N=1024):
    tab = torch.zeros(1, N, C, requires_grad=True)
    base = torch.zeros(1, N, C, requires_grad=True)
    w = torch.zeros(C, C2, requires_grad=True)
    b = torch.zeros(C2, requires_grad=True)
    return tab, torch.zeros(1, N, K, dtype=torch.int32), base, w, b


@pytest.mark.parametrize("K,C,C2,routes", [
    (32, 256, 256, ["cross_tail_wide", "cross_tail_bwd_wide"]),   # cross3 at 32768 points
    (32, 64, 64, ["cross_tail", "cross_tail_bwd"]),                # L1 at every size
    (64, 256, 256, ["cross_tail_wide", "cross_tail_bwd_wide"]),   # K = 64 at C = 256
    (129, 256, 256, ["cross_tail_wide", "cross_tail_bwd_wide"]),  # the bucketed form's K limit
    (32, 128, 512, ["cross_tail_wide", "cross_tail_bwd_wide"]),   # C2 > 256: the general form
])
def test_cross_tail_takes_its_routes_both_ways(launches, K, C, C2, routes):
    tab, idx, base, w, b = _tail_leaves(K, C, C2)
    assert cross_tail_mod.fwd_route(K, C, C2) == routes[0]
    assert cross_tail_mod.bwd_route(K, C, C2) == routes[1]
    cross_tail_mod.cross_tail(tab, idx, base, w, b).sum().backward()
    tails = [(name, args) for name, args, _ in launches if name.startswith("cross_tail")]
    assert [name for name, _ in tails] == routes
    args = tails[1][1]
    assert args[11:18] == (1, 1024, 1024, K, C, C2, args[17])
    form = cross_tail_mod.bwd_wide_form(K, C, C2)
    if routes[1] == "cross_tail_bwd_wide" and form == "bucketed":   # 8 slices by 33 spans
        assert args[17] == cross_tail_mod.bwd_wide_spans(1, 1024, C) == 33
    elif routes[1] == "cross_tail_bwd_wide":     # the general form: a block a group of 4 queries
        assert args[17] == min(cross_tail_mod.BWD_WIDE_BLOCKS, 1024 // 4)
    assert tab.grad.shape == tab.shape and w.grad.shape == (C, C2)


@pytest.mark.parametrize("K,C,C2,grad", [(130, 256, 256, True), (64, 256, 512, True),
                                         (32, 2048, 2048, False)])
def test_cross_tail_refuses_a_shape_no_route_takes_before_any_launch(launches, K, C, C2, grad):
    """K = 130 at C = C2 = 256 and K = 64 at (C, C2) = (256, 512): the wide
    forward fits, no backward does (the wide backward's bucketed form stops
    at K = 129 for C2 = 256 and takes C2 <= 256; its general form needs 4
    queries' K * C rows, past shared memory at both), so a call that needs a
    gradient raises before the forward; C = 2048: no forward fits."""
    tab, idx, base, w, b = _tail_leaves(K, C, C2, N=16)
    with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="shared memory"):
        cross_tail_mod.cross_tail(tab, idx, base, w, b)
    assert not launches


def _cross_tail_source():
    return (CSRC / "cross_tail.cu").read_text()


def _c_constants():
    """The ``constexpr`` integers of ``cross_tail.cu`` declared one a line,
    each evaluated in order (C's integer division)."""
    consts = {}
    for name, expr in re.findall(r"constexpr (?:int|size_t) (k\w+) = ([^;,]+);",
                                 _cross_tail_source()):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    return consts


def _c_function(name):
    """A ``cross_tail.cu`` function of one ``return`` as a Python function of
    its int parameters (casts dropped, C's integer division)."""
    m = re.search(rf"inline \w+ {name}\(([^)]*)\) \{{\s*return ([^;]+);", _cross_tail_source())
    params = [p.split()[-1] for p in m.group(1).split(",")]
    body = re.sub(r"static_cast<\w+>", "", " ".join(m.group(2).split())).replace("/", "//")
    calls = {f: _c_function(f) for f in re.findall(r"(\w+)\(", body) if f != name}
    return lambda *a: eval(body, calls, {**_c_constants(), **dict(zip(params, a))})


def test_cross_tail_bwd_wide_launch_matches_the_c_signature(launches):
    """The wrapper's arguments against ``cross_tail.cu``'s C entry: the types
    and order of the parameters as the source declares them, and the
    launch's shape and spans at cross3 of the 32768-point step."""
    from mocopci_torch.kernels import _lib

    tab, idx, base, w, b = _tail_leaves(32, 256, 256)
    cross_tail_mod.cross_tail(tab, idx, base, w, b).sum().backward()
    m = re.search(r"MOCOPCI_API int mocopci_cross_tail_bwd_wide\(([^)]*)\)", _cross_tail_source())
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert _lib.SIGNATURES["cross_tail_bwd_wide"] == [_lib._P if "*" in p else _lib._I
                                                      for p in params]
    names = [p.replace("*", " ").split()[-1] for p in params]
    [args] = [a for name, a, _ in launches if name == "cross_tail_bwd_wide"]
    arg = dict(zip(names, args))
    assert len(args) == len(names) and names[-1] == "stream" and arg["stream"] == 0
    assert [arg[k] for k in ("B", "M", "N", "K", "C", "C2", "parts")] == [1, 1024, 1024, 32, 256,
                                                                          256, 33]


@pytest.mark.parametrize("B,N,K,C,C2", [(1, 1024, 32, 256, 256), (6, 2048, 32, 64, 64),
                                        (2, 3, 129, 300, 256), (1, 9, 1, 8, 1),
                                        (1, 1024, 32, 128, 512), (1, 50, 300, 8, 16)])
def test_cross_tail_bwd_wide_grid_matches_the_c_constants(launches, monkeypatch, B, N, K, C, C2):
    """The wrapper's slice, groups, C2 limit and both forms' shared memory
    against the constants, ``bwd_wide_smem_floats`` and
    ``bwd_wide_general_smem_floats`` of ``cross_tail.cu``.  Bucketed: its
    spans within the C entry's bound (a group each) and about
    BWD_WIDE_BLOCKS blocks; its scratch each query's two orders (C2 rounded
    up to 4 pairs each) and bucket starts, and one partial (C * C2 + C2
    floats) a span.  General (C2 > 256, K = 300): at most BWD_WIDE_BLOCKS
    blocks, a group of 4 queries each; its scratch W transposed and a
    partial a block."""
    consts = _c_constants()
    assert tuple(consts[k] for k in ("kWS", "kWQ", "kWMaxC2", "kMaxSmem", "kBQ")) == (
        cross_tail_mod.BWD_WIDE_SLICE, cross_tail_mod.BWD_WIDE_QUERIES,
        cross_tail_mod.BWD_WIDE_MAX_C2, cross_tail_mod._MAX_SMEM,
        cross_tail_mod.BWD_WIDE_GENERAL_QUERIES)
    smem = _c_function("bwd_wide_smem_floats")
    for k, c2 in ((K, C2), (129, 256), (130, 256), (219, 1), (32, 255)):
        assert cross_tail_mod._bwd_wide_smem(k, c2) == 4 * smem(k, c2)
    assert 4 * smem(129, 256) <= cross_tail_mod._MAX_SMEM < 4 * smem(130, 256)
    general = _c_function("bwd_wide_general_smem_floats")
    for k, c, c2 in ((K, C, C2), (219, 64, 256), (220, 64, 256), (32, 128, 512)):
        assert cross_tail_mod._bwd_wide_general_smem(k, c, c2) == 4 * general(k, c, c2)
    form = cross_tail_mod.bwd_wide_form(K, C, C2)
    assert form == ("bucketed" if C2 <= 256 and K < 300 else "general")
    if form == "bucketed":
        spans = cross_tail_mod.bwd_wide_spans(B, N, C)
        slices = -(-C // consts["kWS"])
        assert 1 <= spans <= -(-B * N // consts["kWQ"])
        assert spans * slices <= cross_tail_mod.BWD_WIDE_BLOCKS or spans == 1
    empty, sizes = torch.empty, []
    monkeypatch.setattr(torch, "empty", lambda *a, **k: sizes.append(a[0]) or empty(*a, **k))
    tab, idx, base, w, _ = _tail_leaves(K, C, C2, N=N)
    out = torch.zeros(1, N, C2)
    amax = torch.zeros(1, N, C2, dtype=cross_tail_mod.argmax_dtype(K))
    with monkeypatch.context() as m:
        m.setattr(cross_tail_mod, "bwd_route", lambda *a: "cross_tail_bwd_wide")
        cross_tail_mod.cross_tail_bwd(tab.detach(), idx, base.detach(), w.detach(), out, amax,
                                      out)
    [(name, args, _)] = launches
    assert name == "cross_tail_bwd_wide"
    if form == "general":
        assert args[17] == min(cross_tail_mod.BWD_WIDE_BLOCKS, -(-N // consts["kBQ"]))
        assert sizes[-1] == C * C2 + args[17] * (C * C2 + C2)
        return
    assert args[17] == cross_tail_mod.bwd_wide_spans(1, N, C)
    # a query's orders, (gv, offset) pairs by bucket (each padded to 4
    # entries) and by c2, and K + 1 bucket starts, rounded up to 4 entries;
    # then a partial a span
    up4 = lambda x: -(-x // 4) * 4
    per_query = 2 * (up4(C2 + 3 * K) + up4(C2)) + up4(K + 1)
    assert sizes[-1] == N * per_query + args[17] * (C * C2 + C2)


def test_eval_attention_takes_the_kernel_past_4096_keys(launches):
    """On the card the eval attention over 4160 keys is one ``attention``
    launch (``CrossAttention``, ``MultiFrameBlock``); past ``MAX_SEQ`` it
    takes the plain chunked form, and train attention over 8192 keys
    launches its kernel instead of raising."""
    cross = pnn.CrossAttention(8, 2).eval()
    block = pnn.MultiFrameBlock(8, 8, num_heads=1).eval()
    with torch.no_grad():
        cross(torch.zeros(1, 16, 8), torch.zeros(1, LONG, 8))
        block(torch.zeros(1, 3, LONG, 8))
        assert [(name, args[6]) for name, args, _ in launches] == [("attention", LONG)] * 2
        del launches[:]
        cross(torch.zeros(1, 4, 8), torch.zeros(1, attention_mod.MAX_SEQ + 1, 8))
        assert not launches
        cross(torch.zeros(1, 16, 8), torch.zeros(1, 8192, 8), train=True)
    assert [(name, args[7]) for name, args, _ in launches] == [("attention_train_fwd", 8192)]


def _stress_batch(n):
    rng = np.random.default_rng(0)
    pc1 = rng.normal(size=(1, n, 3)).astype(np.float32)
    flow = (0.3 * rng.normal(size=(1, 1, 3))).astype(np.float32)
    gt = np.stack([pc1 + flow * s for s in (0.25, 0.5, 0.75)], axis=1).astype(np.float32)
    return {"pc1": pc1, "pc2": pc1 + flow, "gt": gt}


@functools.lru_cache(maxsize=None)
def _jax_stress_step(n):
    """JAX's loss components, gradients and variables at
    ``stress_model_config(n)``, B=1, rates 0, the PointConv aggregation
    Dense calmed as in ``tests/test_torch_stress.py``."""
    batch = _stress_batch(n)
    cfg = dataclasses.replace(jax_config.stress_model_config(n), **NO_DROPOUT)
    jm = JaxMoCoPCI(cfg)
    variables = jax.tree_util.tree_map_with_path(
        _calm, init_jax(jm, np.random.default_rng(1), batch["pc1"], batch["pc2"]))

    def loss_fn(params, stats):
        result, _ = jm.apply({"params": params, "batch_stats": stats}, batch["pc1"],
                             batch["pc2"], train=True, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_loss(result, jnp.asarray(batch["gt"]), cfg, JaxTrainConfig())

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return batch, variables, {k: float(v) for k, v in aux.items()}, np_tree(grads)


def test_stress_train_step_matches_jax():
    """One step's loss and gradients at stress_model_config(128), B=1,
    dropout rates 0, exact kNN: the stress ratios (pyramid 32/8/4/1, refine
    head 32) at full width.  128 is the least size the config takes; JAX's
    compile of this step at 1024 points runs several times past a test's
    budget on a CPU.  Loss components within rel 1e-4; the whole gradient within rel
    L2 1e-4; each leaf within 1e-3 of its largest entry plus 1e-9 of the
    whole gradient's largest (the two frameworks sum in other orders; the
    leaves whose gradient is zero in exact arithmetic, a bias before a
    BatchNorm or a key bias under the softmax, carry rounding alone)."""
    n = 128
    batch, variables, aux, grads = _jax_stress_step(n)
    model = MoCoPCI(dataclasses.replace(stress_model_config(n), **NO_DROPOUT), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    got_aux = loss_and_grads(model, batch, None, model.cfg, TrainConfig(batch_size=1))
    assert set(got_aux) == set(aux)
    for k, v in aux.items():
        np.testing.assert_allclose(float(got_aux[k]), v, rtol=1e-4, err_msg=k)
    want = params_from_jax({"params": grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    top = max(float(np.abs(g.numpy()).max()) for g in want.values())
    num = den = 0.0
    for name, g in want.items():
        a, b = got[name].grad.numpy(), g.numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max() + 1e-9 * top,
                                   err_msg=name)
        num, den = num + float(((a - b) ** 2).sum()), den + float((b ** 2).sum())
    assert num <= (1e-4) ** 2 * den
