"""Port parity, int8 and truncated-SVD serving: ops/quant.py, the copy of
ops/lowrank.py, the int8 and factored MultiPathHead, and the pool kernels'
int8 epilogue (plain versions), against the JAX package on the same numpy
inputs at the `tiny` preset. The JAX side runs roi_impl="pallas" (the Pallas
kernels in interpret mode), jitted where the reference runs jitted.

The int32 GEMM is exact on both sides and the quantizers are the same
formulas, so quantization, the epilogue on identical pooled input and the
int8 head on identical int8 input are held bit for bit. bf16 pooling, with
and without the epilogue, is held to one bf16 step in a bounded share of
values (_assert_bf16_pool_close): both sides round W2 = wy (x) wx to bf16
and contract in float32 in their own order, then round once to bf16, and
now and then a bin's two float32 sums round to different bf16 values (0-13
of 200,704 values at 16 ROIs per image, in one or two bins; none at the
6-ROI inputs). Float32 pooling with the
epilogue is not held bit for bit: a pooled value one ULP apart flips a code
at a rounding tie (the share of such codes is bounded below)."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.models.heads import MultiPathHead as JHead
from multipathnet_tpu.models.multipath import MultiPathNet as JNet
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.ops import lowrank as jlowrank
from multipathnet_tpu.ops import quant as jquant
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.heads import MultiPathHead
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import lowrank, quant, roi_pool
from multipathnet_tpu_torch.utils import profiling

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(x):
    """A jax or numpy array as a torch tensor (bf16 through float32, which
    holds every bf16 value exactly)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _kernel(rng, k, n, spread=True):
    """A (K, N) kernel whose columns span four decades of magnitude, one
    column zero."""
    w = rng.normal(size=(k, n)) * 0.02
    if spread:
        w = w * 10 ** rng.uniform(-2, 2, n)
    w[:, 1] = 0.0
    return w.astype(np.float32)


# the share of bf16 pooled values allowed to differ from the reference's:
# seen up to 6.5e-5 (13 of 200,704, test_pool_rois_bf16_at_16_rois_...)
BF16_POOL_SHARE = 1e-4


def _assert_bf16_pool_close(got, want, share=BF16_POOL_SHARE):
    """bf16 pooled values: at most `share` of them differ from the
    reference's, each by at most one bf16 step at the larger of the two
    magnitudes or, where a bin's sum cancels to a small value, 1/256 of
    the largest pooled magnitude. Returns the number that differ."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.maximum(torch.ldexp(torch.ones_like(got), e - 8),
                         want.abs().max() / 256)
    n = int((diff > 0).sum())
    assert bool((diff <= step).all()), float(diff.max())
    assert n <= share * got.numel(), (n, got.numel())
    return n


# ------------------------------------------------------------ ops/quant ---

@pytest.mark.parametrize("shape", [(1568, 64), (256, 50), (64, 16)])
def test_quantize_weight_matches_reference(shape):
    """Bit-equal codes and scales to the reference's quantize_weight as
    Detector's load transform runs it: eagerly, where amax / 127 is a true
    division. (Under jax.jit XLA rewrites it to amax * (1/127), which gives
    other scales; the port mirrors the load transform.)"""
    w = _kernel(np.random.default_rng(shape[1]), *shape)
    want_q, want_s = jquant.quantize_weight(jnp.asarray(w))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.dtype == torch.int8 and got_s[1] == np.float32(1e-12)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_rows_matches_reference(jit, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(3, 40, 1568)), 0)
    x[0, 0] = 0.0                                    # all-zero row
    x = jnp.asarray(x, jdt)
    fn = jax.jit(jquant.quantize_rows) if jit else jquant.quantize_rows
    want_q, want_s = fn(x)
    got_q, got_s = quant.quantize_rows(_t(x))
    assert got_q.shape == (3, 40, 1568) and got_s.shape == (3, 40, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("m", [40, 9])
def test_matmul_and_dense_int8_match_reference(bias, m):
    """Equal float32 outputs to the reference's matmul_int8 and dense_int8
    under jax.jit (as the head runs them), whose rescale and bias add XLA
    fuses into one multiply-add."""
    rng = np.random.default_rng(m)
    w = _kernel(rng, 1568, 64)
    x = np.maximum(rng.normal(size=(m, 1568)), 0).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32) if bias else None
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    jw_q, jw_s = jnp.asarray(w_q.numpy()), jnp.asarray(w_s.numpy())
    jb, tb = (None, None) if b is None else (jnp.asarray(b),
                                             torch.from_numpy(b))
    x_q, x_s = quant.quantize_rows(torch.from_numpy(x))
    want = jax.jit(jquant.matmul_int8)(jnp.asarray(x_q.numpy()),
                                       jnp.asarray(x_s.numpy()), jw_q, jw_s,
                                       jb)
    got = quant.matmul_int8(x_q, x_s, w_q.t().contiguous(), w_s, tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(jquant.dense_int8)(jnp.asarray(x), jw_q, jw_s, jb)
    got = quant.dense_int8(torch.from_numpy(x), w_q.t().contiguous(), w_s,
                           tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _head_tree(rng, model_cfg, fc6_rank=0, fc7_rank=0, dtype=jnp.float32):
    """A float tree of the tiny head (flax layout, numpy leaves), normal
    draws, factored at the ranks by the reference's own transform."""
    head = JHead(num_classes=model_cfg.num_classes,
                 foveal_scales=model_cfg.foveal_scales,
                 num_integral_heads=len(model_cfg.integral_thresholds),
                 fc_dim=model_cfg.fc_dim,
                 skip_reduce_dim=model_cfg.skip_reduce_dim, dtype=dtype)
    g, c = model_cfg.roi_output_size, model_cfg.skip_reduce_dim
    shapes = jax.eval_shape(head.init, jax.random.key(0),
                            jnp.zeros((1, len(model_cfg.foveal_scales), 1, g,
                                       g, c)))
    tree = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape)
                   * (2.0 / max(s.shape[0], 1)) ** 0.5).astype(np.float32),
        shapes["params"])
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if fc6_rank or fc7_rank:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tree = jlowrank.factorize_head_params(tree, fc6_rank, fc7_rank)
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantize_head_params_matches_detector_transform():
    """The load transform, on numpy and on torch leaves, against the
    reference's eager quantize_head_params (as its Detector runs it)."""
    tree = _head_tree(np.random.default_rng(2), preset("tiny").model, 16, 8)
    want = jax.tree_util.tree_map(np.asarray,
                                  jquant.quantize_head_params(tree))
    _assert_trees_equal(quant.quantize_head_params(tree), want)
    as_torch = jax.tree_util.tree_map(torch.from_numpy, tree)
    _assert_trees_equal(quant.quantize_head_params(as_torch), want)
    assert quant.is_quantized(want) and not quant.is_quantized(tree)


# ---------------------------------------------------------- ops/lowrank ---

@pytest.mark.parametrize("method,shape,rank", [
    ("exact", (64, 48), 12), ("randomized", (300, 64), 8),
    ("randomized", (40, 200), 6), ("auto", (1568, 64), 16)])
def test_factorize_kernel_matches_reference(method, shape, rank):
    w = _kernel(np.random.default_rng(rank), *shape, spread=False)
    want_a, want_b = jlowrank.factorize_kernel(w, rank, method=method)
    got_a, got_b = lowrank.factorize_kernel(w, rank, method=method)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_b, want_b)
    got_a, got_b = lowrank.factorize_kernel(torch.from_numpy(w), rank,
                                            method=method)
    np.testing.assert_array_equal(got_b, want_b)
    assert (lowrank.truncation_rel_err(w, got_a, got_b)
            == jlowrank.truncation_rel_err(w, want_a, want_b))
    with pytest.raises((AssertionError, ValueError)):
        jlowrank.factorize_kernel(w, min(shape) + 1)
    with pytest.raises(ValueError):
        lowrank.factorize_kernel(w, min(shape) + 1)


def test_factorize_head_params_matches_reference():
    """The same tree, the same report and warning, the same checks, and a
    raise wherever the reference raises."""
    tree = _head_tree(np.random.default_rng(3), preset("tiny").model)
    want_rep, got_rep = {}, {}
    with pytest.warns(UserWarning, match="too aggressive"):
        want = jlowrank.factorize_head_params(tree, 16, 8, report=want_rep)
    with pytest.warns(UserWarning, match="too aggressive"):
        got = lowrank.factorize_head_params(tree, 16, 8, report=got_rep)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
    assert got_rep == want_rep and len(got_rep) == 8
    assert lowrank.is_factored(got) and not lowrank.is_factored(tree)
    assert jlowrank.is_factored(got)
    lowrank.check_factored_ranks(got, 16, 8)
    for ranks in ((16, 4), (8, 8)):
        with pytest.raises(ValueError, match="factored at rank"):
            jlowrank.check_factored_ranks(got, *ranks)
        with pytest.raises(ValueError, match="factored at rank"):
            lowrank.check_factored_ranks(got, *ranks)
    int8 = jax.tree_util.tree_map(np.asarray,
                                  jquant.quantize_head_params(tree))
    for mod in (jlowrank, lowrank):
        with pytest.raises(ValueError, match="already int8-quantized"):
            mod.factorize_head_params(int8, 16, 8)
    # factor layers beside a float fc6 kernel: already factored
    stale = {**tree, "fc6_f0_u": got["fc6_f0_u"]}
    with pytest.raises(AssertionError, match="already factored"):
        jlowrank.factorize_head_params(stale, 16, 0)
    with pytest.raises(ValueError, match="already factored"):
        lowrank.factorize_head_params(stale, 16, 0)


# -------------------------------------------------------------- the head ---

def _int8_pooled(rng, model_cfg, b=2, r=5):
    f, g, c = (len(model_cfg.foveal_scales), model_cfg.roi_output_size,
               model_cfg.skip_reduce_dim)
    q = rng.integers(0, 128, (b, f, r, g, g, c)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-1, (b, f, r, 1)).astype(np.float32)
    return q, s


def _cat_path(head, x, xs):
    """The int8 head as it ran before its fc7 outputs went into one buffer:
    each branch's fc7 output concatenated, every layer through the plain
    quantize_rows and rescale_int32, a ReLU after each FC. x (B, F, R, K)
    int8 codes, xs (B, F, R, 1) float32 scales."""
    def dense(name, h, hs=None):
        mod = getattr(head, name)
        if hs is None:
            h, hs = quant.quantize_rows(h)
        y = quant.rescale_int32(mod.accumulate(h), hs, mod.weight_scale,
                                mod.bias)
        return y[:, :mod.out_features].to(mod.dtype)

    def fc(name, h, hs=None):
        if hasattr(head, f"{name}_u"):
            h, hs = dense(f"{name}_u", h, hs), None
        return torch.relu(dense(name, h, hs))

    b, f, r = x.shape[:3]
    n = b * r
    branches = [fc(f"fc7_f{i}", fc(f"fc6_f{i}", x[:, i].reshape(n, -1),
                                   xs[:, i].reshape(n, 1)))
                for i in range(f)]
    out = dense("cls_bbox", torch.cat(branches, dim=-1))
    scores = out[:, :head.cls_dim].reshape(n, head.num_integral_heads, -1)
    return scores.float(), out[:, head.cls_dim:].float()


@pytest.mark.parametrize("g", [7, 6], ids=["g7", "g6"])
@pytest.mark.parametrize("ranks", [(0, 0), (16, 8), (12, 6)],
                         ids=["int8", "int8_svd", "int8_svd_odd_ranks"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_head_matches_reference(dtype, ranks, g):
    """The same int8 pooled codes and scales through the reference's int8
    head and the port's: bit-equal scores and deltas (the int32 GEMM is
    exact on both sides), at G = 7 and 6. The port writes each view's fc7
    output into its column slice of one buffer and quantizes that buffer's
    whole row for the classifier: equal to concatenating the branches
    (_cat_path). Then the port's own quantizing route (float pooled,
    pooled_scale=None; its codes padded to fc6's K in one pass) against the
    pre-quantized route fed quant_view_ref of the same pooled tensor: equal
    too. Ranks (12, 6) are no multiples of 8: Int8Linear pads the factored
    layers' K with zero weight columns and the input with zero codes,
    exactly."""
    jdt, tdt = DTYPES[dtype]
    mcfg = dataclasses.replace(preset("tiny").model, roi_output_size=g)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(np.asarray, jquant.quantize_head_params(
        _head_tree(rng, mcfg, *ranks)))
    jhead = JHead(num_classes=mcfg.num_classes,
                  foveal_scales=mcfg.foveal_scales,
                  num_integral_heads=len(mcfg.integral_thresholds),
                  fc_dim=mcfg.fc_dim, skip_reduce_dim=mcfg.skip_reduce_dim,
                  dtype=jdt, quant="int8", fc6_rank=ranks[0],
                  fc7_rank=ranks[1])
    head = MultiPathHead(num_classes=mcfg.num_classes,
                         foveal_scales=mcfg.foveal_scales,
                         num_integral_heads=len(mcfg.integral_thresholds),
                         fc_dim=mcfg.fc_dim,
                         skip_reduce_dim=mcfg.skip_reduce_dim,
                         roi_output_size=g, dtype=tdt,
                         quant="int8", fc6_rank=ranks[0], fc7_rank=ranks[1])
    head.load_state_dict(convert.state_dict_from_flax(tree))
    q, s = _int8_pooled(rng, mcfg)
    want = jax.jit(lambda p, x, xs: jhead.apply({"params": p}, x,
                                                pooled_scale=xs))(tree, q, s)
    with torch.no_grad():
        got = head(torch.from_numpy(q), pooled_scale=torch.from_numpy(s))
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        cat = _cat_path(head, torch.from_numpy(q).reshape(*q.shape[:3], -1),
                        torch.from_numpy(s))
        for a, b in zip(got, cat):
            assert torch.equal(a, b)

        pooled = torch.from_numpy(rng.normal(size=q.shape)).to(tdt)
        own = head(pooled)
        bias = head.skip_bias.to(tdt)
        pq, ps = roi_pool.quant_view_ref(pooled.reshape(-1, *q.shape[3:]),
                                         bias)
        pre = head(pq.reshape(q.shape), pooled_scale=ps.reshape(s.shape))
        for a, b in zip(own, pre):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cols,width", [((0, 1568), 1568), ((0, 1568), 1576),
                                        ((392, 785), 400)],
                         ids=["whole", "padded", "row_parallel"])
def test_quantize_rows_padded_matches_reference(dtype, cols, width):
    """quantize_rows_padded's plain route against the reference's
    quantize_rows of the whole rows: the same codes, zero codes in the pad
    columns, the same scales. "row_parallel" quantizes a block of columns
    (an odd width) with each whole row's largest magnitude given as `amax`,
    as a row-parallel layer does after the all-reduce of the maxima: its
    codes are the whole row's codes in those columns."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 1568)) * 10 ** rng.uniform(-3, 3, (40, 1))
    x[3] = 0.0                                       # all-zero row
    x = jnp.asarray(x, jdt)
    want_q, want_s = jax.jit(jquant.quantize_rows)(x)
    xt = _t(x)
    a, b = cols
    amax = quant.row_amax(xt) if (a, b) != (0, xt.shape[1]) else None
    got_q, got_s = quant.quantize_rows_padded(xt[:, a:b], width, amax)
    assert got_q.shape == (40, width) and got_s.shape == (40, 1)
    np.testing.assert_array_equal(got_q[:, :b - a].numpy(),
                                  np.asarray(want_q)[:, a:b])
    assert not got_q[:, b - a:].any()
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_int8_epilogue_plain_route():
    """int8_epilogue on CPU tensors: rescale_int32, the logical columns,
    the cast and F.relu, written into a column slice of a wider buffer when
    asked; bad arguments raise, and a tensor on neither the CPU nor a card
    too."""
    rng = np.random.default_rng(6)
    acc = torch.from_numpy(rng.integers(-2 ** 26, 2 ** 26, (9, 16),
                                        dtype=np.int32))
    xs = torch.from_numpy(rng.uniform(1e-4, 1e-2, (9, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-2, 16).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    full = quant.rescale_int32(acc, xs, ws, bias)
    buf = torch.full((9, 30), 7.0, dtype=torch.bfloat16)
    got = quant.int8_epilogue(acc, xs, ws, bias, width=13,
                              dtype=torch.bfloat16, relu=True,
                              out=buf[:, 5:18])
    assert got.data_ptr() == buf[:, 5:18].data_ptr()
    assert torch.equal(buf[:, 5:18], torch.relu(full[:, :13].bfloat16()))
    assert (buf[:, :5] == 7).all() and (buf[:, 18:] == 7).all()
    assert torch.equal(quant.int8_epilogue(acc, xs, ws),
                       quant.rescale_int32(acc, xs, ws))
    with pytest.raises(ValueError):
        quant.int8_epilogue(acc, xs, ws, width=17)
    with pytest.raises(ValueError):
        quant.int8_epilogue(acc, xs, ws, width=13, out=buf[:, :12])
    with pytest.raises(ValueError):
        quant.int8_epilogue(acc[0], xs, ws)
    with pytest.raises(ValueError):
        quant.quantize_rows_padded(torch.zeros(4, 8), 6)
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant.int8_epilogue(meta, xs, ws)
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant.quantize_rows_padded(meta.float(), 8)


def test_head_kernels_count_no_launch_on_the_cpu():
    """The head kernels' counters exist (launches.int8_epilogue and
    launches.quantize_rows, read as profiling.kernel_launches) and an int8 + SVD
    head on the CPU moves neither: the plain versions run."""
    mcfg = preset("tiny").model
    head = MultiPathHead(num_classes=mcfg.num_classes,
                         foveal_scales=mcfg.foveal_scales,
                         num_integral_heads=len(mcfg.integral_thresholds),
                         fc_dim=mcfg.fc_dim,
                         skip_reduce_dim=mcfg.skip_reduce_dim,
                         dtype=torch.float32, quant="int8", fc6_rank=16,
                         fc7_rank=8)
    q, s = _int8_pooled(np.random.default_rng(7), mcfg)
    before = profiling.counters()
    assert {"int8_epilogue", "quantize_rows"} <= set(profiling.kernel_launches())
    with torch.no_grad():
        head(torch.from_numpy(q), pooled_scale=torch.from_numpy(s))
        head(torch.from_numpy(q).float())
    after = profiling.counters()
    for name in ("launches.int8_epilogue", "launches.quantize_rows"):
        assert after[name] == before[name] == 0


def test_serving_heads_are_inference_only_and_rank_checked():
    mcfg = preset("tiny").model
    for kw in (dict(head_quant="int8"), dict(fc6_rank=8), dict(fc7_rank=8)):
        model = build_model(dataclasses.replace(mcfg, **kw), device="meta")
        with pytest.raises(ValueError, match="inference-only"):
            model.head(torch.zeros((1, 4, 1, 7, 7, 32), device="meta"),
                       train=True)
    with pytest.raises(ValueError, match="exceeds full rank"):
        MultiPathHead(num_classes=5, fc_dim=64, skip_reduce_dim=32,
                      fc7_rank=65, device="meta")
    float_head = MultiPathHead(num_classes=5, fc_dim=64, skip_reduce_dim=32,
                               device="meta")
    with pytest.raises(ValueError, match="pre-quantized"):
        float_head(torch.zeros((1, 4, 1, 7, 7, 32), dtype=torch.int8,
                               device="meta"),
                   pooled_scale=torch.ones((1, 4, 1, 1), device="meta"))


# ----------------------------------------------------------- the epilogue --

@pytest.fixture(scope="module")
def pooled_pair():
    """The reference's features, ROIs and skip bias at the tiny preset
    (int8 head, roi_impl="pallas"), and per dtype its pool_rois and
    pool_rois_quantized outputs, jitted (the Pallas kernels in interpret
    mode)."""
    rng = np.random.default_rng(5)
    images = jnp.asarray(rng.standard_normal((2, 64, 64, 3)), jnp.float32)
    rois = rng.uniform(2, 34, (2, 6, 4)).astype(np.float32)
    rois[..., 2:] += rng.uniform(6, 28, (2, 6, 2)).astype(np.float32)
    mcfg = preset("tiny").model
    bias = jnp.asarray(rng.normal(size=mcfg.skip_reduce_dim) * 0.5,
                       jnp.float32)

    def leaf(path, s):
        if "skip_bias" in jax.tree_util.keystr(path):
            return bias
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return jnp.asarray(rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in),
                           jnp.float32)

    out = {}
    for dtype in sorted(DTYPES):
        qm = dataclasses.replace(jpreset("tiny").model, head_quant="int8",
                                 roi_impl="pallas", dtype=dtype)
        qmodel = jbuild(qm)
        shapes = jax.eval_shape(
            jbuild(dataclasses.replace(qm, head_quant="none")).init,
            jax.random.key(0), images, jnp.asarray(rois))
        qparams = jquant.quantize_head_params(
            jax.tree_util.tree_map_with_path(leaf, shapes))
        feats = jax.jit(lambda p, im: qmodel.apply(
            p, im, method=JNet.features))(qparams, images)
        pooled = jax.jit(lambda p, ft, rr: qmodel.apply(
            p, ft, rr, (64, 64), method=JNet.pool_rois))(qparams, feats, rois)
        pq, ps = jax.jit(lambda p, ft, rr, bi: qmodel.apply(
            p, ft, rr, (64, 64), bi, method=JNet.pool_rois_quantized))(
                qparams, feats, rois, bias)
        out[dtype] = (feats, pooled, pq, ps, qmodel, qparams)
    return rois, bias, out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_view_ref_matches_reference_epilogue(pooled_pair, dtype):
    """The reference's own pooled values (pool_rois) through the port's
    quant_view_ref equal its pool_rois_quantized bit for bit."""
    _, bias, out = pooled_pair
    _, pooled, pq, ps = out[dtype][:4]
    b, f, r, g, _, c = pooled.shape
    tdt = DTYPES[dtype][1]
    q, s = roi_pool.quant_view_ref(_t(pooled).reshape(-1, g, g, c),
                                   _t(bias).to(tdt))
    np.testing.assert_array_equal(q.reshape(pq.shape).numpy(),
                                  np.asarray(pq))
    np.testing.assert_array_equal(s.reshape(ps.shape).numpy(),
                                  np.asarray(ps))
    assert np.asarray(pq).any() and (np.asarray(ps) > 1e-12).all()


def _port_pool_model(dtype):
    cfg = preset("tiny")
    return build_model(dataclasses.replace(
        cfg.model, head_quant="int8", dtype=dtype), device="cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pool_rois_quantized_matches_reference(pooled_pair, dtype):
    """The port's pool with the epilogue (plain versions) from the
    reference's features.

    float32: scales to rtol 1e-6 (2.4e-7 read here); codes equal but for at
    most 1e-4 of them (7 of the 75,264) that differ by 1, a pooled sum one
    ULP apart at a rounding tie. None differs here; on an H100 the quant
    kernels differ from their plain version in 7.7e-7 (K1) and 3.7e-7 (K2)
    of the codes at the main path's shapes.

    bfloat16: the port rounds W2 = wy (x) wx to bf16 before one float32
    contraction, as the reference's kernels do (with float32 weights 2,891
    of the 75,264 codes differed, by up to 2). Codes differ by at most 1 in
    at most BF16_POOL_SHARE of them, and scales (amax / 127 of values that
    may differ by one bf16 step) to rtol 2^-7; none differs here."""
    rois, bias, out = pooled_pair
    feats, _, pq, ps = out[dtype][:4]
    model = _port_pool_model(dtype)
    q, s = model.pool_rois_quantized(
        {k: _t(v) for k, v in feats.items()}, torch.from_numpy(rois),
        (64, 64), _t(bias).to(DTYPES[dtype][1]))
    assert q.dtype == torch.int8 and q.shape == pq.shape
    assert s.shape == ps.shape == (2, 4, 6, 1)
    if dtype == "bfloat16":
        diff = np.abs(q.numpy().astype(np.int32) - np.asarray(pq, np.int32))
        assert diff.max() <= 1 and diff.mean() <= BF16_POOL_SHARE
        np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=2 ** -7,
                                   atol=0)
        return
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=1e-6, atol=0)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(pq, np.int32))
    assert diff.max() <= 1 and diff.mean() <= 1e-4, (diff.max(), diff.sum())


def test_pool_rois_bf16_matches_reference_bit_for_bit(pooled_pair):
    """bf16 pool_rois (plain versions) against the reference's jitted
    pool_rois, Pallas kernels in interpret mode, on the reference's own
    features: the W2 rounding of roi_pallas.py:534 and :975 (with float32
    weights 18,307 of the 75,264 values differed, by up to 0.0625). Held
    to _assert_bf16_pool_close; at these inputs all 75,264 are equal, bit
    for bit."""
    rois, _, out = pooled_pair
    feats, pooled = out["bfloat16"][:2]
    model = _port_pool_model("bfloat16")
    got = model.pool_rois({k: _t(v) for k, v in feats.items()},
                          torch.from_numpy(rois), (64, 64))
    want = _t(pooled)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape and want.numel() == 75264
    assert _assert_bf16_pool_close(got, want) == 0


@pytest.mark.parametrize("seed", [0, 2])
def test_pool_rois_bf16_at_16_rois_within_one_step(pooled_pair, seed):
    """The reference's own bf16 features, 16 ROIs per image (200,704 pooled
    values): here a few values differ (13 and 4, by up to 0.03125, one bf16
    step at their magnitude, in two bins each), each within
    _assert_bf16_pool_close."""
    _, _, out = pooled_pair
    feats, _, _, _, qmodel, qparams = out["bfloat16"]
    rng = np.random.default_rng(10 + seed)
    rois = rng.uniform(2, 34, (2, 16, 4)).astype(np.float32)
    rois[..., 2:] += rng.uniform(6, 28, (2, 16, 2)).astype(np.float32)
    want = _t(jax.jit(lambda p, ft, rr: qmodel.apply(
        p, ft, rr, (64, 64), method=JNet.pool_rois))(qparams, feats, rois))
    got = _port_pool_model("bfloat16").pool_rois(
        {k: _t(v) for k, v in feats.items()}, torch.from_numpy(rois),
        (64, 64))
    assert got.shape == want.shape and want.numel() == 200704
    assert _assert_bf16_pool_close(got, want) == {0: 13, 2: 4}[seed]
