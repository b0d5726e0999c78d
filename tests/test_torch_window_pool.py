"""Port parity, the single-level pools and the window-read probe: K5
(window_pool, batched_pyramid_pool), the differentiable K5, K2 and K1
without rows_list with their shared backward (accumulate_windows), and the
probe's plain version, against the JAX package on the same numpy inputs.
The JAX side runs its Pallas kernels in interpret mode, in float32 (XLA:CPU
rejects bf16 x bf16 -> f32 dots); the bf16 K5 is held, bit for bit, to the
reference's combined weights (roi_pallas._w2_all) rounded to bf16.
Tolerances: forward atol 1e-5, gradients atol/rtol 1e-4 (float32 sums in
another order); the probe as each test states."""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multipathnet_tpu.ops import roi_pallas as jrk
from multipathnet_tpu.ops import roi_pyramid as jrp
from multipathnet_tpu_torch.ops import roi_pool as trk
from multipathnet_tpu_torch.ops import roi_pyramid as trp
from multipathnet_tpu_torch.tools import probe_int8_window_dma as tprobe
from multipathnet_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(atol=1e-5, rtol=0)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rois(rng, n, x_hi, y_hi):
    x1 = rng.uniform(0, x_hi, n)
    y1 = rng.uniform(0, y_hi, n)
    w = rng.uniform(4, 26, n)
    h = rng.uniform(4, 16, n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _level(rng, batch, h, w, c, scale, n):
    """A batch of one level's pyramids and n views over them (image-major):
    the JAX flat and meta, the ROIs, each view's image, and the JAX
    geometry as numpy with row0 absolute in the stacked buffer."""
    feats = rng.normal(size=(batch, h, w, c)).astype(np.float32)
    jflat, jmeta = jrp.build_pyramid_batch(jnp.asarray(feats), scale)
    rois = _rois(rng, n, x_hi=0.6 * w / scale, y_hi=0.5 * h / scale)
    img = np.repeat(np.arange(batch, dtype=np.int32), n // batch)
    row0, x0, wy, wx = (np.asarray(a) for a in jax.jit(jrk.view_geometry)(
        jmeta, jnp.asarray(rois)))
    row0 = (row0 + img * jmeta.flat.shape[0]).astype(np.int32)
    return dict(feats=feats, flat=np.asarray(jflat), meta=jmeta, rois=rois,
                img=img, geo=(row0, x0, wy, wx))


def _count_calls(monkeypatch, mod, names):
    """Record the calls of mod's functions `names` (made at trace time on
    the JAX side)."""
    calls = []
    for name in names:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


# ------------------------------------------------------------ K5 forward ---

@pytest.mark.parametrize("n", [11, 8])
def test_window_pool_matches_pallas(n):
    """N = 11 is not a multiple of the JAX tile (4): the reference pads."""
    lv = _level(np.random.default_rng(n), 1, 16, 24, 8, 0.5, n)
    want = jax.jit(lambda *a: jrk.pallas_window_pool(
        *a, tile=4, interpret=True))(lv["flat"], *lv["geo"])
    args = (_t(lv["flat"]), *map(_t, lv["geo"]))
    before = profiling.counters()
    got = trk.window_pool(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    torch.testing.assert_close(got, trk.window_pool_ref(*args), rtol=0,
                               atol=0)
    # the CPU launches nothing
    assert profiling.kernel_launches(before)["window_pool"] == 0


def test_window_pool_empty_and_dtype():
    lv = _level(np.random.default_rng(3), 1, 16, 24, 8, 0.5, 4)
    flat = _t(lv["flat"])
    row0, x0, wy, wx = map(_t, lv["geo"])
    out = trk.window_pool(flat, row0[:0], x0[:0], wy[:0], wx[:0])
    assert tuple(out.shape) == (0, 7, 7, 8)
    bf = trk.window_pool(flat.bfloat16(), row0, x0, wy, wx)
    assert bf.dtype == torch.bfloat16
    # the W2 semantics of the reference's kernels: W2 = wy (x) wx built by
    # roi_pallas._w2_all in float32, rounded once to bf16, one float32
    # contraction over the 160 window cells, one rounding of the result
    n = row0.shape[0]
    consts = jrk._expansion_consts(7, n)
    w2 = jrk._w2_all(*consts, jrk._cat_layout(jnp.asarray(lv["geo"][2]), n)[0],
                     jrk._cat_layout(jnp.asarray(lv["geo"][3]), n)[0])
    w2 = _t(np.asarray(w2[:49]).reshape(49, n, 160).transpose(1, 0, 2))
    ys = row0.long()[:, None] + torch.arange(10)
    xs = x0.long()[:, None] + torch.arange(16)
    win = flat.bfloat16()[ys[:, :, None], xs[:, None, :]].float()
    want = torch.bmm(w2.bfloat16().float(), win.reshape(n, 160, 8))
    torch.testing.assert_close(bf, want.reshape(n, 7, 7, 8).bfloat16(),
                               rtol=0, atol=0)
    # which float32 weights would not give
    f32w = trk.window_pool(flat.bfloat16().float(), row0, x0, wy, wx)
    assert not torch.equal(bf, f32w.bfloat16())


def test_window_pool_rejects_other_devices():
    flat = torch.empty((20, 16, 8), device="meta")
    geo = (torch.empty(2, dtype=torch.int32, device="meta"),) * 2
    with pytest.raises(ValueError, match="CUDA"):
        trk.window_pool(flat, *geo, torch.empty((2, 7, 10), device="meta"),
                        torch.empty((2, 7, 16), device="meta"))


@pytest.mark.parametrize("width", [24, 104])
def test_batched_pyramid_pool_matches_reference(width):
    rng = np.random.default_rng(width)
    lv = _level(rng, 2, 12, width, 4, 0.5, 10)
    want = jax.jit(lambda f, r, i: jrk.batched_pyramid_pool(
        f, lv["meta"], r, i, tile=4, interpret=True))(
        lv["flat"], lv["rois"], lv["img"])
    flat, meta = trp.build_pyramid_batch(torch.from_numpy(lv["feats"]), 0.5)
    got = trk.batched_pyramid_pool(flat, meta, torch.from_numpy(lv["rois"]),
                                   torch.from_numpy(lv["img"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_batched_pyramid_pool_image_isolation():
    """Views read only their own image's rows (as
    tests/test_roi_pallas.py's test_batched_pool_image_isolation)."""
    feats = torch.stack([torch.zeros((16, 16, 8)), torch.ones((16, 16, 8))])
    flat, meta = trp.build_pyramid_batch(feats, 1.0)
    rois = torch.tensor([[2, 2, 12, 12], [2, 2, 12, 12]], dtype=torch.float32)
    out = trk.batched_pyramid_pool(flat, meta, rois,
                                   torch.tensor([0, 1], dtype=torch.int32))
    want = jrk.batched_pyramid_pool(
        *jrp.build_pyramid_batch(jnp.asarray(feats.numpy()), 1.0),
        jnp.asarray(rois.numpy()), jnp.asarray([0, 1], jnp.int32), tile=2,
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
    torch.testing.assert_close(out[0], torch.zeros_like(out[0]), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(out[1], torch.ones_like(out[1]), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------ shared backward ---

@pytest.mark.parametrize("wmax", [48, 160])
def test_accumulate_windows_matches_reference(wmax):
    """Both reference routes (the placement GEMMs for Wmax <= 96, the
    scatter above), overlapping windows, origins outside the buffer
    clamped on both sides."""
    rng = np.random.default_rng(wmax)
    n, rows, c = 13, 30, 4
    row0 = rng.integers(0, rows - 9, n).astype(np.int32)
    x0 = (rng.integers(0, (wmax - 16) // 8 + 1, n) * 8).astype(np.int32)
    row0[:2], x0[2:4] = (-4, rows - 3), (-8, wmax)   # clamped
    gout = rng.normal(size=(n, 7, 7, c)).astype(np.float32)
    wy = rng.normal(size=(n, 7, 10)).astype(np.float32)
    wx = rng.normal(size=(n, 7, 16)).astype(np.float32)
    gwin = np.einsum("niy,nijc,njx->nyxc", wy, gout, wx)
    want = jax.jit(lambda *a: jrk._accumulate_windows(
        *a, (rows, wmax, c), jnp.float32, f32_dot=True))(row0, x0, gwin)
    args = (_t(row0), _t(x0), _t(gout), _t(wy), _t(wx), (rows, wmax, c))
    got = trk.accumulate_windows(*args, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
    # in bf16: the float32 sum rounded once
    torch.testing.assert_close(trk.accumulate_windows(*args, torch.bfloat16),
                               got.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("width", [40, 104])
def test_window_pool_trainable_grad_matches_reference(width, monkeypatch):
    """Wmax 40 takes the reference's placement GEMMs, Wmax 104 its scatter;
    the port takes K4's route for both."""
    rng = np.random.default_rng(width + 1)
    lv = _level(rng, 2, 12, width, 4, 0.5, 12)
    cot = rng.normal(size=(12, 7, 7, 4)).astype(np.float32)
    jcalls = _count_calls(monkeypatch, jrk, ["_place_windows"])

    def jloss(f):
        out = jrk.window_pool_trainable(f, *lv["geo"], 4, True)
        return (out * cot).sum()

    want = jax.jit(jax.grad(jloss))(lv["flat"])
    assert jcalls == (["_place_windows"] if width <= jrk._PLACE_MM_MAX_W
                      else [])
    calls = _count_calls(monkeypatch, trk, ["window_rmw_grad"])
    flat = _t(lv["flat"]).requires_grad_()
    out = trk.window_pool_trainable(flat, *map(_t, lv["geo"]))
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == ["window_rmw_grad"]
    assert flat.grad.shape == want.shape
    np.testing.assert_allclose(flat.grad.numpy(), np.asarray(want), **GRAD)
    assert np.abs(np.asarray(want)).sum() > 0


@pytest.mark.parametrize("width", [40, 104])
def test_resident_pool_trainable_grad_matches_reference(width, monkeypatch):
    """5 views per image (the JAX tile of 2 pads them to 6); image-relative
    rows made absolute in the backward."""
    rng = np.random.default_rng(width + 2)
    b, v, c = 2, 5, 4
    lv = _level(rng, b, 12, width, c, 0.5, b * v)
    rows, wmax = lv["meta"].flat.shape[:2]
    row0, x0, wy, wx = lv["geo"]
    geo = ((row0 - lv["img"] * rows).reshape(b, v), x0.reshape(b, v),
           wy.reshape(b, v, 7, 10), wx.reshape(b, v, 7, 16))
    flat4 = lv["flat"].reshape(b, rows, wmax, c)
    cot = rng.normal(size=(b, v, 7, 7, c)).astype(np.float32)
    fwd = jax.jit(lambda f: jrk.resident_pool_trainable(f, *geo, 2, True))
    want_out = fwd(flat4)
    want = jax.jit(jax.grad(lambda f: (jrk.resident_pool_trainable(
        f, *geo, 2, True) * cot).sum()))(flat4)
    calls = _count_calls(monkeypatch, trk, ["window_rmw_grad"])
    flat = _t(flat4).requires_grad_()
    out = trk.resident_pool_trainable(flat, *map(_t, geo))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **FWD)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == ["window_rmw_grad"]
    np.testing.assert_allclose(flat.grad.numpy(), np.asarray(want), **GRAD)


def test_batched_pyramid_pool_resident_trainable():
    """The batched entry point's trainable route: the gradient of the
    stacked (B * rows, Wmax, C) pyramid equals the reference's; with
    quant_bias it raises, as the reference asserts."""
    rng = np.random.default_rng(7)
    b, v, c = 2, 4, 4
    lv = _level(rng, b, 12, 40, c, 0.5, b * v)
    cot = rng.normal(size=(b * v, 7, 7, c)).astype(np.float32)
    want = jax.jit(jax.grad(lambda f: (jrk.batched_pyramid_pool_resident(
        f, lv["meta"], jnp.asarray(lv["rois"]), b, tile=2, interpret=True,
        trainable=True) * cot).sum()))(lv["flat"])
    flat, meta = trp.build_pyramid_batch(torch.from_numpy(lv["feats"]), 0.5)
    flat = flat.detach().requires_grad_()
    out = trk.batched_pyramid_pool_resident(
        flat, meta, torch.from_numpy(lv["rois"]), b, trainable=True)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(flat.grad.numpy(), np.asarray(want), **GRAD)
    with pytest.raises(ValueError, match="eval-only"):
        trk.batched_pyramid_pool_resident(
            flat, meta, torch.from_numpy(lv["rois"]), b, trainable=True,
            quant_bias=torch.zeros(c))


def test_batched_pyramid_pool_trainable_grad():
    rng = np.random.default_rng(8)
    lv = _level(rng, 2, 12, 104, 4, 0.5, 10)
    cot = rng.normal(size=(10, 7, 7, 4)).astype(np.float32)
    want = jax.jit(jax.grad(lambda f: (jrk.batched_pyramid_pool(
        f, lv["meta"], jnp.asarray(lv["rois"]), jnp.asarray(lv["img"]),
        tile=4, interpret=True, trainable=True) * cot).sum()))(lv["flat"])
    flat, meta = trp.build_pyramid_batch(torch.from_numpy(lv["feats"]), 0.5)
    flat = flat.detach().requires_grad_()
    out = trk.batched_pyramid_pool(flat, meta, torch.from_numpy(lv["rois"]),
                                   torch.from_numpy(lv["img"]),
                                   trainable=True)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(flat.grad.numpy(), np.asarray(want), **GRAD)


def test_window_pool_multi_grad_without_rows_list(monkeypatch):
    """Two levels, Wmax 104 (the reference's scatter) and 56 (its
    placement GEMMs): without rows_list every level goes through
    accumulate_windows."""
    rng = np.random.default_rng(9)
    n, c = 10, 4
    lvs = [_level(rng, 2, 12, 104, c, 0.5, n)]
    feats = rng.normal(size=(2, 6, 52, c)).astype(np.float32)
    jflat, jmeta = jrp.build_pyramid_batch(jnp.asarray(feats), 0.25)
    row0, x0, wy, wx = (np.asarray(a) for a in jax.jit(jrk.view_geometry)(
        jmeta, jnp.asarray(lvs[0]["rois"])))
    row0 = (row0 + lvs[0]["img"] * jmeta.flat.shape[0]).astype(np.int32)
    lvs.append(dict(flat=np.asarray(jflat), geo=(row0, x0, wy, wx)))
    assert [lv["flat"].shape[1] for lv in lvs] == [104, 56]
    geo = [list(a) for a in zip(*(lv["geo"] for lv in lvs))]
    cot = rng.normal(size=(n, 7, 7, c)).astype(np.float32)
    jcalls = _count_calls(monkeypatch, jrk, ["_place_windows"])
    want = jax.jit(jax.grad(lambda fs: (jrk.multi_window_pool_trainable(
        fs, *geo, 4, True) * cot).sum()))([lv["flat"] for lv in lvs])
    assert jcalls == ["_place_windows"]
    calls = _count_calls(monkeypatch, trk, ["window_rmw_grad", "window_grad",
                                            "place_windows_per_image"])
    flats = [_t(lv["flat"]).requires_grad_() for lv in lvs]
    tgeo = [[_t(a) for a in level] for level in geo]
    out = trk.WindowPoolMulti.apply(tgeo, None, None, *flats)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == ["window_rmw_grad"] * 2
    for f, w in zip(flats, want):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(w), **GRAD)
        assert np.abs(np.asarray(w)).sum() > 0


# ---------------------------------------------------------------- probe ---

def _reference_probe():
    """tools/probe_int8_window_dma.py, loaded by path (tools/ is no
    package); only this test imports it."""
    spec = importlib.util.spec_from_file_location(
        "reference_probe_int8_window_dma",
        ROOT / "tools" / "probe_int8_window_dma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference_probe(mod, flat, row0, x0, tile=8):
    """The reference's `run` with cdt = float32 and interpret=True, its grid
    spec otherwise unchanged: bf16 and int8 convert to float32 exactly, the
    ones are exact, and both accumulate in float32."""
    n, c = row0.shape[0], flat.shape[-1]
    return pl.pallas_call(
        partial(mod._kernel, tile=tile, cdt=jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(n // tile,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((tile, 49, c), lambda i, *_: (i, 0, 0)),
            scratch_shapes=[
                pltpu.VMEM((2, tile, mod.WINDOW, mod.WINDOW_X, c),
                           flat.dtype),
                pltpu.SemaphoreType.DMA((2, tile)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((n, 49, c), jnp.bfloat16),
        interpret=True,
    )(row0, x0, flat)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_window_read_probe_plain_matches_reference(dtype):
    """int8: bit for bit (integer sums below 2^24 are exact in float32);
    bf16: within one bf16 rounding of each other (the two float32 sums
    differ in order, so they may round to neighbouring bf16 values)."""
    rng = np.random.default_rng(11)
    rows, wmax, c, n = 40, 48, 8, 16
    x = rng.normal(size=(rows, wmax, c)).astype(np.float32)
    if dtype == "int8":
        jflat = jnp.asarray(np.clip(x * 40, -127, 127).astype(np.int8))
        tflat = torch.from_numpy(np.asarray(jflat))
    else:
        jflat = jnp.asarray(x).astype(jnp.bfloat16)
        tflat = torch.from_numpy(np.asarray(jflat.astype(jnp.float32))).to(
            torch.bfloat16)
    row0 = rng.integers(0, rows - 10, n).astype(np.int32)
    x0 = (rng.integers(0, (wmax - 16) // 8 + 1, n) * 8).astype(np.int32)
    want = np.asarray(jax.jit(partial(_run_reference_probe, _reference_probe()))(
        jflat, jnp.asarray(row0), jnp.asarray(x0)).astype(jnp.float32))
    before = profiling.counters()
    got = tprobe.window_read_probe(tflat, _t(row0), _t(x0))
    assert profiling.kernel_launches(before)["window_read_probe"] == 0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, 49, c)
    got = got.float().numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert (got == got[:, :1]).all()          # the 49 rows are one row


def test_window_read_probe_ref_chunks(monkeypatch):
    """The plain version's chunking over the views changes nothing."""
    flat, row0, x0 = tprobe.probe_inputs(torch.bfloat16, 37, 30, 48, 8,
                                         device="cpu")
    whole = tprobe.window_read_probe_ref(flat, row0, x0)
    monkeypatch.setattr(tprobe, "_REF_SCRATCH", 5 * 160 * 8 * 4)
    torch.testing.assert_close(tprobe.window_read_probe_ref(flat, row0, x0),
                               whole, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_probe_inputs_follow_the_reference_tool(dtype):
    """bench's inputs (tools/probe_int8_window_dma.py:89-96): int8 values
    clipped to +-127, row0 in [0, rows - 10), x0 8-aligned in [0, wmax -
    16)."""
    rows, wmax = 30, 48
    flat, row0, x0 = tprobe.probe_inputs(dtype, 200, rows, wmax, 8,
                                         device="cpu")
    assert flat.dtype == dtype and tuple(flat.shape) == (rows, wmax, 8)
    assert row0.dtype == x0.dtype == torch.int32
    assert 0 <= int(row0.min()) and int(row0.max()) < rows - 10
    assert (x0 % 8 == 0).all() and int(x0.max()) < wmax - 16
    if dtype == torch.int8:
        assert int(flat.abs().max()) <= 127 and flat.float().std() > 10


def test_probe_wrapper_and_bench_need_a_card():
    flat = torch.empty((20, 16, 8), dtype=torch.bfloat16, device="meta")
    geo = (torch.empty(2, dtype=torch.int32, device="meta"),) * 2
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tprobe.window_read_probe(flat, *geo)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobe.bench(torch.bfloat16, 8, 20, 32, 8)
