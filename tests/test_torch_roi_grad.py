"""Port parity, pool backward: the plain versions of K3 (window_grad) and
K4 (window_rmw_grad), the per-image placement, WindowPoolMulti's gradients
on each of its three routes, and the pyramid's VJP, against the JAX
package on the same numpy inputs. The JAX side runs its Pallas kernels in
interpret mode, jitted. Tolerance: float32, atol/rtol 1e-4 (sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.ops import roi_pallas as jrk
from multipathnet_tpu.ops import roi_pyramid as jrp
from multipathnet_tpu_torch.ops import roi_pool as trk
from multipathnet_tpu_torch.ops import roi_pyramid as trp

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rois(rng, n, x_hi=20.0, y_hi=14.0):
    x1 = rng.uniform(0, x_hi, n)
    y1 = rng.uniform(0, y_hi, n)
    w = rng.uniform(4, 26, n)
    h = rng.uniform(4, 16, n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _windows(rng, n, rows, width):
    """Random in-range window origins (x0 8-aligned), overlapping."""
    row0 = rng.integers(0, rows - 9, n).astype(np.int32)
    x0 = np.minimum(rng.integers(0, width, n) // 8 * 8,
                    width - 16).astype(np.int32)
    return row0, x0


def test_window_grad_plain_matches_pallas():
    """K3: 2 images x 5 views (padded to the Pallas tile of 4), overlapping
    windows, image-relative rows."""
    rng = np.random.default_rng(0)
    batch, v, c = 2, 5, 8
    feat = rng.normal(size=(batch, 16, 24, c)).astype(np.float32)
    _, jmeta = jrp.build_pyramid_batch(jnp.asarray(feat), 0.5)
    rows, wmax = jmeta.flat.shape[:2]
    row0, x0, wy, wx = jax.jit(jrk.view_geometry)(
        jmeta, jnp.asarray(_rois(rng, batch * v)))
    gout = rng.normal(size=(batch * v, 7, 7, c)).astype(np.float32)
    want = jax.jit(lambda *a: jrk.pallas_window_grad(
        *a, batch, rows, wmax, tile=4, interpret=True))(
        gout, row0, x0, wy, wx)
    args = (_t(gout), _t(row0), _t(x0), _t(wy), _t(wx), batch, rows, wmax)
    got = trk.window_grad_ref(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(np.asarray(want)[rows:]).sum() > 0   # image 1 written
    torch.testing.assert_close(trk.window_grad(*args), got, rtol=0, atol=0)


def test_window_grad_writes_the_requested_dtype():
    """K3 returns float32 by default, as pallas_window_grad does, and the
    pyramid dtype when its caller asks (WindowPoolMulti's backward): the
    float32 sum rounded once. No views at all gives zeros."""
    rng = np.random.default_rng(7)
    batch, v, rows, width, c = 2, 6, 30, 48, 8
    row0, x0 = _windows(rng, batch * v, rows, width)
    args = (_t(rng.normal(size=(batch * v, 7, 7, c)).astype(np.float32)),
            _t(row0), _t(x0),
            _t(rng.uniform(size=(batch * v, 7, 10)).astype(np.float32)),
            _t(rng.uniform(size=(batch * v, 7, 16)).astype(np.float32)),
            batch, rows, width)
    f32 = trk.window_grad(*args)
    bf16 = trk.window_grad(*args, torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16)) and f32.abs().sum() > 0
    empty = trk.window_grad(args[0][:0], args[1][:0], args[2][:0],
                            args[3][:0], args[4][:0], batch, rows, width)
    assert empty.shape == (batch * rows, width, c) and not empty.any()


def test_window_rmw_grad_plain_matches_pallas():
    """K4: 11 views (padded to the tile), overlapping windows, absolute
    rows, float32 buffer."""
    rng = np.random.default_rng(1)
    n, rows, width, c = 11, 30, 160, 8
    row0, x0 = _windows(rng, n, rows, width)
    wy = rng.normal(size=(n, 7, 10)).astype(np.float32)
    wx = rng.normal(size=(n, 7, 16)).astype(np.float32)
    gout = rng.normal(size=(n, 7, 7, c)).astype(np.float32)
    want = jax.jit(lambda *a: jrk.pallas_window_rmw_grad(
        *a, (rows, width, c), jnp.float32, tile=4, interpret=True))(
        gout, row0, x0, wy, wx)
    args = (_t(gout), _t(row0), _t(x0), _t(wy), _t(wx), (rows, width, c),
            torch.float32)
    got = trk.window_rmw_grad_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(trk.window_rmw_grad(*args), got, rtol=0,
                               atol=0)
    # the buffer dtype is the result's: one rounding of the float32 sum
    bf16 = trk.window_rmw_grad(*args[:-1], torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, got.to(torch.bfloat16), rtol=0, atol=0)


def test_grad_wrappers_reject_windows_outside_the_buffer():
    rng = np.random.default_rng(2)
    n, rows, width, c = 3, 30, 48, 4
    row0, x0 = _windows(rng, n, rows, width)
    row0[1] = rows - 5
    gout = torch.zeros((n, 7, 7, c))
    w = (torch.zeros((n, 7, 10)), torch.zeros((n, 7, 16)))
    with pytest.raises(ValueError, match="outside"):
        trk.window_rmw_grad(gout, _t(row0), _t(x0), *w, (rows, width, c),
                            torch.float32)
    with pytest.raises(ValueError, match="outside"):
        trk.window_grad(gout, _t(row0), _t(x0), *w, 1, rows, width)


def test_place_windows_per_image_matches_reference():
    rng = np.random.default_rng(3)
    batch, v, rows, width, c = 3, 7, 30, 160, 8
    row0, x0 = _windows(rng, batch * v, rows, width)
    gwin = rng.normal(size=(batch * v, 10, 16, c)).astype(np.float32)
    want = jax.jit(lambda *a: jrk._place_windows_per_image(
        *a, batch, rows, width, jnp.float32, f32_dot=True))(row0, x0, gwin)
    got = trk.place_windows_per_image(_t(row0), _t(x0), _t(gwin), batch,
                                      rows, width, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# The three backward routes, forced on both sides by the routing constants
# (as tests/test_roi_pallas_grad.py forces them on the JAX side).
ROUTES = {"k3": (None, None), "placement": (0, 1 << 30), "k4": (0, 0)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_window_pool_multi_grad_matches_reference(route, monkeypatch):
    rng = np.random.default_rng(4)
    batch, v, c = 2, 5, 8
    feats = [rng.normal(size=(batch, h, w, c)).astype(np.float32)
             for h, w in ((16, 24), (8, 12))]
    scales = (0.5, 0.25)
    rois = _rois(rng, batch * v)
    img_idx = np.repeat(np.arange(batch, dtype=np.int32), v)
    cot = rng.normal(size=(batch * v, 7, 7, c)).astype(np.float32)
    budget, cells = ROUTES[route]
    for mod in (jrk, trk):
        if budget is not None:
            monkeypatch.setattr(mod, "_GRAD_VMEM_BUDGET", budget)
            monkeypatch.setattr(mod, "_PLACE_PER_IMAGE_MAX_CELLS", cells)

    jpyr = [jrp.build_pyramid_batch(jnp.asarray(f), s)
            for f, s in zip(feats, scales)]

    def jloss(flats):
        out = jrk.batched_pyramid_pool_multi(
            flats, [m for _, m in jpyr], jnp.asarray(rois),
            jnp.asarray(img_idx), trainable=True, tile=4, interpret=True)
        return (out * cot).sum()

    want = jax.jit(jax.grad(jloss))([f for f, _ in jpyr])

    calls = []
    for name in ("window_grad", "window_rmw_grad", "place_windows_per_image"):
        fn = getattr(trk, name)
        monkeypatch.setattr(trk, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    tpyr = [trp.build_pyramid_batch(torch.from_numpy(f), s)
            for f, s in zip(feats, scales)]
    flats = [f.detach().requires_grad_() for f, _ in tpyr]
    out = trk.batched_pyramid_pool_multi(
        flats, [m for _, m in tpyr], torch.from_numpy(rois),
        torch.from_numpy(img_idx), trainable=True)
    (out * torch.from_numpy(cot)).sum().backward()
    expect = {"k3": "window_grad", "k4": "window_rmw_grad",
              "placement": "place_windows_per_image"}[route]
    assert calls == [expect] * len(feats)
    for f, w in zip(flats, want):
        assert f.grad.shape == w.shape and f.grad.dtype == torch.float32
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(w), **TOL)
        assert np.abs(np.asarray(w)).sum() > 0


def test_build_pyramid_batch_vjp_matches_reference():
    """The pyramid's gradient reaches the trunk map through the slice
    assignments (odd sizes: partial 2x2 cells)."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 21, 27, 6)).astype(np.float32)
    flat, vjp = jax.vjp(lambda f: jrp.build_pyramid_batch(f, 0.25)[0],
                        jnp.asarray(feats))
    cot = rng.normal(size=flat.shape).astype(np.float32)
    (want,) = jax.jit(vjp)(jnp.asarray(cot))
    x = torch.from_numpy(feats).requires_grad_()
    tflat, _ = trp.build_pyramid_batch(x, 0.25)
    tflat.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
