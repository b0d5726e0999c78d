"""The int8 head's kernels (csrc/int8_head.cu: the row quantize and the
epilogue around torch._int_mm) against their plain versions on the card,
and one Detector batch of the int8 + SVD serving head through them.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_int8_head_cuda.py --noconftest -m cuda -q

Codes and scales are held bit for bit. The epilogue's outputs are too,
except where the plain version's float64 sum (rescale_int32's addcmul) is
an exact float32 tie: the kernel's true fused multiply-add rounds the exact
value, the plain version rounds that sum a second time, to even. The tests
check that every element that differs lies on such a tie and one float32
ulp away (_assert_fma_or_tie), and plant elements built to tie so that the
check is seen to work.
"""

import pytest
import torch

from multipathnet_tpu_torch.ops import quant
from multipathnet_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

M = 8000   # the serving cell's rows: 8 images x 1000 proposals
# (K, N) of the cell's int8 + SVD head: fc6_u, fc6, fc7_u, fc7, cls_bbox
CELL_LAYERS = [(25088, 1024), (1024, 4096), (4096, 256), (256, 4096),
               (16384, 810)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(dev, m, k, dtype, seed):
    """(m, k) activations whose rows span six decades, a zero row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    x = x * torch.exp(torch.empty((m, 1), device=dev).uniform_(
        -7, 7, generator=gen))
    x[min(3, m - 1)] = 0.0
    return x.to(dtype)


def _assert_quantize_equal(x, width, amax=None):
    before = profiling.counters()
    got_q, got_s = quant.quantize_rows_padded(x, width, amax)
    want_q, want_s = quant.quantize_rows_padded_ref(x, width, amax)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["quantize_rows"] == 1
    assert got_q.shape == want_q.shape == (x.shape[0], width)
    assert torch.equal(got_q, want_q)
    nan = torch.isnan(want_s)
    assert torch.equal(torch.isnan(got_s), nan)
    assert torch.equal(got_s[~nan], want_s[~nan])
    return got_q, got_s


@pytest.mark.parametrize("k", [k for k, _ in CELL_LAYERS])
def test_quantize_rows_kernel_at_the_cell_shapes(cuda, k):
    """The row quantize of every int8 layer's bf16 input at the cell's
    shapes (25088: the routes whose pool has no epilogue), bit for bit."""
    _assert_quantize_equal(_rows(cuda, M, k, torch.bfloat16, k), k)


@pytest.mark.parametrize("m,k,width,dtype,layout", [
    (1, 256, 256, torch.bfloat16, "rows"),
    (16, 1024, 1024, torch.float32, "rows"),
    (37, 13, 16, torch.bfloat16, "rows"),       # K % 8: one element a load
    (8001, 250, 256, torch.float32, "rows"),
    (300, 1028, 1032, torch.float32, "rows"),   # float32 K % 8 == 4
    (300, 32768, 32768, torch.bfloat16, "rows"),
    (300, 20000, 20000, torch.float32, "rows"),
    (45, 600, 608, torch.bfloat16, "slice"),    # a column block, row stride
    (45, 601, 608, torch.float32, "slice"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_quantize_rows_kernel_edges(cuda, m, k, width, dtype, layout):
    x = _rows(cuda, m, k if layout == "rows" else 3 * k, dtype, m + k)
    if layout == "slice":
        x = x[:, k:2 * k]
    q, _ = _assert_quantize_equal(x, width)
    assert not q[:, k:].any()


def test_quantize_rows_kernel_with_amax_nan_and_inf(cuda):
    """A given amax (a row-parallel layer's maximum over every rank's
    columns: here the whole row's, a column block quantized), and rows
    holding a NaN or an infinity: a NaN row gets a NaN scale and zero codes
    (C11), as the plain version gives it."""
    x = _rows(cuda, 700, 4096, torch.bfloat16, 9)
    x[5, 17] = float("nan")
    x[6, 0] = float("inf")
    x[7, 9] = -float("inf")
    q, s = _assert_quantize_equal(x, 4096)
    assert bool(torch.isnan(s[5])) and not q[5].any()
    assert not bool(torch.isnan(s[6]))
    part = x[:, 1024:2048]
    q_part, s_part = _assert_quantize_equal(part, 1024, quant.row_amax(x))
    assert torch.equal(q_part, q[:, 1024:2048])
    nan = torch.isnan(s)
    assert torch.equal(s_part[~nan], s[~nan])


def _acc(dev, m, n_pad, seed):
    """int32 products of int8 codes: |acc| up to about 2^28."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2 ** 28, 2 ** 28, (m, n_pad), generator=gen,
                         device=dev, dtype=torch.int32)


def _scales(dev, m, n_pad, bias, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.empty((m, 1), device=dev).uniform_(1e-5, 1e-1, generator=gen)
    ws = torch.empty(n_pad, device=dev).uniform_(1e-6, 1e-3, generator=gen)
    b = (torch.randn(n_pad, generator=gen, device=dev) if bias else None)
    return xs, ws, b


def _plant_ties(acc, xs, ws, bias, rows):
    """Makes element (r, 0) of each row r a double-rounding tie: acc =
    6700417, x_scale = 641 * 2^-56, w_scale = 1, bias = 1. 641 x 6700417
    = 2^32 + 1, so the exact value is 1 + 2^-24 + 2^-56: its float64 sum
    is 1 + 2^-24, the midpoint of 1 and 1 + 2^-23, which rounds to even
    (1), while the fused multiply-add rounds the exact value up."""
    acc[rows, 0] = 6700417
    xs[rows] = 641 * 2.0 ** -56
    ws[0] = 1.0
    bias[0] = 1.0


def _assert_fma_or_tie(got, acc, xs, ws, bias, width):
    """got (float32) against the plain epilogue: equal, except where the
    plain float64 sum is an exact float32 midpoint; there one ulp apart,
    the two sides the two float32 values next to it. Returns the number of
    such ties."""
    want = quant.rescale_int32(acc, xs, ws, bias)[:, :width]
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    differ = (got != want) & ~nan
    if bias is None:
        assert not differ.any()
        return 0
    v64 = (bias.double() + acc.float().double()
           * (xs * ws).double())[:, :width]
    g, w = got[differ], want[differ]
    assert torch.equal(torch.nextafter(w, g), g)
    assert torch.equal((g.double() + w.double()) / 2, v64[differ])
    return int(differ.sum())


@pytest.mark.parametrize("k,n", CELL_LAYERS)
def test_epilogue_kernel_at_the_cell_shapes(cuda, k, n):
    """Every layer's epilogue at the cell's shapes: the factors without a
    bias, the others with bias and ReLU (cls_bbox without), bf16 out; the
    same in float32 held to the plain float32 values (ties apart), and the
    bf16 output equal to the float32 one rounded."""
    n_pad = -(-n // 8) * 8
    bias = n not in (1024, 256)
    relu = bias and n != 810
    acc = _acc(cuda, M, n_pad, k)
    xs, ws, b = _scales(cuda, M, n_pad, bias, n)
    if bias:
        _plant_ties(acc, xs, ws, b, [1, 4000, M - 1])
    before = profiling.counters()
    got16 = quant.int8_epilogue(acc, xs, ws, b, width=n,
                                dtype=torch.bfloat16, relu=relu)
    got32 = quant.int8_epilogue(acc, xs, ws, b, width=n)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["int8_epilogue"] == 2
    assert got16.shape == (M, n) and got16.dtype == torch.bfloat16
    ties = _assert_fma_or_tie(got32, acc, xs, ws, b, n)
    want16 = got32.bfloat16()
    assert torch.equal(got16, torch.relu(want16) if relu else want16)
    plain16 = quant.int8_epilogue_ref(acc, xs, ws, b, width=n,
                                      dtype=torch.bfloat16, relu=relu)
    assert int((got16 != plain16).sum()) <= ties
    if bias:
        assert ties >= 3 and float(got32[1, 0]) == 1 + 2.0 ** -23


@pytest.mark.parametrize("m,n_pad,width,dtype,offset,bias,relu", [
    (1, 16, 13, torch.bfloat16, 0, True, True),
    (16, 816, 810, torch.float32, 0, True, False),
    (17, 8, 5, torch.bfloat16, 3, False, True),      # unaligned slice
    (1001, 4096, 4096, torch.bfloat16, 4096, True, True),
    (333, 264, 260, torch.float32, 1, True, True),
    (333, 256, 256, torch.float32, 256, False, False),
], ids=lambda v: str(v).replace("torch.", ""))
def test_epilogue_kernel_edges(cuda, m, n_pad, width, dtype, offset, bias,
                               relu):
    """Few rows, rows not a multiple of the block, logical widths that are
    no multiple of 4 or 8, float32 out, a destination that is a column
    slice of a wider buffer (aligned and not), with and without bias and
    ReLU, and a row whose scale is NaN."""
    acc = _acc(cuda, m, n_pad, m)
    xs, ws, b = _scales(cuda, m, n_pad, bias, width)
    xs[m // 2] = float("nan")
    buf = torch.full((m, offset + width + 5), 7.0, dtype=dtype, device=cuda)
    dest = buf[:, offset:offset + width]
    got = quant.int8_epilogue(acc, xs, ws, b, width=width, dtype=dtype,
                              relu=relu, out=dest)
    torch.cuda.synchronize()
    assert got.data_ptr() == dest.data_ptr()
    assert (buf[:, :offset] == 7).all() and (buf[:, offset + width:] == 7
                                             ).all()
    assert bool(torch.isnan(dest[m // 2]).all())
    got32 = quant.int8_epilogue(acc, xs, ws, b, width=width)
    ties = _assert_fma_or_tie(got32, acc, xs, ws, b, width)
    want = got32.to(dtype)
    assert torch.equal(dest.nan_to_num(), (torch.relu(want) if relu
                                           else want).nan_to_num())
    plain = quant.int8_epilogue_ref(acc, xs, ws, b, width=width, dtype=dtype,
                                    relu=relu)
    assert int((dest.nan_to_num() != plain.nan_to_num()).sum()) <= ties


def test_head_kernels_check_their_inputs(cuda):
    acc = _acc(cuda, 20, 16, 1)
    xs, ws, b = _scales(cuda, 20, 16, True, 1)
    with pytest.raises(ValueError):
        quant.int8_epilogue(acc[:, :12].contiguous()[:, :10], xs, ws, b)
    with pytest.raises(TypeError):
        quant.int8_epilogue(acc, xs, ws.double(), b)
    with pytest.raises(ValueError):
        quant.int8_epilogue(acc, xs, ws[:8], b)
    with pytest.raises(TypeError):
        quant.int8_epilogue(acc, xs, ws, b, dtype=torch.float16)
    with pytest.raises(ValueError):
        quant.int8_epilogue(acc, xs, ws, b, width=16,
                            out=torch.empty((16, 20), device=cuda).t())
    with pytest.raises(TypeError):
        quant.int8_epilogue(acc, xs.cpu(), ws, b)
    x = _rows(cuda, 20, 64, torch.bfloat16, 1)
    with pytest.raises(TypeError):
        quant.quantize_rows_padded(x.half(), 64)
    with pytest.raises(ValueError):
        quant.quantize_rows_padded(x.t(), 64)
    with pytest.raises(ValueError):
        quant.quantize_rows_padded(torch.zeros((2, quant.MAX_ROW + 8),
                                               device=cuda), quant.MAX_ROW + 8)
    with pytest.raises(ValueError):
        quant.quantize_rows_padded(x, 64, torch.ones(19, device=cuda))


def test_detector_batch_counts_the_head_kernels(cuda):
    """One Detector batch of multipath_vgg16_int8_svd, the serving cell's
    preset (fc6 rank 1024, fc7 rank 256, four views) at 2 images x 64
    proposals on a 128^2 canvas: 17 epilogues (4 views x 4 layers +
    cls_bbox) and 13 quantizes (fc6, fc7_u and fc7 a view, cls_bbox's
    input; fc6_u takes the pool kernels' codes), none of the plain passes,
    and the same scores, boxes and detections as the head through its plain
    versions on the card."""
    from types import SimpleNamespace

    from multipathnet_tpu_torch import bench
    from multipathnet_tpu_torch.eval.detect import detect_batch, score_batch

    args = SimpleNamespace(batch=2, proposals=64, canvas=128, backbone=None)
    det, _ = bench.build_preset("multipath_vgg16_int8_svd", args, cuda)
    images, hws, props, mask = (torch.as_tensor(a).to(cuda)
                                for a in bench.make_inputs(args, 0))

    def run():
        with torch.inference_mode():
            return (score_batch(det.model, det.cfg, images, hws, props),
                    detect_batch(det.model, det.cfg, images, hws, props,
                                 mask))

    def head_launches(before):
        launched = profiling.kernel_launches(before)
        return {k: launched[k] for k in ("int8_epilogue", "quantize_rows")}

    run()
    before = profiling.counters()
    detect_batch(det.model, det.cfg, images, hws, props, mask)
    torch.cuda.synchronize()
    assert head_launches(before) == {"int8_epilogue": 17, "quantize_rows": 13}
    got = run()

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(quant, "int8_epilogue", quant.int8_epilogue_ref)
        mp.setattr(quant, "quantize_rows_padded",
                   quant.quantize_rows_padded_ref)
        before = profiling.counters()
        want = run()
        assert not any(head_launches(before).values())
    finally:
        mp.undo()
    (got_boxes, got_probs), got_dets = got
    (want_boxes, want_probs), want_dets = want
    assert torch.equal(got_probs, want_probs)
    assert torch.equal(got_boxes, want_boxes)
    for key in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(got_dets[key], want_dets[key]), key
