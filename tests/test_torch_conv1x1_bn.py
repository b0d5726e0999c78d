"""The ResNet trunks' 1x1 convolution with its frozen BatchNorm as one
kernel (ops/conv_bn.py, csrc/conv1x1_bn.cu, models/layers.conv_bn,
models/backbones/resnet.py).

On the CPU: the plain version (conv1x1_bn_ref, which the wrapper runs for
CPU tensors) against the ops the trunk ran before it, layers.conv_f32 and
bn_epilogue_ref, bit for bit over the relu / residual / out_dtype flags;
the wrapper's refusals; the routing rule (which of a ResNet-101/50/18
trunk's convolutions take the kernel); the packed weight's cache; and a
whole trunk with the kernel's route taken on the CPU (the plain version
in its place) against the trunk's own route, bit for bit, bn.passes still
one a BN. Bits are compared as integers (`_same`), since torch.equal is
false on any NaN.

The `cuda` tests hold the kernel to the plain version on the card: at
every 1x1 shape of a ResNet-101 batch at 8 x 640^2 and every flag
combination on operands whose float32 sums are exact in any order (small
integers times powers of two), bit for bit with NaN and infinities
planted; on random operands within one bf16 step, the share that differs
pinned; and the flags' arithmetic exactly on the kernel's own sums. They
skip where torch.cuda.is_available() is false (decided inside the
fixture, never at import). On a GPU machine:
    python -m pytest tests/test_torch_conv1x1_bn.py --noconftest -m cuda -q
"""

import pytest
import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.models.backbones.resnet import (ResNet18,
                                                            ResNet50,
                                                            ResNet101)
from multipathnet_tpu_torch.ops import batchnorm, conv_bn
from multipathnet_tpu_torch.utils import profiling

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
TRUNKS = {"resnet18": ResNet18, "resnet50": ResNet50,
          "resnet101": ResNet101}
CL = dict(memory_format=torch.channels_last)
# (relu, residual, out_dtype): every combination the kernel takes; the
# trunk uses (relu, float32 out) for Conv_0, (relu, residual) for Conv_2
# and the bare BN for a downsample
FLAGS = [(False, False, None), (True, False, None), (False, False, F32),
         (True, False, F32), (False, True, None), (True, True, None)]
FLAG_IDS = ["bf16", "relu", "f32", "relu_f32", "res", "relu_res"]


def _same(a, b) -> bool:
    """Equal bit for bit (NaNs too), same dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {BF16: torch.int16, F32: torch.int32}[a.dtype]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _bn(c, seed, device="cpu", identity=False):
    """A FrozenBatchNorm of c channels with random statistics and affine,
    or, with `identity`, eps 0 and unit variance and scale, so that the BN
    passes the float32 sum through and only its rounding to bf16 acts."""
    mod = layers.FrozenBatchNorm(c, eps=0.0 if identity else 1e-5,
                                 device=device)
    if not identity:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            mod.weight.copy_((torch.rand(c, generator=gen) + 0.5).to(device))
            mod.running_var.copy_((torch.rand(c, generator=gen) * 1.5
                                   + 0.5).to(device))
            mod.running_mean.copy_((torch.randn(c, generator=gen)
                                    * 0.5).to(device))
            mod.bias.copy_((torch.randn(c, generator=gen) * 0.1).to(device))
    return mod


def _conv(cin, cout, seed, device="cpu", dtype=F32):
    conv = torch.nn.Conv2d(cin, cout, 1, bias=False, device=device,
                           dtype=dtype)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_((torch.randn(conv.weight.shape, generator=gen)
                           * (2.0 / cin) ** 0.5).to(device, dtype))
    return conv


SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0]


def _inputs(shape, cout, seed, device="cpu", exact=False):
    """x (B, C_in, H, W) bf16 channels-last with SPECIALS planted, and a
    bf16 residual (B, C_out, H, W) with SPECIALS planted. With `exact`, x
    holds integers in [-8, 8] times 2^-3 (and the caller's weights
    integers times 2^-4), so every partial sum of a row is exact in
    float32 whatever its order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, cin, h, w = shape
    if exact:
        x = torch.randint(-8, 9, shape, generator=gen, device=device) / 8
    else:
        x = torch.randn(shape, generator=gen, device=device)
    r = torch.randn((b, cout, h, w), generator=gen, device=device)
    for t in (x, r):
        idx = torch.randint(0, t.numel(), (len(SPECIALS),), generator=gen,
                            device=device)
        t.view(-1)[idx] = torch.tensor(SPECIALS, device=device)
    return x.to(BF16).contiguous(**CL), r.to(BF16).contiguous(**CL)


def _todays_ops(conv, bn, x, relu, residual, out_dtype):
    """The convolution and its BN as the trunk ran them before the
    kernel: conv_f32 on the bf16 operands, then bn_epilogue_ref."""
    return batchnorm.bn_epilogue_ref(
        layers.conv_f32(conv, x, BF16), bn.running_mean, bn.mul(), bn.bias,
        BF16, relu=relu, residual=residual, out_dtype=out_dtype)


# ---------------------------------------------------------------- CPU ---

@pytest.mark.parametrize("identity", [False, True], ids=["bn", "identity"])
@pytest.mark.parametrize("relu,residual,out_dtype", FLAGS, ids=FLAG_IDS)
def test_plain_version_is_todays_ops(relu, residual, out_dtype, identity):
    """conv1x1_bn on CPU tensors (its plain version) and layers.conv_bn
    with the kernel's route taken give the bits of conv_f32 followed by
    bn_epilogue_ref, NaN and infinities included."""
    conv = _conv(64, 128, 0)
    bn = _bn(128, 1, identity=identity)
    x, r = _inputs((2, 64, 5, 7), 128, 2)
    res = r if residual else None
    flags = dict(relu=relu, residual=res, out_dtype=out_dtype)
    with torch.no_grad():
        want = _todays_ops(conv, bn, x, **flags)
        got = conv_bn.conv1x1_bn(x, layers.packed_weight(conv), *bn.affine(),
                                 **flags)
    assert want.isnan().any() and want.dtype == (out_dtype or BF16)
    assert got.is_contiguous(**CL) and _same(got, want)


def test_conv_bn_routes_by_device_grad_and_dtype(monkeypatch):
    """layers.conv_bn takes the kernel's route only where
    takes_conv1x1_bn holds (on the card, no gradient, bf16 compute, the
    shape fused_conv1x1 takes); with the device condition dropped, the
    route runs the plain version on the CPU and counts its BN."""
    conv, bn = _conv(64, 64, 3), _bn(64, 4)
    x, _ = _inputs((1, 64, 4, 4), 64, 5)
    calls = []
    kernel = conv_bn.conv1x1_bn
    monkeypatch.setattr(conv_bn, "conv1x1_bn",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    with torch.no_grad():
        assert not layers.takes_conv1x1_bn(conv, x, BF16)   # the CPU
        want = layers.conv_bn(conv, bn, x, BF16, relu=True)
    assert calls == []
    monkeypatch.setattr(layers, "takes_conv1x1_bn",
                        lambda mod, x, dtype: not torch.is_grad_enabled()
                        and layers.fused_conv1x1(mod, dtype))
    before = profiling.counters()
    with torch.no_grad():
        got = layers.conv_bn(conv, bn, x, BF16, relu=True)
        layers.conv_bn(conv, bn, x.float(), F32, relu=True)   # float32
    layers.conv_bn(conv, bn, x, BF16, relu=True)              # a gradient
    assert calls == [1] and _same(got, want)
    passes = profiling.counters()["bn.passes"] - before.get("bn.passes", 0)
    assert passes == 3
    assert profiling.kernel_launches(before)["conv1x1_bn"] == 0


def _offset(t):
    """t's values in a tensor whose data starts 2 bytes past a 16-byte
    boundary, with t's layout."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    if t.dim() == 4:
        b, c, h, w = t.shape
        return buf[1:].view(b, h, w, c).permute(0, 3, 1, 2).copy_(t)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("case", [
    "device", "mixed_device", "x_dtype", "weight_dtype", "out_dtype",
    "x_layout", "weight_layout", "weight_shape", "c_in", "c_out",
    "x_alignment", "weight_alignment", "residual_alignment",
    "residual_f32_out", "residual_dtype", "residual_shape",
    "residual_layout", "vector"])
def test_kernel_wrapper_refuses(case):
    """conv1x1_bn takes bf16 channels-last x, a bf16 (C_out, C_in) weight,
    C_in and C_out multiples of 64, float32 (C_out,) vectors, a bf16
    residual like the output and only with a bf16 output, all 16-byte
    aligned on one device that is the CPU or the card; anything else
    raises, on every device."""
    conv, bn = _conv(64, 128, 6), _bn(128, 7)
    x, r = _inputs((2, 64, 3, 5), 128, 8)
    w, vec = layers.packed_weight(conv), list(bn.affine())
    kw = dict(residual=r, relu=True)
    err, match = ValueError, None
    if case == "device":
        x, w, r = x.to("meta"), w.to("meta"), r.to("meta")
        vec = [v.to("meta") for v in vec]
        kw["residual"], match = r, "CUDA tensors"
    elif case == "mixed_device":
        w, match = w.to("meta"), "weight is on meta"
    elif case == "x_dtype":
        x, err, match = x.float(), TypeError, "must be bf16"
    elif case == "weight_dtype":
        w, err, match = w.float(), TypeError, "must be bf16"
    elif case == "out_dtype":
        kw = dict(out_dtype=torch.float16)
        err, match = TypeError, "bf16 or float32"
    elif case == "x_layout":
        x, match = x.contiguous(), "channels-last"
    elif case == "weight_layout":
        w = w.t().contiguous().t()
        match = "weight must be contiguous"
    elif case == "weight_shape":
        w, match = w[:, :32], r"weight \(C_out, C_in\)"
    elif case == "c_in":
        x = x[:, :32].contiguous(**CL)
        w, match = w[:, :32].contiguous(), "C_in = 32"
    elif case == "c_out":
        w, vec = w[:96].contiguous(), [v[:96].contiguous() for v in vec]
        kw, match = {}, "C_out = 96"
    elif case == "x_alignment":
        x, match = _offset(x), "x must be 16-byte aligned"
    elif case == "weight_alignment":
        w, match = _offset(w), "weight must be 16-byte aligned"
    elif case == "residual_alignment":
        kw["residual"], match = _offset(r), "residual must be 16-byte"
    elif case == "residual_f32_out":
        kw["out_dtype"], match = F32, "only to a bf16 output"
    elif case == "residual_dtype":
        kw["residual"], err, match = r.float(), TypeError, "residual must be"
    elif case == "residual_shape":
        kw["residual"], err, match = r[:1], TypeError, "residual must be"
    elif case == "residual_layout":
        kw["residual"], match = r.contiguous(), "channels-last"
    elif case == "vector":
        vec[1], err, match = vec[1].double(), TypeError, "mul must be"
    before = profiling.counters()
    with torch.no_grad(), pytest.raises(err, match=match):
        conv_bn.conv1x1_bn(x, w, *vec, **kw)
    assert profiling.kernel_launches(before)["conv1x1_bn"] == 0


def _fused_names(trunk, dtype=BF16):
    return {name for name, mod in trunk.named_modules()
            if isinstance(mod, torch.nn.Conv2d)
            and layers.fused_conv1x1(mod, dtype)}


@pytest.mark.parametrize("name,n_fused", [("resnet101", 61),
                                          ("resnet50", 27),
                                          ("resnet18", 0)])
def test_routing_rule_takes_the_stride1_1x1_convolutions(name, n_fused):
    """Which of a trunk's convolutions take the kernel, by kernel size and
    stride alone: in a bottleneck trunk every Conv_0 and Conv_2 (1x1,
    stride 1) and stage 2's downsample (1x1, stride 1), not the 3x3
    convolutions, the stem or the stride-2 downsamples of stages 3 and 4;
    in ResNet-18 none (its one 1x1, the downsample, has stride 2). A
    float32 trunk takes none."""
    trunk = TRUNKS[name](device="meta")
    want = set()
    for mname, mod in trunk.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and mod.kernel_size == (1, 1) \
                and mod.stride == (1, 1):
            want.add(mname)
    got = _fused_names(trunk)
    assert got == want and len(got) == n_fused
    if name != "resnet18":
        assert {n.split(".")[1] for n in got} == {"Conv_0", "Conv_2",
                                                  "Conv_3"}
        assert "stage2_block0.Conv_3" in got
        assert not {"stage3_block0.Conv_3", "stage4_block0.Conv_3"} & got
    assert _fused_names(TRUNKS[name](F32, device="meta"), F32) == set()


def test_packed_weight_follows_the_weight():
    """packed_weight is the weight cast to bf16 as (C_out, C_in): a view
    of a bf16 weight, computed once while nothing changes, again after an
    in-place update, a new Parameter or new storage."""
    conv = _conv(64, 128, 9)
    with torch.no_grad():
        w = layers.packed_weight(conv)
        assert _same(w, conv.weight.to(BF16)[:, :, 0, 0].contiguous())
        assert layers.packed_weight(conv) is w
        conv.weight.mul_(2)
        assert _same(layers.packed_weight(conv),
                     conv.weight.to(BF16)[:, :, 0, 0].contiguous())
        conv.weight = torch.nn.Parameter(torch.ones(128, 64, 1, 1))
        assert _same(layers.packed_weight(conv), torch.ones(128, 64,
                                                            dtype=BF16))
        conv.weight.data = torch.full((128, 64, 1, 1), 3.0)
        assert _same(layers.packed_weight(conv),
                     torch.full((128, 64), 3.0, dtype=BF16))
        half = _conv(64, 64, 10, dtype=BF16)
        assert layers.packed_weight(half).data_ptr() == \
            half.weight.data_ptr()


@torch.no_grad()
def _draw_(model, seed=0):
    """He-normal convolutions; BN scale U(0.2, 0.6), variance U(0.5, 2),
    mean and bias N x 0.1 (the ResNet-101 cell's draw)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, layers.FrozenBatchNorm):
            n = mod.weight.shape[0]
            mod.weight.copy_(torch.rand(n, generator=gen) * 0.4 + 0.2)
            mod.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
            mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)
    for p in model.parameters():
        if p.dim() == 4:
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (2.0 / p[0].numel()) ** 0.5)
    return model


@pytest.mark.parametrize("name,n_fused,passes", [("resnet101", 61, 94),
                                                 ("resnet50", 27, 43),
                                                 ("resnet18", 0, 15)])
def test_kernel_route_on_the_cpu_keeps_the_taps(name, n_fused, passes,
                                                 monkeypatch):
    """A trunk's forward under inference_mode with the kernel's route
    taken on the CPU (takes_conv1x1_bn without its device condition: each
    fused convolution runs conv1x1_bn's plain version on the unwidened
    bf16 input, Conv_1's BN writes bf16) gives the taps of the trunk's own
    CPU route bit for bit; bn.passes still counts every BN, and no kernel
    is launched."""
    model = _draw_(TRUNKS[name](device="cpu", param_dtype=F32), seed=11)
    x = torch.randn((1, 64, 64, 3),
                    generator=torch.Generator().manual_seed(12))
    with torch.inference_mode():
        want = model(x)
    fused = []
    plain = conv_bn.conv1x1_bn
    monkeypatch.setattr(conv_bn, "conv1x1_bn",
                        lambda *a, **k: fused.append(1) or plain(*a, **k))
    monkeypatch.setattr(layers, "takes_conv1x1_bn",
                        lambda mod, x, dtype: not torch.is_grad_enabled()
                        and layers.fused_conv1x1(mod, dtype))
    before = profiling.counters()
    with torch.inference_mode():
        got = model(x)
    launched = profiling.kernel_launches(before)
    assert len(fused) == n_fused
    assert profiling.counters()["bn.passes"] - before.get(
        "bn.passes", 0) == passes
    assert launched["conv1x1_bn"] == launched["bn_epilogue"] == 0
    assert got.keys() == want.keys() == {"c3", "c4", "c5"}
    for k in want:
        assert _same(got[k], want[k]), k


# --------------------------------------------------------------- card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# every 1x1 convolution of a ResNet-101 batch at 8 x 640^2 that takes the
# kernel, as (B, C_in, H, W, C_out) with the trunk's flags: stage 2 (160^2),
# stage 3 (80^2; its block 0's Conv_0 at 160^2), stage 4 (40^2; block 0's
# Conv_0 at 80^2); and a ragged shape (rows not a multiple of 128, C_out
# not of 128)
RESNET101_1X1 = [
    ((8, 64, 160, 160, 64), "relu_f32"),      # stage2 block0 Conv_0
    ((8, 256, 160, 160, 64), "relu_f32"),     # stage2 Conv_0
    ((8, 64, 160, 160, 256), "relu_res"),     # stage2 Conv_2
    ((8, 64, 160, 160, 256), "bf16"),         # stage2 downsample
    ((8, 256, 160, 160, 128), "relu_f32"),    # stage3 block0 Conv_0
    ((8, 512, 80, 80, 128), "relu_f32"),      # stage3 Conv_0
    ((8, 128, 80, 80, 512), "relu_res"),      # stage3 Conv_2
    ((8, 512, 80, 80, 256), "relu_f32"),      # stage4 block0 Conv_0
    ((8, 1024, 40, 40, 256), "relu_f32"),     # stage4 Conv_0
    ((8, 256, 40, 40, 1024), "relu_res"),     # stage4 Conv_2
    ((2, 192, 13, 17, 320), "relu_res"),      # ragged
]
SHAPE_IDS = [f"{b}x{cin}x{h}x{w}-{cout}" for (b, cin, h, w, cout), _ in
             RESNET101_1X1]


def _exact_conv(cin, cout, seed, device):
    """A bf16 1x1 weight of integers in [-8, 8] times 2^-4."""
    conv = torch.nn.Conv2d(cin, cout, 1, bias=False, device=device,
                           dtype=BF16)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_((torch.randint(-8, 9, conv.weight.shape,
                                         generator=gen) / 16).to(device))
    return conv


def _exact_sum(x, w):
    """The float32 sum of x (B, C_in, H, W) and w (C_out, C_in), both bf16,
    from a float64 product (exact where every partial sum is), as the
    (B, C_out, H, W) channels-last tensor the convolution gives."""
    b, cin, h, wd = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(-1, cin).double()
    s = (rows @ w.double().t()).float()
    return s.view(b, h, wd, -1).permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("identity", [False, True], ids=["bn", "identity"])
@pytest.mark.parametrize("relu,residual,out_dtype", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("shape", [s for s, _ in RESNET101_1X1],
                         ids=SHAPE_IDS)
def test_kernel_equals_plain_version_on_exact_sums(cuda, shape, relu,
                                                   residual, out_dtype,
                                                   identity):
    """At every ResNet-101 1x1 shape and flag combination, on operands
    whose sums are exact in float32 in any order, the kernel's output is
    bit-equal to bn_epilogue_ref of the exact sum, NaN and infinities
    planted in x and the residual; with the identity BN every bf16
    rounding of the sums, ties included, is the plain version's."""
    b, cin, h, w, cout = shape
    conv = _exact_conv(cin, cout, 13, cuda)
    bn = _bn(cout, 14, cuda, identity)
    x, r = _inputs((b, cin, h, w), cout, 15, cuda, exact=True)
    res = r if residual else None
    flags = dict(relu=relu, residual=res, out_dtype=out_dtype)
    wt = layers.packed_weight(conv)
    before = profiling.counters()
    with torch.inference_mode():
        got = conv_bn.conv1x1_bn(x, wt, *bn.affine(), **flags)
        want = batchnorm.bn_epilogue_ref(
            _exact_sum(x, wt), bn.running_mean, bn.mul(), bn.bias, BF16,
            **flags)
    assert profiling.kernel_launches(before)["conv1x1_bn"] == 1
    assert got.is_contiguous(**CL) and got.dtype == (out_dtype or BF16)
    assert want.isnan().any() and want.isinf().any()
    assert _same(got, want)


def _bf16_step(x):
    """The bf16 spacing at |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


# the share of a random instance's bf16 outputs that may differ from the
# plain version's: float32 sums in another order move a rounding
# (0.004-0.056% read at the shapes below on an NVIDIA H100)
RANDOM_SHARE = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _ in RESNET101_1X1],
                         ids=SHAPE_IDS)
def test_kernel_on_random_operands(cuda, shape):
    """Random bf16 operands at every ResNet-101 1x1 shape, with the
    identity BN (so that the output is the float32 sum rounded to bf16,
    and a BN's subtraction of the mean does not magnify the sums' float32
    differences): the kernel's output within one bf16 step, at the
    output's largest magnitude, of the plain version's (float32
    convolution, TF32 off; a sum that cancels to near zero differs by
    more of its own steps), the share that differs at most RANDOM_SHARE;
    and each flag's output exactly that bare output's ReLU, widening or
    bf16 residual sum (the kernel's sums do not depend on its flags)."""
    b, cin, h, w, cout = shape
    conv = _conv(cin, cout, 16, cuda, BF16)
    bn = _bn(cout, 17, cuda, identity=True)
    x, r = _inputs((b, cin, h, w), cout, 18, cuda)
    # keep NaN and infinities out of the tolerance
    x = torch.where(x.isfinite(), x, 0).contiguous(**CL)
    r = torch.where(r.isfinite(), r, 0).contiguous(**CL)
    wt = layers.packed_weight(conv)
    vec = bn.affine()
    with torch.inference_mode():
        bare = conv_bn.conv1x1_bn(x, wt, *vec)
        plain = conv_bn.conv1x1_bn_ref(x, wt, *vec)
        diff = (bare.float() - plain.float()).abs()
        step = _bf16_step(plain.float().abs().max())
        assert bool((diff <= step).all()), float((diff / step).max())
        share = float((diff > 0).float().mean())
        assert share <= RANDOM_SHARE, share
        for relu, residual, out_dtype in FLAGS[1:]:
            got = conv_bn.conv1x1_bn(x, wt, *vec, relu=relu,
                                     residual=r if residual else None,
                                     out_dtype=out_dtype)
            want = r + bare if residual else bare
            want = F.relu(want) if relu else want
            assert _same(got, want.to(out_dtype or BF16)), (relu, residual,
                                                             out_dtype)
