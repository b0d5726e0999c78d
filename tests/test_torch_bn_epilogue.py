"""The frozen-BatchNorm epilogue of the ResNet trunks (ops/batchnorm.py,
csrc/bn_epilogue.cu, models/layers.FrozenBatchNorm, models/backbones/
resnet.py) against the arithmetic the port ran before it, bit for bit.

`_today_*` below are copies of FrozenBatchNorm.forward, layers.conv_f32
and the blocks' forwards as they were before the epilogue: a BN in three
float32 roundings then one cast, the ReLU and the residual add as their
own ops, each convolution widening its own copy of its input. The plain
version (bn_epilogue_ref), every route of FrozenBatchNorm.forward and the
restructured blocks (the downsample before the last convolution, the
block input widened once where no gradient is recorded, the BN outputs
that only a convolution reads widened by the BN) must give the same bits,
NaN, infinities, -0 and bf16 rounding ties included. Bits are compared
as integers (`_same`), since torch.equal is false on any NaN.

The `cuda` tests hold the kernel to the plain version on the card: at
every instance of a ResNet-101 batch at 8 x 640^2 that it still runs (33:
the stem, the 3x3 convolutions and the stride-2 downsamples; the other 61
BNs run with their 1x1 convolution in csrc/conv1x1_bn.cu,
tests/test_torch_conv1x1_bn.py), on the special values, the served
c3/c4/c5 against the plain route in one process, and the launch
counters. They skip where
torch.cuda.is_available() is false (decided inside the fixture, never at
import). On a GPU machine:
    python -m pytest tests/test_torch_bn_epilogue.py --noconftest -m cuda -q
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.models.backbones.resnet import (BasicBlock,
                                                            BottleneckBlock,
                                                            ResNet18,
                                                            ResNet50,
                                                            ResNet101)
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import batchnorm
from multipathnet_tpu_torch.utils import profiling

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
TRUNKS = {"resnet18": ResNet18, "resnet50": ResNet50,
          "resnet101": ResNet101}


def _same(a, b) -> bool:
    """Equal bit for bit (NaNs too), same dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {BF16: torch.int16, F32: torch.int32}[a.dtype]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


# ---------------------------------- the arithmetic before the epilogue ---

def _today_bn(mod, x, dtype):
    mul = torch.rsqrt(mod.running_var + mod.eps) * mod.weight
    y = x.float() - mod.running_mean[:, None, None]
    y = y * mul[:, None, None]
    return (y + mod.bias[:, None, None]).to(dtype)


def _today_conv_f32(mod, x, dtype):
    w = mod.weight.to(dtype)
    x = x.to(dtype)
    if dtype != F32:
        w, x = w.float(), x.float()
    args = (w, None, mod.stride, mod.padding, mod.dilation, mod.groups)
    if not x.is_cuda or dtype == F32:
        return F.conv2d(x, *args)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return F.conv2d(x, *args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _today_conv_bn(block, k, x):
    return _today_bn(getattr(block, f"BatchNorm_{k}"), _today_conv_f32(
        getattr(block, f"Conv_{k}"), x, block.dtype), block.dtype)


def _today_block(block, x):
    if isinstance(block, BasicBlock):
        y = _today_conv_bn(block, 1, F.relu(_today_conv_bn(block, 0, x)))
        if block.down:
            x = _today_conv_bn(block, 2, x)
        return F.relu(x + y)
    y = F.relu(_today_conv_bn(block, 1, F.relu(_today_conv_bn(block, 0, x))))
    y = _today_conv_bn(block, 2, y)
    if block.down:
        x = _today_conv_bn(block, 3, x)
    return F.relu(x + y)


def _today_trunk(model, x):
    x = x.to(model.dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.relu(_today_bn(model.stem_bn, _today_conv_f32(
        model.stem, x, model.dtype), model.dtype))
    x = F.max_pool2d(x, 3, 2, padding=1)
    feats = {}
    for si, n_blocks in enumerate(model.stage_sizes):
        for bi in range(n_blocks):
            x = _today_block(getattr(model, f"stage{si + 2}_block{bi}"), x)
        feats[f"c{si + 3}"] = x.permute(0, 2, 3, 1)
    return feats


# ------------------------------------------------------------- inputs ---

@torch.no_grad()
def _draw_(model, seed=0):
    """He-normal convolutions; BN scale U(0.2, 0.6), variance U(0.5, 2),
    mean and bias N x 0.1; every other parameter N x 0.02 (the ResNet-101
    cell's draw, so the maps stay of order one through 30 blocks)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, layers.FrozenBatchNorm):
            n = mod.weight.shape[0]
            mod.weight.copy_(torch.rand(n, generator=gen) * 0.4 + 0.2)
            mod.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
            mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)
    for name, p in model.named_parameters():
        if p.dim() == 4:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (2.0 / fan_in) ** 0.5)
        elif p.dim() != 1 or "BatchNorm" not in name and "bn" not in name:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def _bn(c, seed, ties=False, device="cpu"):
    """A FrozenBatchNorm of c channels: random statistics and affine, or,
    with `ties`, the identity (eps 0, so mul is exactly 1)."""
    mod = layers.FrozenBatchNorm(c, eps=0.0 if ties else 1e-5,
                                 device=device)
    if not ties:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            mod.weight.copy_(torch.rand(c, generator=gen) + 0.5)
            mod.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
            mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.5)
            mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
    return mod


# bf16 rounding ties: 1 + 2^-8 lies halfway between 1 and 1 + 2^-7 (to 1),
# 1 + 3 x 2^-8 between 1 + 2^-7 and 1 + 2^-6 (to 1 + 2^-6); a tie among
# the subnormals; past bf16's largest finite value; tiny negatives that
# round to -0
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0,
            1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3 * 2 ** -134,
            3.3961776e38, -3.3961776e38, -1e-45, -2 ** -140]
# residuals whose sum with the ties' rounded BN output ties again
RES_TIES = [1.0, 2 ** -8, 3 * 2 ** -8, -1.0, -2 ** -8]


def _maps(c=16, seed=0, ties=False, device="cpu"):
    """(x float32, residual bf16, residual float32), (2, c, 5, 7)
    channels-last, with SPECIALS planted in x and, for ties, sums that
    tie."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (2, c, 5, 7)
    x = torch.randn(shape, generator=gen) * 2
    r = torch.randn(shape, generator=gen)
    if ties:
        n = x.numel()
        x = torch.tensor(SPECIALS).repeat(n)[:n].reshape(shape)
        r = torch.tensor(RES_TIES).repeat(n)[:n].reshape(shape)
    else:
        flat = x.view(-1)
        idx = torch.randperm(flat.numel(), generator=gen)[:len(SPECIALS)]
        flat[idx] = torch.tensor(SPECIALS)
    cl = dict(memory_format=torch.channels_last)
    x = x.to(device).contiguous(**cl)
    return (x, r.to(device, BF16).contiguous(**cl),
            r.to(device).contiguous(**cl))


def _today_epilogue(mod, x, dtype, relu, residual, out_dtype):
    y = _today_bn(mod, x, dtype)
    if residual is not None:
        y = residual + y
    if relu:
        y = F.relu(y)
    return y.to(out_dtype or dtype)


# (compute dtype, output dtype): the bf16 trunk's two outputs, and float32
EPILOGUE_DTYPES = [(BF16, None), (BF16, F32), (F32, None)]


# ---------------------------------------------------------------- CPU ---

@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype,out_dtype", EPILOGUE_DTYPES,
                         ids=["bf16", "bf16_to_f32", "f32"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
@pytest.mark.parametrize("relu", [False, True], ids=["", "relu"])
def test_plain_version_is_todays_sequence(relu, residual, dtype, out_dtype,
                                          ties):
    """bn_epilogue_ref and FrozenBatchNorm.forward, with and without a
    gradient, give the bits of the BN, residual add and ReLU as the port
    ran them before the epilogue."""
    mod = _bn(16, 3, ties)
    x, r16, r32 = _maps(ties=ties)
    res = (r16 if dtype == BF16 else r32) if residual else None
    flags = dict(relu=relu, residual=res, out_dtype=out_dtype)
    want = _today_epilogue(mod, x, dtype, relu, res, out_dtype)
    assert want.isnan().any() and want.isinf().any()
    mul = torch.rsqrt(mod.running_var + mod.eps) * mod.weight
    with torch.no_grad():
        assert _same(batchnorm.bn_epilogue_ref(
            x, mod.running_mean, mul, mod.bias, dtype, **flags), want)
        assert _same(mod(x, dtype, **flags), want)
    got = mod(x, dtype, **flags)
    assert got.requires_grad and _same(got.detach(), want.detach())


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
@pytest.mark.parametrize("relu", [False, True], ids=["", "relu"])
def test_float32_output_is_the_bf16_output_widened(relu, residual, ties):
    mod = _bn(16, 4, ties)
    x, r16, _ = _maps(seed=1, ties=ties)
    flags = dict(relu=relu, residual=r16 if residual else None)
    with torch.no_grad():
        wide = mod(x, BF16, out_dtype=F32, **flags)
        assert _same(wide, mod(x, BF16, **flags).float())


def _offset(t):
    """t's values in a tensor whose data starts 4 bytes past a 16-byte
    boundary, channels-last."""
    b, c, h, w = t.shape
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    return out.copy_(t)


@pytest.mark.parametrize("case", ["device", "meta", "x_dtype", "layout",
                                  "channels", "alignment", "residual_dtype",
                                  "residual_layout", "residual_shape",
                                  "out_dtype"])
def test_kernel_wrapper_refuses(case):
    """bn_epilogue takes float32 channels-last maps with C % 8 == 0 on the
    card, 16-byte aligned, a residual like them in the compute dtype;
    anything else raises (here on the CPU, where every tensor is
    refused)."""
    mod = _bn(16, 5)
    x, r16, r32 = _maps(seed=2)
    vec = (mod.running_mean, mod.weight, mod.bias)
    kw = dict(residual=r16)
    dtype, err, match = BF16, ValueError, "CUDA tensors"
    if case == "meta":
        x = x.to("meta")
    elif case == "x_dtype":
        x, err, match = x.to(BF16), TypeError, "x must be"
    elif case == "layout":
        x, match = x.contiguous(), "channels-last"
    elif case == "channels":
        x, kw, vec = x[:, :12], {}, tuple(v[:12] for v in vec)
        x, match = x.contiguous(memory_format=torch.channels_last), "C = 12"
    elif case == "alignment":
        x, match = _offset(x), "16-byte aligned"
    elif case == "residual_dtype":
        kw, err, match = dict(residual=r32), TypeError, "residual must be"
    elif case == "residual_layout":
        kw, match = dict(residual=r16.contiguous()), "channels-last"
    elif case == "residual_shape":
        kw, match = dict(residual=r16[:1]), "residual must be"
    elif case == "out_dtype":
        dtype, err, match = F32, TypeError, "output"
        kw = dict(residual=r32, out_dtype=BF16)
    with torch.no_grad(), pytest.raises(err, match=match):
        batchnorm.bn_epilogue(x, *vec, dtype, **kw)
    assert profiling.kernel_launches()["bn_epilogue"] == 0


def test_other_devices_raise_in_the_module():
    """FrozenBatchNorm takes the plain version on the CPU and wherever a
    gradient is recorded, the kernel on the card, and raises elsewhere."""
    mod = _bn(16, 6).to("meta")
    x = _maps(seed=3)[0].to("meta")
    assert mod(x, BF16).device.type == "meta"   # a gradient: plain ops
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        mod(x, BF16)


def test_affine_is_mul_as_torch_computes_it_and_follows_the_weights():
    """affine()'s rows are running_mean, rsqrt(var + eps) * weight and
    bias bit for bit; computed once while nothing changes, again after an
    in-place update, a new Parameter or new storage."""
    mod = _bn(64, 7)
    with torch.no_grad():
        mean, mul, bias = mod.affine()
        want = torch.rsqrt(mod.running_var + mod.eps) * mod.weight
        assert _same(mul, want) and _same(mean, mod.running_mean)
        assert _same(bias, mod.bias) and mul.data_ptr() % 16 == 0
        assert mod.affine()[1].data_ptr() == mul.data_ptr()   # cached
        mod.weight.mul_(2)
        assert _same(mod.affine()[1], want * 2)
        mod.bias = torch.nn.Parameter(torch.ones(64))
        assert _same(mod.affine()[2], torch.ones(64))
        mod.running_var.data = torch.full((64,), 4.0)
        assert _same(mod.affine()[1],
                     torch.rsqrt(torch.full((64,), 4.0) + mod.eps)
                     * mod.weight)


def _block(kind, down, dtype=BF16, seed=0):
    cin = 32 if down else (16 if kind is BasicBlock else 64)
    block = kind(cin, 16, 2 if down else 1, dtype=dtype, device="cpu",
                 param_dtype=F32)
    assert block.down == down
    return _draw_(block, seed), cin


@pytest.mark.parametrize("down", [False, True], ids=["identity", "down"])
@pytest.mark.parametrize("kind", [BasicBlock, BottleneckBlock],
                         ids=["basic", "bottleneck"])
def test_block_backpropagates_as_before(kind, down):
    """With a gradient recorded the block runs the plain ops: the output
    and every gradient (BN scale and bias, the convolutions, the input)
    are those of the block's forward before the epilogue, bit for bit."""
    block, cin = _block(kind, down)
    x = torch.randn((2, cin, 9, 9), generator=torch.Generator().manual_seed(
        1)).to(BF16).contiguous(memory_format=torch.channels_last)
    g = torch.randn((2, 16 * kind.expansion, 5 if down else 9,
                     5 if down else 9),
                    generator=torch.Generator().manual_seed(2))
    grads = []
    for fn in (block, lambda t: _today_block(block, t)):
        block.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        (y.float() * g).sum().backward()
        grads.append((y.detach(), xi.grad, {
            n: p.grad for n, p in block.named_parameters()}))
    (y, gx, gp), (y0, gx0, gp0) = grads
    assert _same(y, y0) and _same(gx, gx0)
    assert gp.keys() == gp0.keys()
    for n in gp:
        assert _same(gp[n], gp0[n]), n
        if "BatchNorm" in n:
            assert gp[n].abs().sum() > 0, n


@pytest.mark.parametrize("grad", [False, True], ids=["serving", "grad"])
@pytest.mark.parametrize("name,dtype", [("resnet18", BF16),
                                        ("resnet18", F32),
                                        ("resnet50", BF16),
                                        ("resnet101", BF16)])
def test_trunk_taps_equal_todays_blocks(name, dtype, grad):
    """c3/c4/c5 of the restructured trunks equal those of the blocks'
    forwards before the epilogue, bit for bit, with the serving route's
    widening (no gradient) and the training route's."""
    model = _draw_(TRUNKS[name](dtype=dtype, device="cpu", param_dtype=F32),
                   seed=4)
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(
        5))
    with torch.set_grad_enabled(grad):
        got = model(x)
        want = _today_trunk(model, x)
    assert got.keys() == want.keys() == {"c3", "c4", "c5"}
    for k in want:
        assert got[k].dtype == dtype and _same(got[k].detach(),
                                               want[k].detach()), k
        assert got[k].float().std() > 1e-2, k   # not a vanishing map


def test_cpu_launches_no_kernel_and_counts_every_bn():
    """A ResNet-18 trunk's forward on the CPU: bn.passes counts its 15
    BNs, launches.bn_epilogue stays 0."""
    model = _draw_(ResNet18(device="cpu", param_dtype=F32))
    before = profiling.counters()
    with torch.inference_mode():
        model(torch.randn(1, 32, 32, 3))
    after = profiling.counters()
    assert after["bn.passes"] - before.get("bn.passes", 0) == 15
    assert after["launches.bn_epilogue"] == before[
        "launches.bn_epilogue"] == 0


# --------------------------------------------------------------- card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype,out_dtype", EPILOGUE_DTYPES,
                         ids=["bf16", "bf16_to_f32", "f32"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
@pytest.mark.parametrize("relu", [False, True], ids=["", "relu"])
def test_kernel_equals_plain_version_on_special_values(
        cuda, relu, residual, dtype, out_dtype, ties):
    mod = _bn(16, 3, ties, device=cuda)
    x, r16, r32 = _maps(ties=ties, device=cuda)
    res = (r16 if dtype == BF16 else r32) if residual else None
    flags = dict(relu=relu, residual=res, out_dtype=out_dtype)
    before = profiling.counters()
    with torch.inference_mode():
        got = mod(x, dtype, **flags)
        want = batchnorm.bn_epilogue_ref(x, mod.running_mean, mod.mul(),
                                         mod.bias, dtype, **flags)
    assert profiling.kernel_launches(before)["bn_epilogue"] == 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _same(got, want)
    assert _same(want, _today_epilogue(mod, x, dtype, relu, res,
                                       out_dtype))


@pytest.mark.cuda
def test_kernel_equals_plain_version_at_every_resnet101_instance(
        cuda, monkeypatch):
    """Each BN of a ResNet-101 trunk's batch at the serving cell's 8 x
    640^2 that runs through FrozenBatchNorm.forward (33: the stem, the 30
    3x3 convolutions and the 2 stride-2 downsamples; the other 61 run
    with their 1x1 convolution as one kernel), on the inputs the trunk
    gives it: the kernel's output against the plain version's, bit for
    bit."""
    model = _draw_(ResNet101(device="cpu", param_dtype=F32), seed=6).to(
        cuda)
    forward = layers.FrozenBatchNorm.forward
    seen = []

    def both(self, x, dtype, **flags):
        got = forward(self, x, dtype, **flags)
        want = batchnorm.bn_epilogue_ref(x, self.running_mean, self.mul(),
                                         self.bias, dtype, **flags)
        seen.append((tuple(x.shape), sorted(
            k for k, v in flags.items() if v is not None and v is not False),
            _same(got, want)))
        return got

    monkeypatch.setattr(layers.FrozenBatchNorm, "forward", both)
    x = torch.randn((8, 640, 640, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    before = profiling.counters()
    with torch.inference_mode():
        feats = model(x)
    torch.cuda.synchronize()
    launched = profiling.kernel_launches(before)
    assert len(seen) == 33
    assert launched["bn_epilogue"] == 33 and launched["conv1x1_bn"] == 61
    passes = profiling.counters()["bn.passes"] - before.get("bn.passes", 0)
    assert passes == 94
    assert [s for s in seen if not s[2]] == []
    assert all(f.isfinite().all() and f.float().std() > 1e-2
               for f in feats.values())


# the bf16 steps at a level's largest magnitude that the served maps may
# differ by from the plain route, and the share of values that may differ
# at all: 61 of ResNet-101's convolutions sum in another order on the
# kernel's route (csrc/conv1x1_bn.cu), and a moved rounding carries on
# through the 3x3 convolutions and the residual sums, as against the JAX
# package (tests/test_torch_backbones.py::_BF16_STEPS: 1 step, 4 at
# ResNet-101's c5). Read on an NVIDIA H100, two draws: 1 / 1 / 1.5-2
# steps, shares 0.09-0.14% / 7.7-9.5% / 67.4-69.9%.
SERVED_STEPS = {"c3": 1, "c4": 1, "c5": 4}
SERVED_SHARE = {"c3": 0.003, "c4": 0.15, "c5": 0.8}


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("resnet101", BF16),
                                        ("resnet18", F32)])
def test_served_maps_equal_the_plain_route(cuda, name, dtype):
    """The model's reduced c3/c4/c5 (features) under inference_mode, the
    kernels' route, against the same model with a gradient recorded, the
    plain route, in one process: bit for bit where no 1x1 convolution
    takes csrc/conv1x1_bn.cu (ResNet-18 in float32); for the bf16
    ResNet-101, whose 61 fused convolutions sum in another order, within
    SERVED_STEPS bf16 steps at each level's largest magnitude, the share
    that differs at most SERVED_SHARE."""
    cfg = preset("multipath_resnet101_int8_svd")
    model = _draw_(build_model(dataclasses.replace(
        cfg.model, backbone=name, dtype="bfloat16" if dtype == BF16
        else "float32"), device=cuda), seed=8)
    x = torch.randn((4, 640, 640, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(9))
    before = profiling.counters()
    with torch.inference_mode():
        got = model.features(x)
    launched = profiling.kernel_launches(before)
    assert launched["bn_epilogue"] > 0
    assert (launched["conv1x1_bn"] > 0) == (name == "resnet101")
    before = profiling.counters()
    with torch.enable_grad():
        want = model.features(x)
    launched = profiling.kernel_launches(before)
    assert launched["bn_epilogue"] == launched["conv1x1_bn"] == 0
    assert got.keys() == want.keys() == {"c3", "c4", "c5"}
    for k in want:
        if name != "resnet101":
            assert _same(got[k], want[k].detach()), k
            continue
        g, w = got[k].float(), want[k].detach().float()
        scale = float(w.abs().max())
        step = 2.0 ** (torch.floor(torch.log2(torch.tensor(scale))) - 7)
        diff = float((g - w).abs().max())
        share = float((g != w).float().mean())
        assert diff <= SERVED_STEPS[k] * float(step), (k, diff, scale)
        assert share <= SERVED_SHARE[k], (k, share)


@pytest.mark.cuda
@pytest.mark.parametrize("backbone,passes,epilogues,fused", [
    ("resnet101", 94, 33, 61), ("resnet18", 15, 15, 0), ("vgg16", 0, 0, 0)])
def test_a_detector_batch_launches_one_kernel_a_bn(cuda, backbone, passes,
                                                   epilogues, fused):
    """launches.bn_epilogue, launches.conv1x1_bn and bn.passes over one
    Detector call on the card: one launch a BN, of one kernel or the
    other (ResNet-101: 61 BNs with their 1x1 convolution, 33 alone; 0 for
    VGG-16)."""
    cfg = preset("multipath_resnet101_int8_svd")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, backbone=backbone),
        data=dataclasses.replace(cfg.data, image_size=(256, 256),
                                 max_proposals=16))
    det = Detector(_draw_(build_model(cfg.model, device=cuda)), cfg, "cuda")
    gen = torch.Generator().manual_seed(10)
    images = torch.randint(0, 256, (2, 256, 256, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    hws = torch.tensor([[256.0, 256.0]] * 2).numpy()
    xy = torch.rand((2, 16, 2), generator=gen) * 150
    wh = torch.rand((2, 16, 2), generator=gen) * 90 + 8
    props = torch.cat([xy, xy + wh], -1).numpy()
    mask = torch.ones((2, 16), dtype=torch.bool).numpy()
    det(images, hws, props, mask)
    before = profiling.counters()
    det(images, hws, props, mask)
    after = profiling.counters()
    for name, n in (("launches.bn_epilogue", epilogues),
                    ("launches.conv1x1_bn", fused), ("bn.passes", passes)):
        assert after[name] - before.get(name, 0) == n, name
