"""ResNet trunks — port of multipathnet_tpu/models/backbones/resnet.py.

Residual v1 trunks with frozen BatchNorm (models/layers.FrozenBatchNorm:
running statistics in train and eval alike, only the affine scale and
bias train). c3/c4/c5 are the outputs of the stages at strides 4/8/16;
the stride-32 stage is past the detection trunk, as in the reference.

Each convolution feeds its BatchNorm in float32 (models/layers.conv_f32),
which rounds once to the compute dtype, as the reference's XLA computes
it; residual sums run in the compute dtype. The BN takes the residual add
and the ReLU after it too (FrozenBatchNorm.forward; one kernel on the
card, with a backward kernel of its own under a gradient), so a block
computes its downsample before its last
convolution, whose residual it is. A BN output that only a convolution
reads comes back widened to float32, the copy that convolution would
otherwise make. Serving a bf16 trunk on the card, each stride-1 1x1
convolution with channels in multiples of 64 runs with its BN as one
kernel on bf16 operands (layers.conv_bn, csrc/conv1x1_bn.cu: a
bottleneck's Conv_0 and Conv_2 and a stride-1 downsample), which reads
the block input and Conv_1's BN output in bf16, unwidened.

Padding is explicit, as in the reference: every 3x3 convolution (the
stride-2 ones too) pads (1, 1), the 1x1 downsample pads nothing, the stem
is a 7x7 stride-2 convolution padded (3, 3), then a 3x3 stride-2 max-pool
padded (1, 1) with -inf. Modules carry the flax paths' names (stem,
stem_bn, stage{2,3,4}_block{i} with Conv_k/BatchNorm_k, the downsample on
the next free index: Conv_2 in a basic block, Conv_3 in a bottleneck), so
models/convert.py maps trees path for path. `freeze_stages` detaches the
activations after stage N (stage 1 = the stem), the reference's
stop_gradient.

`forward` opens the spans features.stem (the stem convolution, its BN and
the max-pool) and features.stage2..4 (each stage's blocks), inside the
model's features span (utils/profiling), so that a trace tells the
stages' device time apart. A traced forward that records a gradient also
puts a span features.stageN.backward around each training stage's
backward (`_BackwardSpans`), opened and closed by autograd hooks on
autograd's thread, where train.backward adopts them. Inside a step of
`StageGraphs` (which train/loop.Trainer opens on the card) a training
stage runs as CUDA graphs of its forward and backward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.utils import profiling


def _conv(cin, cout, k, stride, pad, device, dtype):
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False, device=device,
                     dtype=dtype)


class _Block(nn.Module):
    def _conv_bn(self, k: int, x: torch.Tensor, **epilogue) -> torch.Tensor:
        """Conv_k, then BatchNorm_k on its float32 sum, in self.dtype, with
        what follows it (FrozenBatchNorm.forward's relu, residual and
        out_dtype): one kernel where layers.takes_conv1x1_bn holds."""
        return layers.conv_bn(getattr(self, f"Conv_{k}"),
                              getattr(self, f"BatchNorm_{k}"), x,
                              self.dtype, **epilogue)

    def _fused(self, k: int, x: torch.Tensor) -> bool:
        return layers.takes_conv1x1_bn(getattr(self, f"Conv_{k}"), x,
                                       self.dtype)

    def _conv_input(self, x: torch.Tensor, *ks: int) -> torch.Tensor:
        """The block input as its convolutions Conv_k, k in ks, read it:
        widened to float32 once, for all of them, where no gradient is
        recorded and none takes the fused 1x1 kernel (which reads bf16).
        Otherwise as it is: each convolution through conv_f32 widens its
        own copy, so that with a gradient the gradients meet in the
        compute dtype as they always have."""
        if torch.is_grad_enabled() or any(self._fused(k, x) for k in ks):
            return x
        return x.float()


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        pd = param_dtype or dtype
        self.dtype = dtype
        self.Conv_0 = _conv(cin, filters, 3, stride, 1, device, pd)
        self.BatchNorm_0 = layers.FrozenBatchNorm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, 1, 1, device, pd)
        self.BatchNorm_1 = layers.FrozenBatchNorm(filters, device=device)
        self.down = cin != filters or stride != 1
        if self.down:
            self.Conv_2 = _conv(cin, filters, 1, stride, 0, device, pd)
            self.BatchNorm_2 = layers.FrozenBatchNorm(filters, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xin = self._conv_input(x, 0, *((2,) if self.down else ()))
        y = self._conv_bn(0, xin, relu=True, out_dtype=torch.float32)
        r = self._conv_bn(2, xin) if self.down else x
        return self._conv_bn(1, y, relu=True, residual=r)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        pd = param_dtype or dtype
        self.dtype = dtype
        out = filters * 4
        self.Conv_0 = _conv(cin, filters, 1, 1, 0, device, pd)
        self.BatchNorm_0 = layers.FrozenBatchNorm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, stride, 1, device, pd)
        self.BatchNorm_1 = layers.FrozenBatchNorm(filters, device=device)
        self.Conv_2 = _conv(filters, out, 1, 1, 0, device, pd)
        self.BatchNorm_2 = layers.FrozenBatchNorm(out, device=device)
        self.down = cin != out or stride != 1
        if self.down:
            self.Conv_3 = _conv(cin, out, 1, stride, 0, device, pd)
            self.BatchNorm_3 = layers.FrozenBatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xin = self._conv_input(x, 0, *((3,) if self.down else ()))
        y = self._conv_bn(0, xin, relu=True, out_dtype=torch.float32)
        # Conv_2 reads bf16 where it is fused, float32 otherwise
        y = self._conv_bn(1, y, relu=True, out_dtype=None if self._fused(
            2, y) else torch.float32)
        r = self._conv_bn(3, xin) if self.down else x
        return self._conv_bn(2, y, relu=True, residual=r)


class _BackwardSpans:
    """The spans features.stageN.backward of one traced forward's
    backward, opened and closed by autograd hooks in the order autograd
    runs the stages (the last stage first), so at most one is open.

    A stage's span opens when its output's gradient is whole (a hook on
    the output, which fires before the stage's first backward node), and
    the span of the stage above closes there too, since its backward ends
    in that gradient. The lowest training stage's span closes where its
    input's gradient is whole, or, where its input carries no gradient
    (the stage above a frozen one, whose output is detached), once
    autograd has computed the gradient of each of the stage's parameters:
    the last of them comes from its first convolution, the last node of
    its backward. That hook sits on the parameters themselves, which keep
    it from one backward to the next, so it removes itself when it fires,
    and a forward whose backward never ran has it removed by `remove`."""

    def __init__(self):
        self.open = None
        self.handle = None

    def _turn(self, name):
        def hook(grad):
            if self.open is not None:
                self.open.__exit__(None, None, None)
            self.open = None if name is None else profiling.span(name)
            if self.open is not None:
                self.open.__enter__()
        return hook

    def stage(self, name: str, x_in: torch.Tensor, x_out: torch.Tensor,
              params: list, lowest: bool) -> None:
        """Hooks stage `name`'s span between x_out's gradient and, for the
        lowest training stage, x_in's or its parameters' gradients."""
        if not x_out.requires_grad:
            return
        if lowest and x_in.requires_grad:
            x_in.register_hook(self._turn(None))
        elif lowest:
            close = self._turn(None)

            def closed(grads):
                self.remove()
                close(None)
            self.handle = torch.autograd.graph.register_multi_grad_hook(
                params, closed)
        x_out.register_hook(self._turn(name + ".backward"))

    def remove(self) -> None:
        if self.handle is not None:
            self.handle.remove()
            self.handle = None


class StageGraphs:
    """CUDA graphs of a ResNet trunk's training stages. Inside `step()`
    each stage whose parameters take gradients runs, under grad mode, as
    one graph of its forward and one of its backward
    (torch.cuda.make_graphed_callables), captured at its first call for
    the input's shape, dtype and requires_grad and cuDNN's settings
    (deterministic, benchmark, allow_tf32): a setting changed between
    steps captures anew, so a replay runs what an eager call would. Under
    a gradient every convolution runs in plain ops (conv_f32) and every
    BatchNorm as an autograd Function (ops/batchnorm.BNEpilogue: kernel
    N forward, a kernel backward), thousands of launches a ResNet-101
    training step, which leave it at the host's pace; a replay runs the
    same kernels on the same inputs (bit for bit under
    cudnn.deterministic) and no Python of the blocks, so it counts no
    bn.passes.

    What a graph asks of the step, which train/loop.make_train_step
    keeps (one forward, then its backward):
    - a stage runs once in a step, and its backward runs before the step
      ends: a replay's outputs and saved activations are the graph's
      buffers, which its next replay writes over. A second forward of a
      stage in one step raises.
    - the parameters keep their storage (the optimizer and
      load_state_dict write in place): a stage whose parameters moved to
      other storage has its captures dropped and captured anew.
    A stage holds at most LIMIT captures, each with a memory pool of its
    own; beyond them it runs eagerly."""

    LIMIT = 4

    def __init__(self, trunk: "ResNet"):
        self.trunk = trunk
        self.captures = {}    # stage index -> {key: graphed callable}
        self.storage = {}     # stage index -> its parameters' data_ptrs
        self.ran = None       # the stages run in the open step

    @contextlib.contextmanager
    def step(self):
        """One forward of the trunk and its backward run as graphs."""
        self.trunk._graphs, self.ran = self, set()
        try:
            yield
        finally:
            self.trunk._graphs, self.ran = None, None

    def __call__(self, si: int, blocks: list, x: torch.Tensor):
        """Stage si's output from its graph; None where it runs eagerly
        (no gradient recorded, a frozen stage, or LIMIT captures)."""
        params = [p for b in blocks for p in b.parameters()]
        if not torch.is_grad_enabled() or not any(p.requires_grad
                                                  for p in params):
            return None
        if si in self.ran:
            raise RuntimeError(
                f"stage {si + 2} of a graphed trunk ran twice in one step: "
                f"the second forward would overwrite the first's buffers "
                f"before its backward")
        self.ran.add(si)
        ptrs = tuple(p.data_ptr() for p in params)
        if self.storage.get(si) != ptrs:
            self.captures[si], self.storage[si] = {}, ptrs
        cudnn = torch.backends.cudnn
        key = (tuple(x.shape), x.dtype, x.requires_grad, cudnn.deterministic,
               cudnn.benchmark, cudnn.allow_tf32)
        stage = self.captures[si]
        if key not in stage:
            if len(stage) >= self.LIMIT:
                return None
            sample = x.detach().clone().requires_grad_(x.requires_grad)
            stage[key] = torch.cuda.make_graphed_callables(
                nn.Sequential(*blocks), (sample,))
        return stage[key](x)


class ResNet(nn.Module):
    feature_strides = {"c3": 4, "c4": 8, "c5": 16}

    def __init__(self, stage_sizes=(2, 2, 2), block=BasicBlock,
                 dtype=torch.bfloat16, device=None, freeze_stages: int = 0,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.freeze_stages = freeze_stages
        self.stage_sizes = tuple(stage_sizes)
        self._backward_spans = None   # the last traced forward's
        self._graphs = None           # the StageGraphs of an open step
        self.stem = _conv(3, 64, 7, 2, 3, device, param_dtype or dtype)
        self.stem_bn = layers.FrozenBatchNorm(64, device=device)
        cin, filters = 64, 64
        self.feature_channels = {}
        for si, n_blocks in enumerate(self.stage_sizes):
            for bi in range(n_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                self.add_module(f"stage{si + 2}_block{bi}", block(
                    cin, filters, stride, dtype=dtype, device=device,
                    param_dtype=param_dtype))
                cin = filters * block.expansion
            self.feature_channels[f"c{si + 3}"] = cin
            filters *= 2

    @staticmethod
    def frozen_prefixes(n_stages: int) -> tuple:
        """Parameter-name prefixes of the first n stages: stage 1 is the
        stem conv and its BN, stages 2..4 the residual groups."""
        out = []
        if n_stages >= 1:
            out += ["stem", "stem_bn"]
        for s in range(2, min(n_stages, 4) + 1):
            out.append(f"stage{s}_")
        return tuple(out)

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, H, W, 3) normalized float -> {"c3","c4","c5"} NHWC maps."""
        with profiling.span("features.stem"):
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            x = x.contiguous(memory_format=torch.channels_last)
            x = self.stem_bn(layers.conv_f32(self.stem, x, self.dtype),
                             self.dtype, relu=True)
            x = F.max_pool2d(x, 3, 2, padding=1)  # -inf padding, /4
        if self.freeze_stages >= 1:
            x = x.detach()
        back = None
        if profiling.tracing_on() and torch.is_grad_enabled():
            if self._backward_spans is not None:
                self._backward_spans.remove()
            back = self._backward_spans = _BackwardSpans()
        feats = {}
        for si, n_blocks in enumerate(self.stage_sizes):
            name = f"features.stage{si + 2}"
            x_in = x
            blocks = [getattr(self, f"stage{si + 2}_block{bi}")
                      for bi in range(n_blocks)]
            with profiling.span(name):
                y = (None if self._graphs is None
                     else self._graphs(si, blocks, x))
                if y is None:
                    for block in blocks:
                        x = block(x)
                else:
                    x = y
            if back is not None:
                back.stage(name, x_in, x, [p for b in blocks
                                           for p in b.parameters()
                                           if p.requires_grad],
                           lowest=si + 2 == max(self.freeze_stages + 1, 2))
            if si + 2 <= self.freeze_stages:
                x = x.detach()
            feats[f"c{si + 3}"] = x.permute(0, 2, 3, 1)
        return feats


def ResNet18(dtype=torch.bfloat16, device=None, freeze_stages=0,
             param_dtype=None):
    return ResNet((2, 2, 2), BasicBlock, dtype, device, freeze_stages,
                  param_dtype)


def ResNet50(dtype=torch.bfloat16, device=None, freeze_stages=0,
             param_dtype=None):
    return ResNet((3, 4, 6), BottleneckBlock, dtype, device, freeze_stages,
                  param_dtype)


def ResNet101(dtype=torch.bfloat16, device=None, freeze_stages=0,
              param_dtype=None):
    # torchvision resnet101's layer1-3; layer4 (/32) is past the trunk
    return ResNet((3, 4, 23), BottleneckBlock, dtype, device, freeze_stages,
                  param_dtype)
