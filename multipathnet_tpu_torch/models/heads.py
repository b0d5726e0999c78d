"""Detection head — port of multipathnet_tpu/models/heads.py:
MultiPathHead and Int8Dense (here Int8Linear).

Input is the level-summed, pre-reduced pooled tensor (B, F, R, G, G, C),
channel-last. The head adds the shared skip bias + ReLU that completes the
per-level 1x1 reduction (MultiPathNet.features), runs one fc6 -> fc7 branch
per foveal view, and ONE fused GEMM for the K integral classifiers and the
bbox regressor. fc6 reads each view's (G, G, C) block flattened channel-
last, exactly as the reference, so imported weights line up (models/
convert.py keeps that row order). The float GEMMs are F.linear (cuBLAS on
the card); the reference left them to XLA. Parameters are stored in
`param_dtype` and computed in `dtype` (models/layers.py). In train mode
each fc6 and fc7 ReLU is followed by dropout with flax's semantics: keep
with probability 1 - rate, scale kept values by 1 / (1 - rate), the mask
drawn from an explicit generator.

Serving forms (inference only, weights from a load-time transform of a
float checkpoint, eval/detect.serving_params):
  quant="int8": every GEMM is an Int8Linear (ops/quant.py). The pooled
      tensor is quantized once per (ROI, view) row, or arrives already
      quantized from the pool kernels with its scales (`pooled_scale`).
      Each layer's input quantize and its epilogue (rescale, bias, the
      cast, the ReLU) are one kernel each on the card
      (ops/quant.quantize_rows_padded, int8_epilogue); each view's fc7
      output lands in its column slice of the classifier's input.
  fc6_rank/fc7_rank = t > 0: that FC family is a bias-free (in -> t)
      factor `{name}_u` followed by the (t -> fc_dim) layer `{name}` that
      keeps the bias, with no ReLU between (ops/lowrank.py).

Tensor parallelism (`shard_head_`, the reference's layout in
core/mesh.MeshRules): each rank of the model axis keeps its columns of a
column-parallel layer and its input rows of a row-parallel one, in every
layout above. A column-parallel layer reads the whole input (its gradient
all-reduced over the model axis) and writes its columns; a row-parallel
layer reads its columns and its float32 partial products are all-reduced,
rounded to the compute dtype once, and the bias added after, as
models/layers.py adds it; an int8 row-parallel layer quantizes its columns
with each row's largest magnitude over all of them (an all-reduce of the
maxima) and sums the int32 partials exactly, so it equals the unsharded
layer bit for bit. Wherever a layer needs the whole input and holds a
part, the parts are all-gathered (cls_bbox's output among them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.core import mesh as mesh_lib
from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.ops import quant

_INT8_BUFFERS = ("weight_i8", "weight_scale", "bias")


class Int8Linear(nn.Module):
    """The counterpart of the reference's Int8Dense: a per-output-channel
    int8 weight, dynamic per-row int8 activations, the int32 GEMM, the
    float32 rescale and bias, the result in `dtype`.

    Buffers, not parameters (int8 tensors cannot be Parameters): weight_i8
    (N, K) int8 (torch's (out, in) order; models/convert.py maps it to the
    reference's kernel_i8 (K, N)), weight_scale (N,) float32, bias (N,)
    float32. N and K are padded to multiples of 8 in memory, once, because
    torch._int_mm takes no other widths; the padding is zero weights (rows
    and columns), unit scales and zero bias, the input gets zero codes in
    the pad columns (exact: they add nothing to the int32 sums), and every
    state-dict round trip drops it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        n_pad = -(-out_features // 8) * 8
        k_pad = -(-in_features // 8) * 8
        self.register_buffer("weight_i8", torch.zeros(
            (n_pad, k_pad), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            n_pad, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            n_pad, dtype=torch.float32, device=device) if bias else None)

    def _logical(self, name) -> tuple:
        """The unpadded shape of buffer `name`."""
        return ((self.out_features, self.in_features) if name == "weight_i8"
                else (self.out_features,))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in _INT8_BUFFERS:
            if prefix + name in destination:
                destination[prefix + name] = destination[prefix + name][
                    tuple(slice(0, n) for n in self._logical(name))]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in _INT8_BUFFERS:
            key, own = prefix + name, getattr(self, name)
            t = state_dict.get(key)
            if (own is not None and t is not None
                    and tuple(t.shape) == self._logical(name) != own.shape):
                padded = own.detach().to(t.device, t.dtype, copy=True)
                padded[tuple(slice(0, n) for n in t.shape)] = t
                state_dict[key] = padded
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, x_scale: torch.Tensor | None = None,
                relu: bool = False, out: torch.Tensor | None = None):
        """x float (quantized here per row), or int8 with its (M, 1) float32
        row scales -> (M, out_features) in `dtype`, ReLU'd if `relu`,
        written into `out` when given (see rescale)."""
        if x_scale is None:
            x, x_scale = quant.quantize_rows_padded(x, self.weight_i8.shape[1])
        return self.rescale(self.accumulate(x), x_scale, relu, out)

    def accumulate(self, x_i8: torch.Tensor) -> torch.Tensor:
        """(M, in_features) int8 codes, or codes already padded to the
        weight's K -> the (M, N padded) int32 products."""
        k_pad = self.weight_i8.shape[1]
        if x_i8.shape[-1] != k_pad:
            x_i8 = F.pad(x_i8, (0, k_pad - x_i8.shape[-1]))
        return quant.int_mm(x_i8, self.weight_i8)

    def rescale(self, acc: torch.Tensor, x_scale: torch.Tensor,
                relu: bool = False, out: torch.Tensor | None = None):
        """The int32 products and the (M, 1) row scales -> the output in
        `dtype` without the padding, ReLU'd if `relu`
        (ops/quant.int8_epilogue), into `out` (M, out_features) when given:
        a view with any row stride, such as a column slice of a wider
        buffer."""
        return quant.int8_epilogue(acc, x_scale, self.weight_scale,
                                   self.bias, width=self.out_features,
                                   dtype=self.dtype, relu=relu, out=out)

    def logical_state(self) -> dict:
        """The buffers without their padding, by name."""
        return {name: getattr(self, name)[tuple(
            slice(0, n) for n in self._logical(name))]
            for name in _INT8_BUFFERS if getattr(self, name) is not None}


class MultiPathHead(nn.Module):
    dropout_rate = 0.5  # the reference's; tests set 0 on an instance

    def __init__(self, num_classes: int, foveal_scales=(1.0, 1.5, 2.0, 4.0),
                 num_integral_heads: int = 6, fc_dim: int = 4096,
                 skip_reduce_dim: int = 512, roi_output_size: int = 7,
                 class_specific_bbox: bool = True, dtype=torch.bfloat16,
                 device=None, param_dtype=None, quant: str = "none",
                 fc6_rank: int = 0, fc7_rank: int = 0):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        g, c = roi_output_size, skip_reduce_dim
        if not 0 <= fc6_rank <= min(g * g * c, fc_dim):
            raise ValueError(f"fc6_rank={fc6_rank} exceeds full rank "
                             f"{min(g * g * c, fc_dim)}")
        if not 0 <= fc7_rank <= fc_dim:
            raise ValueError(f"fc7_rank={fc7_rank} exceeds full rank {fc_dim}")
        self.num_classes = num_classes
        self.num_views = len(foveal_scales)
        self.num_integral_heads = num_integral_heads
        self.skip_reduce_dim = skip_reduce_dim
        self.dtype = dtype
        self.quant = quant
        self.serving_only = quant != "none" or bool(fc6_rank or fc7_rank)
        kw = dict(device=device, dtype=param_dtype or dtype)

        def dense(name, k, n, bias=True):
            self.add_module(name, Int8Linear(k, n, bias, dtype, device)
                            if quant == "int8" else nn.Linear(k, n, bias, **kw))

        def fc(name, k, rank):
            if rank:
                dense(f"{name}_u", k, rank, bias=False)
                k = rank
            dense(name, k, fc_dim)

        self.skip_bias = nn.Parameter(torch.zeros(c, **kw))
        for i in range(self.num_views):
            fc(f"fc6_f{i}", g * g * c, fc6_rank)
            fc(f"fc7_f{i}", fc_dim, fc7_rank)
        self.cls_dim = num_integral_heads * num_classes
        bbox_dim = 4 * num_classes if class_specific_bbox else 4
        dense("cls_bbox", self.num_views * fc_dim, self.cls_dim + bbox_dim)
        self.mesh = None      # set by shard_head_
        self.tp_roles = {}    # sharded layer -> "col" | "row"

    def _dropout(self, h, train: bool, generator, shard=None,
                 local: bool = False):
        """Dropout of h (n, d), its mask drawn at the global shape: the
        whole batch (`shard` (index, count): h holds rows part `index` of
        `count`) and, when h holds this rank's columns (`local`), every
        column; this rank's part of it is kept. One process draws h.shape."""
        if not train or self.dropout_rate == 0.0:
            return h
        keep = 1.0 - self.dropout_rate
        index, count = shard or (0, 1)
        n, d = h.shape
        n_model = self.mesh.n_model if local else 1
        mask = torch.rand((n * count, d * n_model), generator=generator,
                          device=h.device)[index * n:(index + 1) * n]
        if local:
            mask = mask[:, self.mesh.cols(d * n_model)]
        mask = mask < keep
        return torch.where(mask, h / keep, torch.zeros_like(h))

    def _dense(self, name, x, x_scale=None, local: bool = False,
               relu: bool = False, out=None):
        """One GEMM of x (all its columns, or this rank's when `local`),
        ReLU'd if `relu` -> (output, whether it holds this rank's columns
        only). An int8 layer writes a whole output into `out` when given
        and returns it; other outputs are new tensors."""
        mod = getattr(self, name)
        role = self.tp_roles.get(name)
        group = self.mesh.model_group if self.mesh is not None else None
        if role == "row":
            if not local:  # a row's codes keep the row's scale
                x = mesh_lib.split_cols(x, group)
            return self._row_parallel(mod, x, x_scale, group, relu,
                                      out), False
        if local:
            x = mesh_lib.gather_cols(x, group)
        if role == "col":
            x = mesh_lib.copy_to_model(x, group)
        if isinstance(mod, Int8Linear):
            return mod(x, x_scale, relu, None if role == "col" else out), \
                role == "col"
        y = layers.linear(mod, x, self.dtype)
        return (F.relu(y) if relu else y), role == "col"

    def _row_parallel(self, mod, x, x_scale, group, relu: bool = False,
                      out=None):
        """A row-parallel layer on this rank's input columns: the partial
        products summed over the model axis (int32 exactly; float32 then
        rounded once to the compute dtype), then the bias."""
        if isinstance(mod, Int8Linear):
            if x_scale is None:
                x, x_scale = quant.quantize_rows_padded(
                    x, mod.weight_i8.shape[1],
                    mesh_lib.all_max(quant.row_amax(x), group))
            return mod.rescale(mesh_lib.all_sum(mod.accumulate(x), group),
                               x_scale, relu, out)
        dt = self.dtype
        part = _linear_f32(x.to(dt), mod.weight.to(dt))
        y = mesh_lib.reduce_from_model(part, group).to(dt)
        y = y if mod.bias is None else y + mod.bias.to(dt)
        return F.relu(y) if relu else y

    def _fc(self, name, x, x_scale=None, local: bool = False, out=None):
        """One FC and its ReLU: the factor then the named layer when it is
        factored (only the first GEMM takes a pre-quantized input; no ReLU
        between them), else the named layer alone. -> (output, whether it
        holds this rank's columns)."""
        if hasattr(self, f"{name}_u"):
            x, local = self._dense(f"{name}_u", x, x_scale, local)
            x_scale = None
        return self._dense(name, x, x_scale, local, relu=True, out=out)

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                pooled_scale: torch.Tensor | None = None, shard=None):
        """pooled (B, F, R, G, G, C) -> (scores (B*R, K, num_classes) f32,
        bbox_deltas (B*R, D) f32). `generator` draws the dropout masks
        (train mode only). `pooled_scale` (B, F, R, 1) float32: pooled is
        int8 from the pool kernels, skip bias, ReLU and quantization
        already applied (int8 serving only). `shard` (index, count): the
        batch is part `index` of `count` equal parts of the global batch,
        whose shape the dropout masks are drawn at.

        Each view's fc7 output goes into its column slice of one (B*R, F *
        fc_dim) buffer, the classifier's input; an int8 layer's epilogue
        writes it there itself."""
        b, f, r, g, _, c = pooled.shape
        if f != self.num_views or c != self.skip_reduce_dim:
            raise ValueError(f"pooled {tuple(pooled.shape)} does not match "
                             f"{self.num_views} views x {self.skip_reduce_dim}"
                             f" channels")
        if train and self.serving_only:
            raise ValueError(
                "the int8 and low-rank heads are inference-only; train "
                "full-rank float and transform the checkpoint at load")
        n = b * r
        dt = self.dtype
        k = g * g * c
        if pooled_scale is not None:
            if self.quant != "int8" or pooled.dtype != torch.int8:
                raise ValueError("a pre-quantized pooled input needs the int8"
                                 f" head and int8 input, got {self.quant!r} "
                                 f"and {pooled.dtype}")
            x, xs = pooled.reshape(b, f, r, k), pooled_scale
        else:
            x = F.relu(pooled.to(dt) + self.skip_bias.to(dt))
            xs = None
            if self.quant == "int8":
                # once per (ROI, view) row, padded to fc6's K, then int8
                # slices per branch
                first = (self.fc6_f0_u if hasattr(self, "fc6_f0_u")
                         else self.fc6_f0)
                x, xs = quant.quantize_rows_padded(
                    x.reshape(b * f * r, k), first.weight_i8.shape[1])
                x, xs = x.reshape(b, f, r, -1), xs.reshape(b, f, r, 1)
        group = self.mesh.model_group if self.mesh is not None else None
        d = self.fc7_f0.out_features
        fc7 = torch.empty((n, f * d), dtype=dt, device=pooled.device)
        for i in range(f):
            h, local = self._fc(f"fc6_f{i}", _view_rows(x, i),
                                None if xs is None
                                else xs[:, i].reshape(n, 1))
            h = self._dropout(h, train, generator, shard, local)
            dest = fc7[:, i * d:(i + 1) * d]
            h, local = self._fc(f"fc7_f{i}", h, local=local, out=dest)
            h = self._dropout(h, train, generator, shard, local)
            if local:
                h = mesh_lib.gather_cols(h, group)
            if h is not dest:
                dest.copy_(h)
        out, local = self._dense("cls_bbox", fc7)
        if local:
            out = mesh_lib.gather_cols(out, group)
        scores = out[:, :self.cls_dim].reshape(
            n, self.num_integral_heads, self.num_classes)
        return scores.float(), out[:, self.cls_dim:].float()


def _view_rows(x: torch.Tensor, i: int) -> torch.Tensor:
    """View i's rows of x (B, F, R, ...) as one (B * R, K) matrix: a copy
    when B > 1, since the views interleave image by image. Outside
    autograd, copied as 8-byte words where the rows allow it: on an H100
    PyTorch's copy of the int8 codes one byte an element ran at about a
    third of the rate of the same bytes as int64 words (PERF.md §6)."""
    b, f, r = x.shape[:3]
    rows = x.reshape(b, f, r, -1)
    size = rows.element_size()
    if (not rows.requires_grad and rows.is_contiguous()
            and rows.shape[-1] * size % 8 == 0
            and rows.storage_offset() * size % 8 == 0):
        return rows.view(torch.int64)[:, i].reshape(b * r, -1).view(x.dtype)
    return rows[:, i].reshape(b * r, -1)


def _linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T of operands already rounded to the compute dtype, the sum in
    float32 (a row-parallel layer's partial product). On the card with a
    bf16 or float16 compute dtype the float32 GEMM runs with TF32
    allowed, as models/layers.conv_f32 runs its convolution: the operands
    are exact in TF32 and the tensor cores sum in float32."""
    exact_tf32 = x.is_cuda and x.dtype != torch.float32
    x, w = x.float(), w.float()
    if not exact_tf32:
        return F.linear(x, w)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return F.linear(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _shard_dense(mod, col: bool, mesh):
    """This rank's part of a dense layer: the output columns (`col`) or
    the input rows of its (in, out) kernel, as a new layer of the same
    kind; a row-parallel layer keeps the whole bias (and int8 scale)."""
    k, n = mod.in_features, mod.out_features
    part = mesh.cols(n if col else k)
    width = part.stop - part.start
    if isinstance(mod, Int8Linear):
        st = mod.logical_state()
        new = Int8Linear(k if col else width, width if col else n,
                         mod.bias is not None, mod.dtype,
                         mod.weight_i8.device)
        sd = {name: (t[part] if col else t) for name, t in st.items()}
        if not col:
            sd["weight_i8"] = st["weight_i8"][:, part]
        new.load_state_dict({name: t.clone() for name, t in sd.items()})
        return new
    w = mod.weight
    new = nn.Linear(k if col else width, width if col else n,
                    mod.bias is not None, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        new.weight.copy_(w[part] if col else w[:, part])
        if mod.bias is not None:
            new.bias.copy_(mod.bias[part] if col else mod.bias)
    for p_new, p_old in zip(new.parameters(), mod.parameters()):
        p_new.requires_grad_(p_old.requires_grad)
    return new


def shard_head_(head: MultiPathHead, mesh) -> MultiPathHead:
    """Shards the head over the mesh's model axis in place: each layer the
    reference's rules shard (core/mesh.MeshRules.head_layout) is replaced
    by this rank's part of its current weights; the rest stay whole. On a
    model axis of 1 only the mesh is recorded. A head already on this mesh
    (a Trainer's, handed to a Detector or Tester with the trainer's mesh)
    is left as it is; a head sharded over another mesh raises."""
    if head.mesh is mesh:
        return head
    if head.mesh is not None and (head.tp_roles or mesh.n_model > 1):
        raise ValueError("the head is already on another mesh; build the "
                         "model anew to shard it over this one")
    head.mesh = mesh
    if mesh.n_model == 1:
        return head
    rules = mesh_lib.MeshRules(mesh.n_model)
    u_names = {name for name, _ in head.named_children()
               if name.endswith("_u")}
    for name, mod in list(head.named_children()):
        if not isinstance(mod, (nn.Linear, Int8Linear)):
            continue
        axis = rules.head_layout(f"{name}/kernel",
                                 (mod.in_features, mod.out_features),
                                 u_names)
        if axis is None:
            continue
        head.tp_roles[name] = "col" if axis == 1 else "row"
        setattr(head, name, _shard_dense(mod, axis == 1, head.mesh))
    return head


def tp_dims(head: MultiPathHead) -> dict:
    """{name in head.state_dict(): the dimension the model axis shards}
    for every sharded tensor (torch's (out, in) weights: a column-parallel
    layer's dim 0 and its bias and scale, a row-parallel layer's dim 1)."""
    out = {}
    for layer, role in head.tp_roles.items():
        w = "weight_i8" if isinstance(getattr(head, layer),
                                      Int8Linear) else "weight"
        out[f"{layer}.{w}"] = 0 if role == "col" else 1
        if role == "col":
            for vec in ("bias", "weight_scale"):
                if getattr(getattr(head, layer), vec, None) is not None:
                    out[f"{layer}.{vec}"] = 0
    return out
