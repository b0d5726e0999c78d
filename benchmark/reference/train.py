"""Plain reference of MultiPath VGG-16 fine-tuning, in float32 PyTorch.

One step, as the configuration describes it (MultiPath §3.3 and §4, Fast
R-CNN §2.3): each image flipped horizontally within its valid width with
probability hflip_prob, resized onto the canvas, its proposals and ground
truth flipped and scaled with it; per image the ground truth joins the
proposals, every box is matched to its best-IoU ground truth, and
rois_per_image are drawn without replacement, fg_fraction of them from the
boxes at IoU >= fg_iou_threshold and the rest from bg_iou_range, each pool
ranked by uniform noise; the model's forward in train mode (the detector
of benchmark/reference/multipath.py in float32, the trunk cut off from the
gradient after freeze_backbone_stages blocks, dropout 0.5 after each fc6
and fc7 ReLU); the integral loss, the mean over the K classifier heads of
each head's cross-entropy against the matched class where the ROI's IoU
reaches the head's threshold (else background), plus smooth-L1 box
regression on the foreground ROIs, both over the count of valid ROIs;
then SGD with momentum and weight decay (decay added to the gradient
before the momentum) at the warmup schedule's rate, counted from the
configuration's start_step, over every parameter of the unfrozen part.

The random draws are inputs: a torch.Generator seeded as the step's is
gives, in order, the flips (B uniforms), the sampling noise (B, 2, P + G)
and one (rows, fc_dim) mask draw after each fc6 and fc7 of each view, so
both sides see the same numbers. `Precision(fp8=True)` rounds the forward's
convolution and GEMM operands to scaled e4m3 (the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import multipath as ref
from benchmark.reference.nms import iou


def _fp8(x, prec):
    """The forward in fp8, the gradient passed through unchanged."""
    return x + (ref.fp8(x) - x).detach() if prec.fp8 else x


def hflip_images(images, widths, flip):
    """Each flipped image mirrored within its valid width, left-aligned."""
    w0 = images.shape[2]
    out = []
    for img, w, f in zip(images, widths.tolist(), flip.tolist()):
        out.append(torch.roll(torch.flip(img, (1,)), int(w - w0), 1)
                   if f else img)
    return torch.stack(out)


def hflip_boxes(boxes, widths):
    return torch.stack([widths - boxes[..., 2], boxes[..., 1],
                        widths - boxes[..., 0], boxes[..., 3]], -1)


def encode(rois, gt, means, stds):
    def center(b):
        wh = b[..., 2:] - b[..., :2]
        return b[..., :2] + 0.5 * wh, wh

    rc, rwh = center(rois)
    gc, gwh = center(gt)
    rwh = torch.clamp(rwh, min=1e-8)
    t = torch.cat([(gc - rc) / rwh,
                   torch.log(torch.clamp(gwh, min=1e-8) / rwh)], -1)
    return (t - torch.tensor(means, device=t.device)) / torch.tensor(
        stds, device=t.device)


def _pick(noise, pool, k):
    """Up to k candidates of `pool`, best noise first (ties to the lower
    index) -> (indices, taken)."""
    s = torch.where(pool, noise, torch.full_like(noise, -1.0))
    kk = min(k, s.shape[-1])
    idx = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :kk]
    got = torch.gather(pool, -1, idx)
    if kk < k:
        idx = F.pad(idx, (0, k - kk))
        got = F.pad(got, (0, k - kk))
    return idx, got


def sample(noise, props, pmask, gt, gcls, gmask, data, model):
    """-> dict rois (B, S, 4), cls, iou, targets, fg, valid."""
    pool = torch.cat([props, gt], 1)
    pool_mask = torch.cat([pmask, gmask], 1)
    ov = torch.where(gmask[:, None, :], iou(pool, gt),
                     torch.full((1,), -1.0, device=gt.device))
    best, arg = ov.max(-1).values, ov.argmax(-1)
    cls = torch.gather(gcls, 1, arg)
    box = torch.gather(gt, 1, arg[..., None].expand(*arg.shape, 4))
    fg_pool = (best >= data["fg_iou_threshold"]) & pool_mask
    lo, hi = data["bg_iou_range"]
    bg_pool = (best >= lo) & (best < hi) & pool_mask
    n_fg = int(round(data["rois_per_image"] * data["fg_fraction"]))
    n_bg = data["rois_per_image"] - n_fg
    fi, fg = _pick(noise[:, 0], fg_pool, n_fg)
    bi, bg = _pick(noise[:, 1], bg_pool, n_bg)
    idx = torch.cat([fi, bi], 1)
    valid = torch.cat([fg, bg], 1)
    is_fg = torch.cat([torch.ones_like(fg), torch.zeros_like(bg)], 1) & valid

    def take(x):
        if x.dim() == 2:
            return torch.gather(x, 1, idx)
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape, 4))

    rois = take(pool)
    t = encode(rois, take(box), model["bbox_reg_means"],
               model["bbox_reg_stds"])
    return {"rois": rois, "cls": torch.where(is_fg, take(cls),
                                             torch.zeros_like(idx)),
            "iou": take(best), "targets": torch.where(is_fg[..., None], t,
                                                      torch.zeros_like(t)),
            "fg": is_fg, "valid": valid}


def trunk(params, x, levels, frozen, prec):
    """The trunk with blocks 1..frozen cut off from the gradient."""
    x = x.permute(0, 3, 1, 2)
    taps = {}
    for blk, (_, n) in enumerate(ref.VGG16, start=1):
        for c in range(1, n + 1):
            name = f"backbone.conv{blk}_{c}"
            x = F.relu(F.conv2d(_fp8(x, prec), _fp8(params[name + ".weight"],
                                                    prec), None, padding=1)
                       + params[name + ".bias"][:, None, None])
        if blk <= frozen:
            x = x.detach()
        if blk >= 3:
            taps[f"c{blk}"] = x
        if blk < 5:
            x = F.max_pool2d(x, 2, 2)
    return {lv: _fp8(F.conv2d(_fp8(taps[lv], prec),
                              _fp8(params[f"reduce_{lv}.weight"], prec)),
                     prec).permute(0, 2, 3, 1) for lv in levels}


def head(params, model, pooled, masks, prec, rate: float = 0.5):
    """Float head in train mode; masks yields the dropout draws."""
    b, f, r = pooled.shape[:3]
    n = b * r
    x = F.relu(pooled.reshape(b, f, r, -1)
               + params["head.skip_bias"].repeat(
                   pooled.shape[3] * pooled.shape[4]))
    keep = 1.0 - rate
    branches = []
    for v in range(f):
        h = x[:, v].reshape(n, -1)
        for fc in (f"head.fc6_f{v}", f"head.fc7_f{v}"):
            h = F.relu(F.linear(_fp8(h, prec), _fp8(params[fc + ".weight"],
                                                    prec),
                                params[fc + ".bias"]))
            h = torch.where(next(masks) < keep, h / keep,
                            torch.zeros_like(h))
        branches.append(h)
    out = F.linear(_fp8(torch.cat(branches, -1), prec),
                   _fp8(params["head.cls_bbox.weight"], prec),
                   params["head.cls_bbox.bias"])
    k, ncls = len(model["integral_thresholds"]), model["num_classes"]
    return (out[:, :k * ncls].reshape(b, r, k, ncls),
            out[:, k * ncls:].reshape(b, r, -1))


def loss(scores, deltas, s, model):
    b, r, k, ncls = scores.shape
    thr = torch.tensor(model["integral_thresholds"], device=scores.device)
    fg_k = s["fg"][..., None] & (s["iou"][..., None] >= thr)
    labels = torch.where(fg_k, s["cls"][..., None],
                         torch.zeros_like(s["cls"][..., None]))
    valid = s["valid"].float()
    n_valid = torch.clamp(valid.sum(), min=1.0)
    ce = -torch.gather(torch.log_softmax(scores, -1), -1,
                       labels[..., None].long())[..., 0]
    ce = (ce * valid[..., None]).sum((0, 1)) / n_valid
    cls_loss = ce.sum() if model["integral_loss_agg"] == "sum" else ce.mean()
    d = deltas.reshape(b, r, ncls, 4)
    d = torch.gather(d, 2, s["cls"].long()[..., None, None].expand(
        b, r, 1, 4))[:, :, 0]
    x = (d - s["targets"]).abs()
    reg = torch.where(x < 1.0, 0.5 * x * x, x - 0.5).sum(-1)
    fg = (s["fg"] & s["valid"]).float()
    return cls_loss + (reg * fg).sum() / n_valid


def lr_at(train: dict, step: int) -> float:
    """The warmup-then-step-decay rate of optimizer step `step` (from 0)."""
    def decay(s):
        v = train["lr"]
        for boundary in sorted(train["lr_decay_steps"]):
            if s >= boundary:
                v *= train["lr_decay_factor"]
        return v

    w = train["warmup_steps"]
    if w <= 0:
        return decay(step)
    return decay(step - w) if step >= w else train["lr"] * step / w


class Reference:
    """The training reference over a float32 copy of the checkpoint; step()
    takes one host batch and returns its loss."""

    def __init__(self, sd: dict, config: dict, canvas: int, seed: int,
                 device, prec=ref.Precision(head_bits=0)):
        ref.exact_float32()
        self.model, self.data = config["model"], config["data"]
        self.train = config["train"]
        self.canvas, self.prec, self.device = canvas, prec, device
        frozen = tuple(f"backbone.conv{b}_" for b in range(
            1, self.train["freeze_backbone_stages"] + 1))
        self.params = {k: v.detach().clone().float() for k, v in sd.items()}
        self.start = {k: v.clone() for k, v in self.params.items()}
        self.trainable = [k for k in self.params
                          if not k.startswith(frozen)]
        for k in self.trainable:
            self.params[k].requires_grad_(True)
        self.momentum = {}
        self.count = config["start_step"]
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def forward_loss(self, batch, keep_images=None):
        images, hws, props, pmask, gt, gcls, gmask = [
            torch.as_tensor(x, device=self.device) for x in batch]
        b = images.shape[0]
        dev, gen = self.device, self.gen
        flip = torch.rand(b, generator=gen, device=dev) < self.data[
            "hflip_prob"]
        w = hws[:, 1]
        images = hflip_images(images, w, flip)
        props = torch.where(flip[:, None, None],
                            hflip_boxes(props, w[:, None]), props)
        gt = torch.where(flip[:, None, None], hflip_boxes(gt, w[:, None]), gt)
        x, scale = ref.canvases(images, hws, self.canvas)
        props = props * scale[:, None, None]
        gt = gt * scale[:, None, None]
        noise = torch.rand((b, 2, props.shape[1] + gt.shape[1]),
                           generator=gen, device=dev)
        s = sample(noise, props, pmask, gt, gcls.long(), gmask, self.data,
                   self.model)
        maps = trunk(self.params, x, self.model["skip_levels"],
                     self.train["freeze_backbone_stages"], self.prec)
        pooled = ref.pool(self.model, maps, s["rois"], self.canvas)
        rows = b * s["rois"].shape[1]
        masks = (torch.rand((rows, self.model["fc_dim"]), generator=gen,
                            device=dev)
                 for _ in range(2 * len(self.model["foveal_scales"])))
        scores, deltas = head(self.params, self.model, pooled, masks,
                              self.prec)
        if keep_images is not None:   # a fault: part of the batch
            scores, deltas = scores[keep_images], deltas[keep_images]
            s = {k: v[keep_images] for k, v in s.items()}
        return loss(scores, deltas, s, self.model)

    def step(self, batch, keep_images=None) -> float:
        total = self.forward_loss(batch, keep_images)
        grads = torch.autograd.grad(total, [self.params[k]
                                            for k in self.trainable])
        lr = lr_at(self.train, self.count)
        wd, mu = self.train["weight_decay"], self.train["momentum"]
        with torch.no_grad():
            for k, g in zip(self.trainable, grads):
                p = self.params[k]
                d = g + wd * p
                buf = self.momentum.get(k)
                buf = d.clone() if buf is None else buf.mul_(mu).add_(d)
                self.momentum[k] = buf
                p.sub_(lr * buf)
        self.count += 1
        return float(total.detach())

    def first_grads(self) -> dict:
        """The gradient of step 1 as the optimizer state holds it: the
        momentum less the weight decay of the starting parameters."""
        return {k: self.momentum[k] - self.train["weight_decay"]
                * self.start[k] for k in self.trainable}
