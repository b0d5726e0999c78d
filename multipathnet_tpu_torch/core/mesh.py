"""The (data x model) grid of ranks, the launchers that start ranks, and
the collectives of the sharded heads — port of multipathnet_tpu/core/mesh.py.

The reference runs one SPMD program over a named device mesh and lets XLA
insert the collectives. Here each rank is a process: `torch.distributed`
holds the process groups, `make_mesh` arranges the ranks in a grid through
`torch.distributed.device_mesh.DeviceMesh` with the dimension names
("data", "model"), and the collectives are explicit calls. Ranks on the
CPU use gloo; ranks on the card use NCCL with one card each, or gloo where
they share a card (NCCL refuses two ranks on one card, and `spawn` and
`init_from_env` raise before it is tried). Under gloo a CUDA tensor is
staged through the host, and only all_reduce, all_gather and broadcast
take one, so those are the only collectives used.

Data parallelism: every rank holds the whole model and its rows of the
batch; the trainable gradients are summed over the data group by one
flat all-reduce in a fixed order (`all_sum_grads_`). Tensor parallelism is
the reference's Megatron layout of the detection head (`MeshRules`,
models/heads.shard_head_): fc6 and cls_bbox column-parallel, fc7
row-parallel, a truncated-SVD pair split over its rank, with the pair of
autograd functions around each sharded layer (`copy_to_model`,
`reduce_from_model`) and a column gather (`gather_cols`). The conv trunk
stays replicated, as in the reference.

A mesh narrower than the world leaves the ranks past its width out of
every group: `make_mesh` returns None there, as the reference leaves spare
devices idle.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from collections.abc import Sequence
from dataclasses import dataclass

import torch
import torch.distributed as dist

from multipathnet_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# elements per all-reduce of the flat gradient (1 GiB of float32)
_GRAD_BUCKET = 1 << 28


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's place in a (data x model) grid: the grid's shape, the
    rank's coordinate and device, the DeviceMesh, and the process groups
    of its data column, its model row and the whole grid (None on a
    single-process mesh, where every collective is the identity)."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    device: torch.device
    device_mesh: object = None
    data_group: object = None
    model_group: object = None
    group: object = None

    @property
    def rank(self) -> int:
        """The rank's index in the grid, data-major."""
        return self.data_rank * self.n_model + self.model_rank

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n rows."""
        return _part(n, self.data_rank, self.n_data, "rows", DATA_AXIS)

    def cols(self, n: int) -> slice:
        """This rank's part of a dimension of n split over the model axis."""
        return _part(n, self.model_rank, self.n_model, "columns", MODEL_AXIS)


def _part(n: int, index: int, count: int, what: str, axis: str) -> slice:
    if n % count:
        raise ValueError(f"{n} {what} do not split over a {count}-wide "
                         f"{axis} axis")
    k = n // count
    return slice(index * k, (index + 1) * k)


def largest_data_width(batch_size: int, world: int) -> int:
    """The reference's auto-mesh rule: the widest n <= world that divides
    the batch."""
    n = world
    while batch_size % n:
        n -= 1
    return n


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device(device) -> torch.device:
    """The rank's device: `device`, or the current card; "cuda" without an
    index is the current card, which the launchers set per rank."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_data: int = -1, n_model: int = 1, *,
              device=None) -> Mesh | None:
    """This rank's Mesh over the first n_data x n_model ranks of the
    world (n_data=-1: as many as fit), data-major as the reference lays
    out its device grid. Called by every rank: building the groups is
    collective. Ranks past the grid get None. Without an initialized
    process group (spawn and init_from_env make one) the world is this
    process: a 1 x 1 mesh with no groups. `device` is the rank's device
    (default: its current card)."""
    world = _world()
    if n_data == -1:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"ranks, have {world}")
    dev = _rank_device(device)
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, dev)
    from torch.distributed.device_mesh import DeviceMesh

    size = n_data * n_model
    grid = torch.arange(size).reshape(n_data, n_model)
    dm = DeviceMesh(dev.type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    whole = dist.new_group(list(range(size)))
    coord = dm.get_coordinate()
    if coord is None:
        return None
    return Mesh(n_data, n_model, coord[0], coord[1], dev, dm,
                dm.get_group(DATA_AXIS), dm.get_group(MODEL_AXIS), whole)


def largest_data_mesh(batch_size: int, world: int | None = None, *,
                      device=None) -> Mesh | None:
    """The widest pure-data mesh over the first `world` ranks (default:
    all) whose width divides `batch_size`: the shared rule of Trainer,
    ProposalTrainer and cli.eval."""
    world = _world() if world is None else world
    return make_mesh(n_data=largest_data_width(batch_size, world),
                     n_model=1, device=device)


def _check_nccl_devices(backend: str, ranks_here: int) -> None:
    if backend == "nccl" and ranks_here > torch.cuda.device_count():
        raise RuntimeError(
            f"NCCL needs a card per rank: {ranks_here} ranks on this host, "
            f"{torch.cuda.device_count()} cards; use backend='gloo' to share "
            f"a card")


def _setup_rank(device_type: str, local_rank: int, backend) -> str:
    """Pins the rank to its card (local_rank modulo the cards, so ranks
    may share one under gloo) or to one CPU thread; returns the backend
    (default NCCL on the card, gloo on the CPU)."""
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        return backend or "nccl"
    torch.set_num_threads(1)
    return backend or "gloo"


def init_from_env(device=None, *, backend=None, timeout_s: float = 1800):
    """Joins the world torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT): pins the rank to card LOCAL_RANK (or the
    CPU when device="cpu"), then initializes the default process group.
    Returns the rank's device."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev_type = _rank_device(device).type
    backend = _setup_rank(dev_type, local, backend)
    _check_nccl_devices(backend, int(os.environ.get(
        "LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])))
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return _rank_device(None if dev_type == "cuda" else "cpu")


def _rank_main(rank, world, backend, device_type, workdir, timeout_s):
    """A spawned rank: join the file rendezvous, run the task that
    workdir/task.pkl holds, (fn, args, kwargs), and save its result (or
    the traceback) under workdir."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host
        with open(os.path.join(workdir, "task.pkl"), "rb") as f:
            fn, args, kwargs = pickle.load(f)
        backend = _setup_rank(device_type, rank, backend)
        dist.init_process_group(
            backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(workdir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, world: int, *, args: Sequence = (), kwargs=None,
          backend=None, device: str | None = None, timeout_s: float = 300,
          workdir: str | None = None) -> list:
    """Runs fn(*args, **kwargs) on `world` new processes joined in one
    process group (a file:// rendezvous, so no port is taken) and returns
    the ranks' results in rank order. `device` None or "cuda" pins rank r
    to card r modulo the cards (None raises where there is no card, before
    any process starts); "cpu" pins each rank to one CPU thread. `backend`
    defaults to gloo on the CPU and NCCL on the card, which needs a card
    per rank. fn must be importable by name (a module-level function of a
    module that the new processes can import). Raises if any rank raises
    or exits, or if the ranks have not all finished within timeout_s
    seconds; the other ranks are then stopped."""
    import multiprocessing as mp

    device = resolve_device(device).type
    if device == "cuda":
        _check_nccl_devices(backend or "nccl", world)
    workdir = tempfile.mkdtemp(prefix="mpn_spawn_", dir=workdir)
    # the task goes through a file: a large one through each process's
    # pipe would start the ranks one after another
    with open(os.path.join(workdir, "task.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args), dict(kwargs or {})), f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, backend, device, workdir, timeout_s))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        name = getattr(fn, "__name__", fn)
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {name} did not finish "
                                   f"within {timeout_s} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        if failed:
            errors = []
            for r in failed:
                path = os.path.join(workdir, f"error_{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"ranks {failed} of {name} failed "
                f"(exit codes {[procs[r].exitcode for r in failed]}):\n"
                + "\n".join(errors))
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------- collectives ---

def _active(group) -> bool:
    return group is not None and dist.get_world_size(group) > 1


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (t itself on a group of one)."""
    if not _active(group):
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of t over the group's ranks."""
    if not _active(group):
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' t concatenated along `dim`, in group rank order."""
    if not _active(group):
        return t
    if t.dtype == torch.bool:  # gloo gathers no bool tensors
        return all_gather_cat(t.to(torch.uint8), group, dim).bool()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def broadcast_object(obj, group, src_index: int = 0):
    """obj of the group's rank `src_index`, on every rank of the group."""
    if not _active(group):
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group, src_index), group=group)
    return box[0]


def barrier(mesh: Mesh | None) -> None:
    """Waits for every rank of the mesh (an all-reduce on its device,
    which gloo and NCCL both take)."""
    if mesh is not None and _active(mesh.group):
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


def sum_metrics(metrics: dict, group) -> dict:
    """A dict of 0-d tensors summed over the group in one all-reduce."""
    if not _active(group) or not metrics:
        return metrics
    keys = list(metrics)
    flat = all_sum(torch.stack([metrics[k].detach().float()
                                for k in keys]), group)
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


@torch.no_grad()
def all_sum_grads_(params, group) -> None:
    """Sums each parameter's .grad over the group, in place: flat buffers
    of the gradients in parameter order, reduced bucket by bucket, so the
    sum's order is fixed and two steps from one state repeat bit for bit.
    Parameters without a gradient are left out on every rank alike."""
    if not _active(group):
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        for bucket in _buckets(grads):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group)
            parts = flat.split([g.numel() for g in bucket])
            torch._foreach_copy_(bucket, [f.view_as(g)
                                          for f, g in zip(parts, bucket)])


def _buckets(tensors):
    """Consecutive runs of tensors of at most _GRAD_BUCKET elements (or
    one larger tensor)."""
    bucket, n = [], 0
    for t in tensors:
        if bucket and n + t.numel() > _GRAD_BUCKET:
            yield bucket
            bucket, n = [], 0
        bucket.append(t)
        n += t.numel()
    if bucket:
        yield bucket


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel layer, whose gradient each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a
    row-parallel layer, a sum of the ranks' partial products."""

    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    """All-gather of the last dimension forward, this rank's columns of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


class _SplitCols(torch.autograd.Function):
    """This rank's columns forward, all-gather of the gradient backward:
    a replicated input entering a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        i = dist.get_rank(group)
        w = x.shape[-1] // n
        return x[..., i * w:(i + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, -1), None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group) if _active(group) else x


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group) if _active(group) else x


def gather_cols(x, group):
    return _GatherCols.apply(x, group) if _active(group) else x


def split_cols(x, group):
    return _SplitCols.apply(x, group) if _active(group) else x


# ------------------------------------------------------ the head's layout ---

@dataclass(frozen=True)
class MeshRules:
    """The reference's tensor-parallel rules for the detection head
    (MeshRules.tree_sharding), over a model axis of n_model ranks."""

    n_model: int

    def head_layout(self, name: str, shape: tuple,
                    svd_pairs=()) -> int | None:
        """The axis of `shape` that the model axis shards, or None for a
        replicated leaf. `name` is "layer/leaf" in the reference's tree
        ("fc6_f0/kernel", "cls_bbox/kernel_scale"), `shape` the leaf's
        shape there (kernels (in, out)), `svd_pairs` the names of the
        factored layers' first factors ("fc6_f0_u", ...).

        fc6_f* and cls_bbox are column-parallel (the kernel's output axis,
        the per-output kernel_scale and bias with it), fc7_f* row-parallel
        (the kernel's input axis; its scale and bias replicated). Of a
        truncated-SVD pair the *_u factor is column-parallel over the rank
        and its partner row-parallel over it. A layer whose sharded axis
        does not divide the model axis is replicated; the two factors of
        a pair key the same rank, so they fall back together."""
        layer, _, leaf = name.rpartition("/")
        if self.n_model <= 1 or len(shape) < 1:
            return None
        if not (layer.startswith(("fc6_f", "fc7_f")) or layer == "cls_bbox"):
            return None
        is_w = leaf in ("kernel", "kernel_i8") and len(shape) == 2
        is_vec = leaf in ("kernel_scale", "bias") and len(shape) == 1
        if not (is_w or is_vec):
            return None
        if layer.endswith("_u"):
            col = True
        elif f"{layer}_u" in svd_pairs:
            col = False
        else:
            col = layer.startswith("fc6_f") or layer == "cls_bbox"
        if col:
            out = shape[-1] if is_w else shape[0]
            return None if out % self.n_model else (1 if is_w else 0)
        return 0 if is_w and shape[0] % self.n_model == 0 else None
