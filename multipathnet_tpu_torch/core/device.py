"""The device an entry point runs on when its caller names none, the
synchronous put of a host array, and the host-to-device copy that
prefetching consumers use. Both count the bytes they take from the host
(counter h2d.bytes, utils/profiling); `put` counts its wait on the card
(sync.put)."""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.utils import profiling


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card. Without one,
    raise rather than carry on on the CPU: a caller who wants the CPU (the
    tests do) passes device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def _host_bytes(t) -> int:
    return t.numel() * t.element_size()


def put(x, dtype, device) -> torch.Tensor:
    """x (numpy, a host tensor, or a tensor already on a device) -> a
    tensor of `dtype` on `device`. Host data is copied synchronously
    (from pageable memory the copy waits for the card's stream), and its
    bytes are counted even on the CPU, where the tensor may share the
    array's memory; a tensor on a device is used as it is or converted
    there."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
        profiling.count("h2d.bytes", _host_bytes(t))
        profiling.count_sync("put", t.device)
    return t


class HostToDevice:
    """Copies host arrays to one device ahead of their use.

    On a CUDA device a call stages its arrays in pinned host memory and
    copies them on a side stream, so the copy overlaps the work already
    queued on the caller's stream. That stream then waits for the copy (an
    event), so work queued on it after the call reads the copied values,
    and each copied tensor is recorded on it, so the caching allocator does
    not hand the memory to a later copy while work queued there may still
    read it. On any other device a call is the plain conversion."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, arrays, dtypes) -> list:
        """Host arrays (numpy or CPU tensors; None passes through) -> one
        tensor of the paired dtype each, on the device."""
        if self.stream is None:
            return [None if x is None else put(x, dt, self.device)
                    for x, dt in zip(arrays, dtypes)]
        consumer = torch.cuda.current_stream(self.device)
        host = [None if x is None
                else torch.as_tensor(x, dtype=dt).pin_memory()
                for x, dt in zip(arrays, dtypes)]
        profiling.count("h2d.bytes", sum(_host_bytes(h) for h in host
                                         if h is not None))
        with torch.cuda.stream(self.stream):
            out = [None if h is None
                   else h.to(self.device, non_blocking=True) for h in host]
            copied = torch.cuda.Event()
            copied.record(self.stream)
        consumer.wait_event(copied)
        for t in out:
            if t is not None:
                t.record_stream(consumer)
        return out
