"""A scatter-add whose order of summation is fixed.

`index_put_(..., accumulate=True)` and the backward of a gather (which is
one) sum in an order that is not fixed: on the CPU PyTorch splits an
accumulating index_put_ over threads with atomic float adds, on the card
it may use atomics too, so a float32 sum of many values into one cell can
differ in its last bits from call to call. `scatter_rows` sorts the target
rows (a stable sort, so each row keeps its values in index order), sums
each row's run of values in that order (torch.segment_reduce: one
sequential sum per row on the CPU, a reduction without atomics on the
card) and writes each row once. On the CPU the result is the serial
index_put_'s, bit for bit, whatever the thread count.
"""

from __future__ import annotations

import torch


def scatter_rows(index: torch.Tensor, values: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """index (M,) integer rows, values (M, C) -> (n_rows, C) zeros with
    values[m] added into row index[m], each row's values summed in index
    order. values' dtype; rows nobody targets stay 0."""
    out = values.new_zeros((n_rows, values.shape[1]))
    if index.numel() == 0:
        return out
    index = index.reshape(-1).long()
    order = torch.sort(index, stable=True).indices
    rows, counts = torch.unique_consecutive(index[order], return_counts=True)
    out[rows] = torch.segment_reduce(values[order], "sum", lengths=counts,
                                     axis=0, unsafe=True)
    return out


class GatherRows(torch.autograd.Function):
    """flat[index] (flat (N, C), index any shape -> index.shape + (C,))
    whose backward is scatter_rows: the gradient of a gather summed in a
    fixed order."""

    @staticmethod
    def forward(ctx, flat, index):
        ctx.n_rows = flat.shape[0]
        ctx.save_for_backward(index)
        return flat[index]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        c = grad.shape[-1]
        return scatter_rows(index, grad.reshape(-1, c), ctx.n_rows), None


def gather_rows(flat: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """flat[index] with a fixed-order backward (GatherRows)."""
    return GatherRows.apply(flat, index)
