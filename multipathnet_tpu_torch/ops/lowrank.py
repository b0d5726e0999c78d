"""Truncated-SVD factorization of the FC detection heads (serving) — a copy
of the numpy half of multipathnet_tpu/ops/lowrank.py.

Fast R-CNN §3.1 "Truncated SVD for faster detection": at load or export
each fc kernel W (K, N) becomes W ~= A @ B, A = U_t (K, t) and
B = diag(s_t) V_t^T (t, N), one GEMM turned into two of t * (K + N) MACs.
`factorize_head_params` rewrites fc6_f{i}/fc7_f{i} {kernel, bias} of a
flax-layout tree into fc6_f{i}_u {kernel (K, t)} + fc6_f{i} {kernel (t, N),
bias}, the layout of a head built with fc6_rank/fc7_rank > 0. It runs
before int8 quantization (it needs float kernels): on the host in numpy,
a torch leaf on the CPU copied there first; a leaf on the card is
factorized there by the same algorithm in torch (`factorize_kernel_torch`,
the same Gaussian test matrix; its factors stay on the card), because a
host pass over VGG-16's four 25088 x 4096 fc6 kernels takes minutes. The
numpy path is held equal to the reference by tests/test_torch_quant.py,
the torch one to the numpy one within float32 rounding by
tests/test_torch_tools.py.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping

import numpy as np
import torch

# Relative Frobenius truncation error above which factorize_head_params
# warns: a near-flat spectrum (an undertrained checkpoint) factors to
# garbage at the paper's ranks (the reference measured AP 0.0).
TRUNCATION_WARN_REL_ERR = 0.5


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def factorize_kernel(w, rank: int, method: str = "auto",
                     oversample: int = 16, power_iters: int = 2,
                     seed: int = 0):
    """(K, N) float kernel -> (A (K, rank), B (rank, N)) with A @ B ~= W,
    the singular values folded into B so A's columns stay orthonormal.

    method: "exact" (full SVD, then truncate), "randomized" (Halko,
    Martinsson and Tropp's range finder with `power_iters` subspace
    iterations and `oversample` extra columns, deterministic for a seed),
    or "auto": randomized when rank + oversample < min(K, N) // 2."""
    w = _host(w)
    k, n = w.shape
    if not 1 <= rank <= min(k, n):
        raise ValueError(f"rank {rank} out of [1, {min(k, n)}] for a kernel "
                         f"of shape {w.shape}")
    if method == "auto":
        method = ("randomized"
                  if rank + oversample < min(k, n) // 2 else "exact")
    if method == "exact":
        u, s, vt = np.linalg.svd(w, full_matrices=False)
    elif method == "randomized":
        rng = np.random.default_rng(seed)
        r = min(rank + oversample, min(k, n))
        tall = w if k >= n else w.T   # sample the row space of the tall side
        g = rng.standard_normal((tall.shape[1], r)).astype(np.float32)
        y = tall @ g
        for _ in range(power_iters):
            y, _ = np.linalg.qr(y)
            y = tall @ (tall.T @ y)
        q, _ = np.linalg.qr(y)
        ub, s, vt_s = np.linalg.svd(q.T @ tall, full_matrices=False)
        u_tall = q @ ub
        u, vt = (u_tall, vt_s) if k >= n else (vt_s.T, u_tall.T)
    else:
        raise ValueError(f"unknown method {method!r}")
    a = u[:, :rank]
    b = s[:rank, None] * vt[:rank]
    return a.astype(np.float32), b.astype(np.float32)


def _on_card(w) -> bool:
    return isinstance(w, torch.Tensor) and w.device.type != "cpu"


def factorize_kernel_torch(w: torch.Tensor, rank: int, method: str = "auto",
                           oversample: int = 16, power_iters: int = 2,
                           seed: int = 0):
    """factorize_kernel in torch float32 on w's device: the same methods,
    the same Gaussian test matrix (numpy's, from `seed`), factors on w's
    device."""
    w = w.detach().float()
    k, n = w.shape
    if not 1 <= rank <= min(k, n):
        raise ValueError(f"rank {rank} out of [1, {min(k, n)}] for a kernel "
                         f"of shape {tuple(w.shape)}")
    if method == "auto":
        method = ("randomized"
                  if rank + oversample < min(k, n) // 2 else "exact")
    if method == "exact":
        u, s, vt = torch.linalg.svd(w, full_matrices=False)
    elif method == "randomized":
        rng = np.random.default_rng(seed)
        r = min(rank + oversample, min(k, n))
        tall = w if k >= n else w.T
        g = torch.from_numpy(rng.standard_normal(
            (tall.shape[1], r)).astype(np.float32)).to(w.device)
        y = tall @ g
        for _ in range(power_iters):
            y, _ = torch.linalg.qr(y)
            y = tall @ (tall.T @ y)
        q, _ = torch.linalg.qr(y)
        ub, s, vt_s = torch.linalg.svd(q.T @ tall, full_matrices=False)
        u_tall = q @ ub
        u, vt = (u_tall, vt_s) if k >= n else (vt_s.T, u_tall.T)
    else:
        raise ValueError(f"unknown method {method!r}")
    return u[:, :rank].contiguous(), (s[:rank, None] * vt[:rank]).contiguous()


def truncation_rel_err(w, a, b) -> float:
    """||W - AB|| / ||W|| (Frobenius) without forming AB: A's columns are
    orthonormal and B = A^T W, so ||W - AB||^2 = ||W||^2 - ||B||^2."""
    if _on_card(w):
        wsq = float(torch.sum(torch.square(w.detach().float())))
        bsq = float(torch.sum(torch.square(b.detach().float())))
    else:
        wsq = float(np.sum(np.square(_host(w))))
        bsq = float(np.sum(np.square(_host(b))))
    return float(np.sqrt(max(0.0, 1.0 - bsq / max(wsq, 1e-30))))


def _is_factor(name) -> bool:
    return (isinstance(name, str) and name.endswith("_u")
            and name.startswith(("fc6_f", "fc7_f")))


def is_factored(params) -> bool:
    """True if the tree already carries low-rank factor layers."""
    if not isinstance(params, Mapping):
        return False
    return any(_is_factor(k) or is_factored(v) for k, v in params.items())


def check_factored_ranks(params, fc6_rank: int, fc7_rank: int) -> None:
    """Raise ValueError, naming the layer, where an already factored tree's
    factor width differs from the config's rank."""
    if not isinstance(params, Mapping):
        return
    want = {"fc6_f": fc6_rank, "fc7_f": fc7_rank}
    for k, v in params.items():
        if _is_factor(k) and isinstance(v, Mapping) and "kernel" in v:
            prefix = k[:5]
            got = v["kernel"].shape[1]
            if got != want[prefix]:
                raise ValueError(
                    f"params are factored at rank {got} for {k} but the "
                    f"config says {prefix.rstrip('_f')}_rank={want[prefix]}"
                    "; re-export from the full-rank float checkpoint")
        check_factored_ranks(v, fc6_rank, fc7_rank)


def factorize_head_params(params, fc6_rank: int = 0, fc7_rank: int = 0,
                          report: dict | None = None):
    """Factorize every fc6_f*/fc7_f* kernel of a float flax-layout tree
    (nested dicts of arrays) at the given ranks (0 leaves that family full
    rank); the rest of the tree is untouched. Raises ValueError on a layer
    that is already int8. `report`, if a dict, receives {layer: relative
    truncation error}; a UserWarning names the worst layer when any error
    exceeds TRUNCATION_WARN_REL_ERR."""
    errs = report if report is not None else {}

    def rank_for(name: str) -> int:
        if name.endswith("_u"):
            return 0
        if name.startswith("fc6_f"):
            return fc6_rank
        if name.startswith("fc7_f"):
            return fc7_rank
        return 0

    def walk(d):
        out = {}
        for k, v in d.items():
            r = rank_for(k) if isinstance(v, Mapping) else 0
            if r > 0 and "kernel_i8" in v:
                raise ValueError(
                    f"{k} is already int8-quantized; SVD factorization "
                    "needs float kernels — re-export from the float "
                    "checkpoint (factorize first, then quantize)")
            if r > 0 and "kernel" in v:
                if f"{k}_u" in d:
                    raise ValueError(f"{k} is already factored")
                a, b = (factorize_kernel_torch if _on_card(v["kernel"])
                        else factorize_kernel)(v["kernel"], r)
                errs[k] = truncation_rel_err(v["kernel"], a, b)
                out[f"{k}_u"] = {"kernel": a}
                out[k] = {"kernel": b,
                          **({"bias": v["bias"]} if "bias" in v else {})}
            elif isinstance(v, Mapping):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    out = walk(params)
    bad = {k: e for k, e in errs.items() if e > TRUNCATION_WARN_REL_ERR}
    if bad:
        worst = max(bad, key=bad.get)
        warnings.warn(
            f"truncated-SVD rank is too aggressive for this checkpoint's "
            f"spectrum: {len(bad)}/{len(errs)} kernels lose >"
            f"{TRUNCATION_WARN_REL_ERR:.0%} of their Frobenius energy "
            f"(worst {worst}: rel err {bad[worst]:.2f}). Undertrained "
            f"checkpoints have near-flat spectra and factor to garbage; "
            f"train longer or raise fc6_rank/fc7_rank.", stacklevel=2)
    return out
