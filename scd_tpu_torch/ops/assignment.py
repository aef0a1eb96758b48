"""Assignment ops on the tensors' device: contingency matrix and auction.

Port of ``scd_tpu/ops/assignment.py`` (XLA code there, not a Pallas
kernel), in plain PyTorch.  Host scipy stays the parity path of the
metrics (``metrics/cluster.py``); these are the device-resident
equivalents.

``auction_assignment`` is Bertsekas' auction with Jacobi (parallel)
bidding, each round the JAX ``while_loop``'s body in f32.  For integer
profit matrices and ``eps < 1/n`` it attains the exact optimal total, so
vote matrices (integer counts) need no approximation.  The loop reads one
flag to the host a round for its exit test.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from scd_tpu_torch.core.device import resolve_device


def contingency_matrix_device(y_pred: torch.Tensor, y_true: torch.Tensor,
                              n_rows: int, n_cols: int) -> torch.Tensor:
    """[n_rows, n_cols] int32 counts of (pred, true) pairs, on the labels'
    device."""
    flat = y_pred.long() * n_cols + y_true.long()
    counts = torch.bincount(flat, minlength=n_rows * n_cols)
    return counts[:n_rows * n_cols].to(torch.int32).reshape(n_rows, n_cols)


def _auction_device(profit: torch.Tensor, eps: float, max_iters: int
                    ) -> Tuple[torch.Tensor, int]:
    """(person -> object [n] int32, -1 where unassigned; rounds run) for
    the f32 square ``profit``."""
    n = profit.shape[0]
    dev = profit.device
    big_neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    eps = torch.tensor(eps, dtype=torch.float32, device=dev)
    ar = torch.arange(n, device=dev)
    person_to_obj = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prices = torch.zeros(n, dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and bool((person_to_obj < 0).any()):
        unassigned = person_to_obj < 0
        value = profit - prices[None, :]
        # top-2 values per person
        best_j = torch.argmax(value, dim=1)
        v1 = value.gather(1, best_j[:, None])[:, 0]
        masked = value.clone()
        masked[ar, best_j] = big_neg
        v2 = masked.max(dim=1).values
        bid = prices[best_j] + (v1 - v2) + eps
        bid = torch.where(unassigned, bid, big_neg)

        # per-object highest bid (scatter-max over bidders)
        obj_bid = torch.full((n,), -1e30, dtype=torch.float32,
                             device=dev).scatter_reduce(0, best_j, bid,
                                                        reduce="amax")
        has_bid = obj_bid > big_neg / 2
        # winner: the bidder whose bid equals the object max (ties: lowest i)
        is_winner = ((bid[:, None] >= obj_bid[None, :])
                     & (ar[None, :] == best_j[:, None]) & unassigned[:, None])
        winner = torch.argmax(is_winner.to(torch.uint8), dim=0)

        # evict previous owner of objects that received bids
        owned = torch.where(person_to_obj >= 0, person_to_obj,
                            0).long()
        evict = ((person_to_obj >= 0) & has_bid[owned]
                 & (winner[owned] != ar))
        person_to_obj = torch.where(evict, -1, person_to_obj)
        # assign winners (objects without bids scatter into a dropped slot)
        won_obj = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        won_obj[torch.where(has_bid, winner, n)] = ar.to(torch.int32)
        won_obj = won_obj[:n]
        person_to_obj = torch.where(won_obj >= 0, won_obj, person_to_obj)
        prices = torch.where(has_bid, obj_bid, prices)
        it += 1
    return person_to_obj, it


def _host_solve(profit: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    _r, c = linear_sum_assignment(-profit)
    return c.astype(np.int64)


def auction_assignment(profit: np.ndarray, eps: Optional[float] = None,
                       max_iters: int = 100_000,
                       device="cuda") -> np.ndarray:
    """Maximize ``sum(profit[i, assign[i]])`` over permutations; returns
    ``assign`` [n] (person -> object).  Exact for integer profits with the
    default ``eps = 1/(n+1)``.  The auction runs on ``device`` (the card
    unless the caller asks for the CPU)."""
    profit = np.asarray(profit, np.float64)
    assert profit.ndim == 2 and profit.shape[0] == profit.shape[1], \
        "auction_assignment expects a square profit matrix (pad if needed)"
    n = profit.shape[0]
    # center: prices track profit magnitudes, and once price ulp exceeds eps
    # the float32 update `price + (v1-v2) + eps` stalls (two bidders evict
    # each other forever).  Subtracting the max bounds prices by the profit
    # RANGE instead of its absolute scale; assignment is shift-invariant.
    profit = profit - profit.max()
    profit32 = profit.astype(np.float32)
    if eps is None:
        eps = 1.0 / (n + 1)
    if np.float32(profit32.min()) - np.float32(eps) == np.float32(profit32.min()):
        # range so large eps is below ulp even after centering: exact host solve
        return _host_solve(profit)
    dev = resolve_device(device)
    assign, _it = _auction_device(torch.from_numpy(profit32).to(dev),
                                  float(np.float32(eps)), max_iters)
    assign = assign.cpu().numpy()
    if (assign < 0).any():  # max_iters hit — fall back to exact host solve
        return _host_solve(profit)
    return assign.astype(np.int64)


def linear_assignment_device(cost: np.ndarray, device="cuda") -> np.ndarray:
    """Drop-in for ``metrics.cluster.linear_assignment`` (min-cost,
    [[row, col], ...] sorted by row) running the auction on ``device``."""
    cost = np.asarray(cost, np.float32)
    assign = auction_assignment(-cost, device=device)
    return np.stack([np.arange(len(assign)), assign], axis=1)
