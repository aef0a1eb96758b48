"""k-means++ seeding on the features' device.

Port of ``scd_tpu/ops/kpp.py::kmeans_plus_plus`` (reference
``sskm_constrained.py:28-44``): the running min-distance ``d2`` is kept
incrementally and each draw is an inverse-CDF search, the reference's
``cum_prob >= r``.  Draws come from a ``torch.Generator``; they are not the
JAX package's ``jax.random`` bits, so parity tests hand both packages the
same initial centers instead (ROADMAP records the choice).

``pre_centers`` pins the first P centers (the semi-supervised variant seeds
them from labelled class means, ``sskm_constrained.py:108``).
:func:`kmeans_plus_plus_local_trials` is the greedy variant constrained
clustering seeds with.

Padded rows (``n_valid``: a count, the pads the row suffix, or a [N] 0/1
mask, the pads anywhere) never enter the draws: the first draw picks the
r-th VALID row, so a count and the equivalent prefix mask give the same
bits.  Over a ``mesh`` (``core/mesh.py``) ``x`` is this rank's row shard
and the draw is distributed: every rank keeps ``d2`` over its own rows,
draws the same ``u`` from its own copy of the generator (which advances in
lockstep: no rank-dependent code touches it), finds the owner rank from
the gathered per-rank sums of ``d2`` (one ``all_gather``), and the owner
searches its local cumulative sum and ``broadcast``s the chosen row.  The
chosen global rows are the single-process draws' up to float order in the
cumulative sums (a draw within rounding of a shard boundary can differ).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from scd_tpu_torch.ops.distance import pairwise_sqdist


def auto_local_trials(k: int) -> int:
    """The vendored package's greedy-trial count
    (``k_means_constrained_.py:93-96``)."""
    return 2 + int(np.log(k))


def _valid_rows(n: int, n_valid, device) -> Optional[torch.Tensor]:
    """bool [N] of the valid rows from a validity spec (None: all valid,
    returned as None; a count: the prefix; a [N] mask)."""
    if n_valid is None:
        return None
    if isinstance(n_valid, (int, np.integer)) or getattr(
            n_valid, "ndim", 1) == 0:
        return torch.arange(n, device=device) < int(n_valid)
    return torch.as_tensor(np.asarray(n_valid) if not isinstance(
        n_valid, torch.Tensor) else n_valid, device=device).bool()


class _Rows:
    """The rows the draws pick from: ``x`` (this rank's shard over a
    mesh), its valid mask, and where its valid rows sit globally."""

    def __init__(self, x: torch.Tensor, n_valid, mesh):
        self.x, self.mesh = x, mesh
        self.valid = _valid_rows(x.shape[0], n_valid, x.device)
        n_here = x.shape[0] if self.valid is None else int(self.valid.sum())
        if mesh is None:
            self.counts = np.asarray([n_here])
            self.me = 0
        else:
            from scd_tpu_torch.core.multihost import gather_counts

            self.counts = gather_counts(mesh, n_here)
            self.me = mesh.data_index
        self.offset = int(self.counts[:self.me].sum())

    def mask(self, d2: torch.Tensor) -> torch.Tensor:
        return d2 if self.valid is None else torch.where(
            self.valid, d2, torch.zeros((), device=d2.device))

    def mask_trials(self, d2: torch.Tensor) -> torch.Tensor:
        """``mask`` for a [N, T] block of trial distances."""
        return d2 if self.valid is None else torch.where(
            self.valid[:, None], d2, torch.zeros((), device=d2.device))

    def local_row(self, j: int) -> int:
        """Local row index of this rank's j-th valid row."""
        if self.valid is None:
            return j
        return int(torch.nonzero(self.valid)[j, 0])

    def valid_rank(self, j_local_row: int) -> int:
        """Position among this rank's valid rows of a local row index."""
        if self.valid is None:
            return j_local_row
        return int(self.valid[:j_local_row].sum())

    def shard_sums(self, d2: torch.Tensor) -> torch.Tensor:
        """Every rank's sum of ``d2`` (f32, host, rank order)."""
        from scd_tpu_torch.core.multihost import all_gather

        return torch.cat([g.cpu() for g in all_gather(
            d2.sum().reshape(1), group=self.mesh.data_group)])

    def fetch(self, owner: int, local: int) -> torch.Tensor:
        """Row ``local`` of rank ``owner``'s shard [1, D], on every rank."""
        from scd_tpu_torch.core.multihost import broadcast

        row = (self.x[local:local + 1].clone() if owner == self.me
               else self.x.new_zeros((1, self.x.shape[1])))
        return broadcast(row, src=self.mesh.axis_ranks("data")[owner],
                         group=self.mesh.data_group)

    def fetch_many(self, owners: List[int], locals_: List[int]
                   ) -> torch.Tensor:
        """Rows [T, D], row t = row ``locals_[t]`` of rank ``owners[t]``:
        each owner fills its rows into zeros and one ``all_reduce`` sums
        them (adding zeros is exact)."""
        from scd_tpu_torch.core.multihost import all_reduce

        out = self.x.new_zeros((len(owners), self.x.shape[1]))
        for t, (o, j) in enumerate(zip(owners, locals_)):
            if o == self.me:
                out[t] = self.x[j]

        return all_reduce(out, group=self.mesh.data_group)

    def last_valid(self):
        """(owner rank, local row) of the globally last valid row."""
        owner = int(np.flatnonzero(self.counts > 0)[-1])
        if owner != self.me:
            return owner, -1
        return owner, self.local_row(int(self.counts[owner]) - 1)


def _first_centers(rows: _Rows, k: int, generator: torch.Generator,
                   pre_centers: Optional[torch.Tensor], idx: List[int]):
    """(centers [k, D] with the first ``start`` rows set, running min
    distance d2 [N] (pads 0), start): the pins, or one uniform draw over
    the valid rows."""
    x = rows.x
    n, d = x.shape
    dev = x.device
    if pre_centers is not None and pre_centers.shape[0] == 0:
        pre_centers = None  # empty pin set == unsupervised seeding
    centers = torch.zeros(k, d, dtype=torch.float32, device=dev)
    if pre_centers is not None:
        p = pre_centers.shape[0]
        centers[:p] = pre_centers.float()
        idx.extend([-1] * p)
        return centers, rows.mask(
            pairwise_sqdist(x, pre_centers).min(dim=1).values), p
    total = int(rows.counts.sum())
    r = torch.randint(0, total, (1,), generator=generator, device=dev)
    if rows.mesh is None:  # on the device: no host round-trip
        first = r if rows.valid is None else torch.argmax(
            (torch.cumsum(rows.valid.int(), 0) >= r + 1).to(torch.uint8)
        ).view(1)
        c0 = x.index_select(0, first)
        idx.append(r)
    else:
        r = int(r)
        owner = int(np.searchsorted(np.cumsum(rows.counts), r, side="right"))
        j = r - int(rows.counts[:owner].sum())
        c0 = rows.fetch(owner, rows.local_row(j) if owner == rows.me else 0)
        idx.append(r)
    centers[0] = c0[0]
    return centers, rows.mask(((x - c0) ** 2).sum(dim=1)), 1


def kmeans_plus_plus(x: torch.Tensor, k: int, generator: torch.Generator,
                     pre_centers: Optional[torch.Tensor] = None,
                     n_valid=None, mesh=None, return_index: bool = False):
    """Sample ``k`` centers [k, D] f32 from ``x`` [N, D].  Every step stays
    on the device (no host round-trip per draw) without a mesh; over a
    mesh each draw reads the per-rank sums on the host.  With
    ``return_index`` also returns each center's global row index among
    the valid rows (-1 for a pinned center)."""
    x = x.float()
    dev = x.device
    rows = _Rows(x, n_valid, mesh)
    idx: List[int] = []
    centers, d2, start = _first_centers(rows, k, generator, pre_centers, idx)
    for i in range(start, k):
        r = torch.rand((1,), generator=generator, device=dev)
        if mesh is None:
            prob = d2 / d2.sum().clamp_min(1e-30)
            cum = torch.cumsum(prob, dim=0)
            j = torch.argmax((cum >= r).to(torch.uint8))  # first cum >= r
            new_c = x.index_select(0, j.view(1))
            if return_index:
                idx.append(rows.valid_rank(int(j)))
        else:
            sums = rows.shard_sums(d2)
            total = sums.sum().clamp_min(1e-30)
            incl = torch.cumsum(sums / total, dim=0)
            hit = torch.nonzero(incl >= r.cpu())
            # past every shard (rounding): the first row, as argmax of an
            # all-False test gives on one device
            owner = int(hit[0, 0]) if len(hit) else 0
            j = 0
            if owner == rows.me and len(hit):
                base = incl[owner - 1] if owner else torch.zeros(())
                cum = base.to(dev) + torch.cumsum(d2 / total.to(dev), dim=0)
                ok = torch.nonzero(cum >= r)
                j = int(ok[0, 0]) if len(ok) else int(
                    torch.nonzero(d2 > 0)[-1, 0])
            elif owner == rows.me:
                j = rows.local_row(0)
            new_c = rows.fetch(owner, j)
            if return_index:
                idx.append(_global_index(rows, owner, j))
        centers[i] = new_c[0]
        d2 = rows.mask(torch.minimum(d2, ((x - new_c) ** 2).sum(dim=1)))
    return (centers, [int(i) for i in idx]) if return_index else centers


def _global_index(rows: _Rows, owner: int, j: int) -> int:
    """The chosen row's index among all valid rows (global order): the
    owner knows its local position, so one scalar goes round."""
    from scd_tpu_torch.core.multihost import all_reduce

    pos = torch.tensor([rows.offset + rows.valid_rank(j)
                        if owner == rows.me else 0], dtype=torch.int64)

    return int(all_reduce(pos, group=rows.mesh.data_group))


def kmeans_plus_plus_local_trials(x: torch.Tensor, k: int,
                                  generator: torch.Generator,
                                  n_local_trials: Optional[int] = None,
                                  pre_centers: Optional[torch.Tensor] = None,
                                  n_valid=None, mesh=None,
                                  return_index: bool = False):
    """k-means++ with greedy local trials (the vendored package's
    ``_k_init``, ``k_means_constrained_.py:89-144``): each step draws
    ``n_local_trials`` candidates D^2-proportionally (default
    ``2 + int(log(k))``) and keeps the one whose potential is least.  The
    T trials are scored as one [N, T] distance block; ties go to the
    first trial.  Over a mesh each trial's owner is found from the
    gathered per-rank sums, the candidate rows assemble with one
    ``all_reduce`` and each candidate's potential is all-reduced."""
    x = x.float()
    dev = x.device
    t = n_local_trials or auto_local_trials(k)
    rows = _Rows(x, n_valid, mesh)
    idx: List[int] = []
    centers, d2, start = _first_centers(rows, k, generator, pre_centers, idx)
    for i in range(start, k):
        if mesh is None:
            pot = d2.sum().clamp_min(1e-30)
            # searchsorted on the unnormalized cumsum (the reference's
            # rand * current_pot); when the remaining mass is ~0 the search
            # lands past the end, so clip to the last valid row
            r = torch.rand((t,), generator=generator, device=dev) * pot
            cand = torch.searchsorted(torch.cumsum(d2, dim=0), r)
            cand = cand.clamp_(0, rows.last_valid()[1])
            new_d2 = rows.mask_trials(torch.minimum(
                d2[:, None], pairwise_sqdist(x, x.index_select(0, cand))))
            best = torch.argmin(new_d2.sum(dim=0))
            centers[i] = x[cand[best]]
            if return_index:
                idx.append(rows.valid_rank(int(cand[best])))
            d2 = new_d2[:, best]
            continue
        sums = rows.shard_sums(d2)
        pot = sums.sum().clamp_min(1e-30)
        r = (torch.rand((t,), generator=generator, device=dev) * pot.to(dev))
        incl = torch.cumsum(sums, dim=0)
        owners, locs = [], []
        last_owner, last_j = rows.last_valid()
        cum = None
        for rt in r.cpu():
            hit = torch.nonzero(incl >= rt)
            if not len(hit):
                owners.append(last_owner)
                locs.append(last_j)
                continue
            o = int(hit[0, 0])
            j = -1
            if o == rows.me:
                if cum is None:
                    base = incl[o - 1] if o else torch.zeros(())
                    cum = base.to(dev) + torch.cumsum(d2, dim=0)
                j = min(int(torch.searchsorted(cum, rt.to(dev))),
                        rows.local_row(int(rows.counts[o]) - 1))
            owners.append(o)
            locs.append(j)
        cand_rows = rows.fetch_many(owners, locs)
        new_d2 = rows.mask_trials(torch.minimum(
            d2[:, None], pairwise_sqdist(x, cand_rows)))
        from scd_tpu_torch.core.multihost import all_reduce

        pots = all_reduce(new_d2.sum(dim=0), group=mesh.data_group)
        best = int(torch.argmin(pots))
        centers[i] = cand_rows[best]
        if return_index:
            idx.append(_global_index(rows, owners[best], locs[best]))
        d2 = new_d2[:, best]
    return (centers, [int(i) for i in idx]) if return_index else centers
