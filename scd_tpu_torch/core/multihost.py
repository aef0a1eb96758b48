"""Multi-process (multi-controller) helpers over ``torch.distributed``.

Port of ``scd_tpu/core/multihost.py``.  A JAX process can drive many
chips; the PyTorch idiom is one process per device, so the port's mesh is
always what the JAX package calls multi-controller:

- every rank runs the same program;
- a numpy (or tensor) row input to a mesh fitter is THIS RANK's shard
  (``rows_from_process_local`` pads ragged shares and masks the pads);
- side inputs (labelled features, targets, centers, weights) are the same
  full value on every rank (``replicate_to_mesh`` checks it);
- results come back replicated on every rank (``host_fetch``).

``initialize()`` brings up the process group: from the standard
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` variables that
``torchrun`` sets, or from explicit arguments (the CPU test rig,
``testing/dist.py``).  It binds ``cuda:LOCAL_RANK`` on a card and uses
``nccl`` there and ``gloo`` on the CPU; ``backend="gloo"`` on a card runs
several ranks on one device.  The only collectives are ``all_reduce``,
``all_gather`` (the list form), ``broadcast`` and ``barrier``, and what
is built on them for training: ``all_gather_rows`` (a gather whose
backward keeps this rank's slice), ``all_reduce_grads`` (every gradient
in one packed ``all_reduce``), and the tensor-parallel pair
``copy_to_model`` / ``reduce_from_model`` over a ``model`` group
(``models/vit.py``); under gloo a CUDA tensor
is staged through host memory, under nccl a host tensor through the
rank's card.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scd_tpu_torch.core.device import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_STATE = {"device": None}


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def local_device() -> torch.device:
    """The device :func:`initialize` bound for this rank (the CPU when
    nothing was initialized)."""
    return _STATE["device"] or torch.device("cpu")


def world_size_from_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout: float = 600.0) -> torch.device:
    """``torch.distributed.init_process_group`` for this rank; returns the
    device it bound.  Arguments left None come from the environment
    ``torchrun`` sets (``init_method`` then ``env://``, which reads
    ``MASTER_ADDR`` / ``MASTER_PORT``).  ``device`` defaults to the card
    when there is one; a card rank binds ``cuda:(local_rank mod cards)``.
    ``backend`` defaults to ``nccl`` on a card and ``gloo`` on the CPU.
    ``timeout`` (seconds) bounds every collective, so a lost rank fails
    the others instead of hanging them.  A second call returns the bound
    device."""
    if dist.is_initialized():
        return local_device()
    env = os.environ
    world_size = world_size_from_env() if world_size is None else world_size
    rank = int(env.get("RANK", "0")) if rank is None else rank
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", str(rank)))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout), **extra)
    _STATE["device"] = dev
    return dev


def maybe_initialize(device="cuda") -> torch.device:
    """What the entry points call: :func:`initialize` when ``WORLD_SIZE``
    (``torchrun``) asks for more than one rank, else ``device`` as
    ``resolve_device`` gives it."""
    if world_size_from_env() > 1 or dist.is_initialized():
        return initialize(device=device)
    return resolve_device(device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None


@contextlib.contextmanager
def rank0_stdout():
    """Printing on rank 0 only: the metric lines of a run over several
    ranks (every rank computes them) appear once."""
    if process_index() == 0:
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield


# ------------------------------------------------------------ collectives

def _staged(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` where the group's backend takes it: gloo reads host memory,
    nccl the rank's card."""
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        return t.cpu()
    if not t.is_cuda and backend == "nccl":
        return t.to(local_device())
    return t


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The reduction of ``t`` over ``group`` (a new tensor on t's device);
    every rank receives the same bits."""
    buf = _staged(t, group).clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) in group-rank order."""
    buf = _staged(t, group).contiguous()
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    return [o.to(t.device) for o in out]


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` as global rank ``src`` holds it, on every rank of ``group``."""
    buf = _staged(t, group).clone()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device)


def barrier(group=None) -> None:
    dist.barrier(group=group)


def broadcast_object(obj, src: int = 0, group=None):
    """A small picklable value as global rank ``src`` holds it, on every
    rank (a run id, a path)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class _GatherRows(torch.autograd.Function):
    """Every rank's ``x`` stacked [W, ...] in group-rank order; the
    backward keeps only this rank's slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.index = dist.get_rank(group)
        return torch.stack(all_gather(x.detach(), group=group))

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index], None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along a new leading axis
    [W, ...], in group-rank order, differentiable.

    Every rank then computes the same global loss from the gathered rows,
    so the backward returns ONLY this rank's slice of the gradient (not
    the sum of the W ranks' copies, which
    ``torch.distributed.nn.functional.all_gather`` returns): the parameter
    gradients each rank accumulates are its own rows' contribution, and
    :func:`all_reduce_grads` sums them into the one-process gradient."""
    return _GatherRows.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel layer (Megatron's pair, with
    :func:`reduce_from_model`): ``x`` itself forward, replicated over the
    ``model`` group; backward, the gradient each rank's column shard
    sends back is summed over ``group``, so every rank holds the
    gradient of the whole layer."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel layer: the ranks' partial products
    summed over the ``model`` group forward (every rank the same bits);
    backward, the gradient passes as it is, since each rank's partial
    entered the sum once."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_grads(params, group=None) -> None:
    """Sum the ``.grad`` of every parameter in ``params`` over ``group``,
    in place, through ONE packed ``all_reduce`` (a flat f32 buffer staged
    where the backend reads it).  A parameter without a gradient counts
    as zeros and keeps ``grad`` None when every rank's is None."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    has = torch.tensor([float(p.grad is not None) for p in params])
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        .to(dev, torch.float32) for p in params] + [has.to(dev)])
    flat = all_reduce(flat, group=group)
    has, off = flat[-len(params):].cpu(), 0
    for p, h in zip(params, has):
        n = p.numel()
        if h > 0:
            p.grad = flat[off:off + n].view_as(p).to(p.dtype)
        off += n


# ------------------------------------------------------- the row contract

def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def gather_counts(mesh, n_local: int) -> np.ndarray:
    """Every data-axis rank's row count (one tiny ``all_gather``)."""
    got = all_gather(torch.tensor([n_local], dtype=torch.int64),
                     group=mesh.data_group)
    return torch.cat(got).numpy()


def rows_from_process_local(mesh, local_rows, pad: bool = False,
                            device=None):
    """This rank's part of a global array sharded over the mesh's ``data``
    axis, from its own row shard (numpy or a tensor).

    ``pad=False`` (exact contract): every rank must hold the same row
    count; returns (local tensor, n_global_rows).  Uneven shares raise:
    do not hand-pad around it (zero rows would enter seeding and sums as
    valid points); use ``pad=True``, or trim to an even shard.

    ``pad=True`` (ragged contract, the fitters' and the encoder's): one
    count ``all_gather`` establishes every rank's share, each local slice
    zero-pads to the common width, and the return is (local tensor,
    valid_mask): a host bool [n_data * width] marking the real rows, the
    pads at the END of each rank's block, the same on every rank; None
    when no rank needed padding."""
    dev = mesh.device if device is None else torch.device(device)
    local = _as_tensor(local_rows, dev)
    n_local = local.shape[0]
    counts = gather_counts(mesh, n_local)
    if not pad:
        if (counts != n_local).any():
            raise ValueError(
                f"uneven multi-process layout: row counts {counts.tolist()} "
                "over the data axis; trim to an even shard, or call with "
                "pad=True (hand-padding would corrupt results: pads would "
                "count as valid rows)")
        return local, n_local * mesh.n_data
    width = max(int(counts.max()), 1)
    if width != n_local:
        local = torch.cat([local, local.new_zeros(
            (width - n_local,) + tuple(local.shape[1:]))])
    if (counts == width).all():
        return local, None
    valid = np.zeros(width * mesh.n_data, bool)
    for p, c in enumerate(counts):
        valid[p * width:p * width + int(c)] = True
    return local, valid


def local_valid(mesh, valid: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """This rank's block of a global valid mask (None stays None)."""
    if valid is None:
        return None
    width = len(valid) // mesh.n_data
    return valid[mesh.data_index * width:(mesh.data_index + 1) * width]


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """Three f64 sums of a leaf (its values, their squares, and each value
    by its position), enough to tell two copies apart."""
    f = t.detach().reshape(-1).double()
    pos = torch.arange(f.numel(), dtype=torch.float64, device=f.device)
    return torch.stack([f.sum(), (f * f).sum(), (f * pos).sum()]).cpu()


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for item in tree for v in _leaves(item)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    return [tree]


def replicate_to_mesh(mesh, tree):
    """A side input that every rank must hold in full (weights, labelled
    features, centers): each rank keeps its own copy and the call checks,
    with one ``all_gather`` of fingerprints, that all copies agree
    (raising if not): every rank loads the same weights instead of
    shipping them.  A torch module counts by its state dict.  Returns
    ``tree``."""
    leaves = [x for x in _leaves(tree)
              if isinstance(x, (torch.Tensor, np.ndarray))]
    if mesh is None or mesh.size == 1 or not leaves:
        return tree
    fp = torch.stack([_fingerprint(_as_tensor(x, mesh.device))
                      for x in leaves])
    copies = all_gather(fp)
    for r, other in enumerate(copies):
        if not torch.equal(other, copies[0]):
            raise ValueError(
                f"replicate_to_mesh: rank {r}'s copy differs from rank 0's "
                "(every rank must load the same side inputs)")
    return tree


def put_global(x, mesh, axis: Optional[str] = None, dim: int = 0):
    """This rank's part of a FULL value that every rank holds: the whole
    value when ``axis`` is None, else the contiguous slice of dimension
    ``dim`` that this rank's index on ``axis`` ("data" or "model") owns.
    The dimension must divide by the axis size."""
    t = _as_tensor(x, mesh.device)
    if axis is None:
        return t
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} ({size}) does not divide over "
                         f"the {n} ranks of the {axis!r} axis")
    return t.narrow(dim, i * (size // n), size // n).contiguous()


def host_fetch(local, mesh=None, axis: str = "data") -> np.ndarray:
    """The global array as host numpy on EVERY rank: this rank's row block
    gathered over ``axis`` (one ``all_gather``) and concatenated in axis
    order.  Blocks must have equal row counts (the ragged contract pads
    them).  Without a mesh, or on an axis of one rank, the local value."""
    t = local if isinstance(local, torch.Tensor) else torch.as_tensor(
        np.asarray(local))
    if mesh is None or mesh.axis_size(axis) == 1:
        return t.detach().cpu().numpy()
    return torch.cat([b.cpu() for b in all_gather(
        t.detach(), group=mesh.group(axis))]).numpy()


def share_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of contiguous equal shares of ``n`` rows over ``parts``
    (the last shares ragged or empty), as the JAX package's
    ``extract_features_pod`` and ``_pod_shard`` cut them."""
    share = -(-n // parts)
    lo = min(index * share, n)
    return lo, min(lo + share, n)
