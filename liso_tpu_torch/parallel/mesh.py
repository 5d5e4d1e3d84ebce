"""Data parallelism over a torch.distributed process group (port of
liso_tpu/parallel/mesh.py).

The JAX package shards the batch on a 1D 'data' mesh axis and jits the
whole step over it: every reduction over the batch (batch-norm statistics,
loss denominators, the threshold histogram, the gradient) still sees the
global batch, since XLA inserts the cross-device sums. Here the batch is
split over the ranks of a process group (`shard_batch`), the state is
replicated from rank 0 (`replicate`), and each batch-wide reduction calls
one of the sums below, so that one step on the rank's shard gives every
rank the one-process step on the full batch, up to reduction order.

The rule for a loss: each rank computes its SHARE, the local numerator
over the global (detached) denominator, and back-propagates it; the shares
sum to the full batch's loss, and the gradients, summed once over the
ranks (`all_sum_`), to its gradient. A sum that the loss or a batch norm
differentiates through is `batch_sum`, whose backward sums the cotangents
over the ranks. (A loss that every rank computed whole would count each
term world-size times.)

Backends are chosen by the caller, never silently: `nccl` for one card per
rank, `gloo` for the CPU and for several ranks on one card (NCCL refuses
two ranks on one device). Gloo's sums of CUDA tensors are staged through
host memory here. `RankProcesses` runs a function on every rank of a new
group in spawned processes; the process group lives in a file store, so no
port is needed.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from liso_tpu_torch.utils import trace

BACKENDS = ("gloo", "nccl")
# how long a collective waits for the other ranks before it raises
GROUP_TIMEOUT_S = 600.0

def make_mesh(world_size: int, rank: int, backend: str,
              store_dir) -> dist.ProcessGroup:
    """Join the default process group as `rank` of `world_size` and return
    it. Its rendezvous is a FileStore in `store_dir` (the same directory
    for every rank, fresh for each group). With `nccl` this process takes
    card `rank`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of world size {world_size}")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    store = dist.FileStore(str(Path(store_dir) / "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.group.WORLD


def destroy_mesh() -> None:
    dist.destroy_process_group()


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over the group's ranks (a `mesh.collective` span)."""
    with trace.span("mesh.collective"):
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
    return t


def _broadcast_(t: torch.Tensor, group) -> None:
    """Rank 0's `t` into every rank's `t`, in place (a `mesh.collective`
    span)."""
    with trace.span("mesh.collective"):
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = t.cpu()
            dist.broadcast(host, src=0, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t, src=0, group=group)


class _BatchSum(torch.autograd.Function):
    """The sum over the ranks, whose cotangent is the sum over the ranks of
    the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


def batch_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the group's ranks, differentiably (every rank's `x`
    receives the summed cotangent); `x` itself without a group."""
    return x if group is None else _BatchSum.apply(x, group)


def batch_total(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the group's ranks, detached: counts and loss
    denominators, whose gradient the loss does not take. `x` itself
    without a group."""
    return x if group is None else _all_reduce_(x.detach().clone(), group)


def batch_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rank's share of the mean of every element of `x` over the
    group's shards: its sum over the global count. `x.mean()` without a
    group."""
    if group is None:
        return x.mean()
    n = batch_total(torch.tensor(x.numel(), device=x.device), group)
    return x.sum() / n


def all_sum_(tensors, group) -> list:
    """Sum a list of tensors over the group in ONE collective (flattened
    per dtype); returns the summed tensors, in order."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(out):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        _all_reduce_(flat, group)
        off = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[off:off + n].view_as(out[i])
            off += n
    return out


def total_metrics(metrics: dict, group) -> dict:
    """Each 0-dim tensor of `metrics` (the ranks' shares of a loss term)
    summed over the group in one collective, detached."""
    keys = list(metrics)
    summed = batch_total(torch.stack([metrics[k].detach().float()
                                      for k in keys]), group)
    return dict(zip(keys, summed.unbind()))


def map_tree(fn, tree):
    """`fn` on every tensor or array leaf of nested dicts, lists, tuples,
    NamedTuples and dataclasses; other leaves (None, numbers) are kept."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tree(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_batch(group, batch: Any) -> Any:
    """This rank's contiguous rows of the leading (batch) dim of every
    tensor or array in `batch`. Raises when a leading dim is not divisible
    by the world size, as the JAX mesh requires."""
    w, r = dist.get_world_size(group), dist.get_rank(group)

    def rows(x):
        if x.ndim == 0 or x.shape[0] % w:
            raise ValueError(f"leading dim of a {tuple(x.shape)} leaf is not "
                             f"divisible by the world size {w}")
        n = x.shape[0] // w
        return x[r * n:(r + 1) * n]

    return map_tree(rows, batch)


def replicate(group, obj: Any) -> Any:
    """Broadcast rank 0's tensors into every rank's, in place: a module's
    parameters and buffers, or every tensor of a (nested) state such as a
    trainer's `state_dict()` (optimizer moments, the threshold state).
    Returns `obj`."""
    if isinstance(obj, nn.Module):
        obj = obj.state_dict()

    def bcast(t):
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                _broadcast_(t, group)
        return t

    map_tree(bcast, obj)
    return obj


# ---------------------------------------------------------------------------
# Ranks in spawned processes
# ---------------------------------------------------------------------------
def _rank_main(fn, rank, world_size, backend, workdir, args):
    """One spawned rank: join the group, run fn(group, *args), save its
    result (or the traceback) under `workdir`."""
    workdir = Path(workdir)
    try:
        group = make_mesh(world_size, rank, backend, workdir)
        try:
            out = fn(group, *args)
        finally:
            destroy_mesh()
        torch.save(out, workdir / f"rank{rank}.pt")
    except Exception:  # the boundary of the rank: report, then exit 1
        (workdir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


class RankProcesses:
    """`fn(group, *args)` on every rank of a new `world_size` group, one
    spawned process each, started at construction. `fn` must be
    importable (a module-level function) and return a picklable result.
    `join()` waits and returns the results in rank order; when a rank
    fails or the time runs out, it stops every rank and raises."""

    def __init__(self, fn: Callable, world_size: int, args=(), *,
                 backend: str, workdir, timeout_s: float = 900.0):
        import multiprocessing

        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        if any(self.workdir.iterdir()):
            raise ValueError(f"{self.workdir} is not empty: a group needs a "
                             "fresh store")
        self.world_size = world_size
        self.deadline = time.monotonic() + timeout_s
        ctx = multiprocessing.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main,
                        args=(fn, r, world_size, backend, str(self.workdir),
                              tuple(args)))
            for r in range(world_size)
        ]
        for p in self.procs:
            p.start()

    def stop(self):
        """End every rank still running."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()

    def join(self) -> list:
        try:
            while any(p.exitcode is None for p in self.procs):
                if any(p.exitcode not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(
                        f"ranks still running after their time limit "
                        f"(exit codes {[p.exitcode for p in self.procs]})")
                time.sleep(0.05)
            errors = {r: (self.workdir / f"rank{r}.err").read_text()
                      if (self.workdir / f"rank{r}.err").exists() else
                      f"exit code {p.exitcode}"
                      for r, p in enumerate(self.procs)
                      if p.exitcode not in (None, 0)}
            if errors:
                raise RuntimeError("ranks failed:\n" + "\n".join(
                    f"--- rank {r}:\n{e}" for r, e in errors.items()))
        finally:
            self.stop()
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world_size)]

