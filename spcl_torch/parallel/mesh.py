"""Process group, collectives and a local launcher: the distributed backend.

The counterpart of `spcl_tpu/parallel/mesh.py`. There a 1-D `data` mesh spans
the chips of one program; here every rank is one process with its own copy of
the model, `torch.distributed` underneath. Every rank builds the same GLOBAL
host batch (the samplers are seed-deterministic) and the same global random
draws, and computes on its own rows (`shard_rows`).

Gradient convention (held by tests/test_torch_parallel_*.py: R ranks equal
one process). Each rank's loss is written so that the SUM over ranks of the
ranks' parameter gradients is the gradient of the global loss, and parameter
gradients are summed (`all_reduce_grads`), never averaged:

- a loss that is a global mean is computed as this rank's partial sum over
  the GLOBAL count (`training/steps.py::_masked_ce`, `global_count`); a hook
  returns it through `global_sum`, whose value is the global loss on every
  rank and whose gradient is the rank's share's;
- a loss that every rank computes in full from gathered operands enters the
  backward with 1/R of its cotangent (`grad_share`), and the differentiable
  collectives transpose as the sum convention demands: `all_gather_cat`
  backward is a reduce-scatter (sum), `all_reduce_sum` backward is an
  all-reduce (sum).

Without a process group every function here is the single-process identity
(as `spcl_tpu`'s `_build_mesh` returns None on one device). With a group of
one rank the collectives do run.

Backends: `nccl` where every rank has a card of its own, `gloo` otherwise
(CPU ranks, or several ranks sharing one card). gloo moves host memory, so a
CUDA tensor is staged through the host for the collective only; no rank
computes on the CPU because of it.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "SPCL_COORDINATOR"
ENV_NUM_PROCESSES = "SPCL_NUM_PROCESSES"
ENV_PROCESS_ID = "SPCL_PROCESS_ID"


# ------------------------------------------------------------------ the group
def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def on_master() -> bool:
    return rank() == 0


def is_rank_process() -> bool:
    """True when the environment says this process is one rank of a run."""
    return ENV_PROCESS_ID in os.environ and ENV_COORDINATOR in os.environ


def rank_device(device) -> torch.device:
    """The device this rank computes on: CUDA ranks take card
    rank % device_count (several ranks share a card when there are fewer
    cards than ranks); anything else passes through."""
    device = torch.device(device)
    if device.type == "cuda" and active():
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return device


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda",
                           timeout_s: float = 600.0) -> int:
    """Join this process to the run's process group. Arguments default to the
    SPCL_COORDINATOR ("host:port") / SPCL_NUM_PROCESSES / SPCL_PROCESS_ID
    environment variables; with no coordinator this is the single-process
    no-op. Idempotent. Returns the world size. `timeout_s` bounds every
    collective: a rank that never arrives fails the others instead of hanging
    them."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if coordinator is None or active():
        return world_size()
    if num_processes is None:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None:
        process_id = int(os.environ[ENV_PROCESS_ID])
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device 'cuda' requested but no CUDA device is visible")
        torch.cuda.set_device(process_id % cards)
        if cards >= num_processes:
            backend = "nccl"  # NCCL refuses two ranks on one card
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return world_size()


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def requested_ranks(spec, device) -> int:
    """Ranks that `Trainer.mesh=spec` asks a launcher to start: 0 / None /
    False -> 1 (no mesh), "auto" -> one per visible card, N -> N."""
    if spec is None or spec is False or spec == 0:
        return 1
    if spec is True or str(spec).lower() == "auto":
        return max(torch.cuda.device_count(), 1) if torch.device(device).type == "cuda" else 1
    return int(spec)


# ------------------------------------------------------------------ collectives
def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ranks of a contiguous tensor."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenation along axis 0 of every rank's `t` (equal shapes), in rank
    order."""
    src = t.contiguous()
    if _staged(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(t.device)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter (sum) written as all-reduce + own slice: gloo has no
        # reduce-scatter and the gathered operands here are small
        g = _all_reduce_sum_(g.contiguous().clone(), ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum_(g.contiguous().clone(), ctx.group), None


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable gather-and-concatenate along axis 0, rank order."""
    if not active():
        return x
    if x.requires_grad:
        return _AllGatherCat.apply(x, group)
    return _all_gather(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over ranks (a new tensor)."""
    if not active():
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce_sum_(x.detach().contiguous().clone(), group)


def grad_share(loss: torch.Tensor, group=None) -> torch.Tensor:
    """`loss` unchanged in value, carrying 1/R of its cotangent: for a loss
    that all R ranks compute in full, so that the ranks' gradients sum to the
    gradient of one copy."""
    r = world_size(group)
    if r == 1:
        return loss
    return loss.detach() + (loss - loss.detach()) / r


def global_sum(share: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of `share` in value (the same bits on every rank),
    with the gradient of this rank's `share` alone: for a rank's partial sum
    of a global mean, so that the value is the global loss and the ranks'
    gradients sum to its gradient."""
    if not active():
        return share
    return all_reduce_sum(share.detach(), group) + (share - share.detach())


def global_count(mask: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `mask` over every rank's rows (no gradient): the count a
    masked mean over the global batch divides by."""
    return all_reduce_sum(mask.detach().sum(), group)


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of `x` concatenated in rank order, without a
    gradient (mixup's images and targets)."""
    return all_gather_cat(x.detach(), group)


def all_reduce_grads(params: Sequence[torch.Tensor], group=None) -> None:
    """Sum the `.grad` of `params` over ranks, in one collective."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce_sum_(flat, group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite every tensor with rank `src`'s values (weights and buffers
    at start-up, so that the replicas begin equal whatever seeded them)."""
    if not active():
        return
    for t in tensors:
        if _staged(t, group):
            host = t.detach().cpu()
            dist.broadcast(host, src=src, group=group)
            t.detach().copy_(host)
        else:
            dist.broadcast(t.detach(), src=src, group=group)


def host_barrier(group=None) -> None:
    """Every rank waits here for the others (a non-master rank must not read
    a file before the master wrote it). Bounded by the group's timeout."""
    if not active():
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


# ------------------------------------------------------------------ batches
def pad_multiple(idx: np.ndarray, n: int) -> np.ndarray:
    """Right-pad the last axis of an index array with -1 to a multiple of
    `n`; pad entries carry valid=0 through every loss and meter."""
    rem = (-idx.shape[-1]) % n
    if rem == 0:
        return idx
    pad = np.full(idx.shape[:-1] + (rem,), -1, idx.dtype)
    return np.concatenate([idx, pad], axis=-1)


def shard_rows(tree: Any, n_global: int, group=None) -> Any:
    """This rank's rows of a global batch: every tensor or array in `tree`
    (dicts, tuples and lists are walked) whose axis 0 has `n_global` entries
    is cut to rows [rank * n_local, (rank + 1) * n_local)."""
    r = world_size(group)
    if r == 1:
        return tree
    if n_global % r:
        raise ValueError(f"a global batch of {n_global} does not divide over {r} ranks "
                         "(pad it with pad_multiple)")
    n_local = n_global // r
    lo = rank(group) * n_local

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v) for v in x)
        if hasattr(x, "shape") and len(x.shape) >= 1 and x.shape[0] == n_global:
            return x[lo:lo + n_local]
        return x

    return cut(tree)


# ------------------------------------------------------------------ local launcher
def free_port() -> int:
    """A TCP port of this host that is free now (for a coordinator address)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(process_id, n, port, device, group_timeout_s, fn, args, results):
    os.environ[ENV_COORDINATOR] = f"localhost:{port}"
    os.environ[ENV_NUM_PROCESSES] = str(n)
    os.environ[ENV_PROCESS_ID] = str(process_id)
    try:
        initialize_distributed(device=device, timeout_s=group_timeout_s)
        out = fn(*args)
        host_barrier()
        results.put((process_id, True, out))
    except BaseException:
        results.put((process_id, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn_local(n: int, fn: Callable, args: tuple = (), *, device="cuda",
                timeout_s: float = 600.0, collective_timeout_s: float = 600.0) -> List[Any]:
    """Run `fn(*args)` in `n` local ranks (new processes, `spawn` start
    method), each with its SPCL_* environment and its process group up, and
    return the ranks' results in rank order. `fn` must be importable (it is
    pickled by its path) and return something picklable. A rank's exception
    is re-raised here with its traceback; a rank that dies silently or is not
    done after `timeout_s` seconds fails the call, and a collective that a
    rank never reaches fails the waiting ranks after `collective_timeout_s`;
    the other ranks are then terminated, so nothing outlives the call."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(i, n, port, str(device), collective_timeout_s, fn, args, results),
                         daemon=True)
             for i in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    done, failure = {}, None
    try:
        while len(done) < n:
            try:
                process_id, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    failure = f"ranks {sorted(set(range(n)) - set(done))} not done after " \
                              f"{timeout_s:.0f} s"
                    break
                dead = [i for i, p in enumerate(procs)
                        if i not in done and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # its report may still be in the pipe: one more look
                    process_id, ok, out = results.get(timeout=2.0)
                except queue.Empty:
                    failure = f"rank {dead[0]} exited with code " \
                              f"{procs[dead[0]].exitcode} and no report"
                    break
            if not ok:
                failure = f"rank {process_id} failed:\n{out}"
                break
            done[process_id] = out
        for p in procs:
            p.join(timeout=0 if failure else max(deadline - time.monotonic(), 1.0))
            if p.is_alive() and failure is None:
                failure = f"rank process {p.pid} still alive after {timeout_s:.0f} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
    if failure is not None:
        raise RuntimeError(f"spawn_local({n} ranks): {failure}")
    return [done[i] for i in range(n)]


def run_ranks(spec, fn: Callable, args: tuple = (), *, device="cuda",
              timeout_s: float = 7 * 24 * 3600.0) -> Any:
    """The entry points' launcher: `fn(*args)` in this process, or, when
    `Trainer.mesh=spec` asks for N > 1 ranks and this process is not already
    one rank of a run (`is_rank_process`), in N local ranks (`spawn_local`),
    returning rank 0's result. `fn` joins the process group itself
    (`initialize_distributed`, a no-op without the SPCL_* variables)."""
    n = requested_ranks(spec, device)
    if n > 1 and not is_rank_process():
        return spawn_local(n, fn, args, device=device, timeout_s=timeout_s)[0]
    return fn(*args)
