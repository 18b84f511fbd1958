"""Env-axis data parallelism over `torch.distributed` (counterpart of
`pbhc_tpu/parallel/mesh.py`).

JAX places the env state on the `"env"` axis of a device mesh and replicates
everything else (`shard_train_state`); XLA then computes every reduction over
the global env axis and inserts the gradient all-reduce of the replicated
update. Here each rank is a process that owns `num_envs / world` envs and
sees only those, so every reduction that JAX gets for free is written out
through the rank's `EnvShard`:
- the env step's replicated scalars (reset counts, the average episode length
  behind the curricula, the per-motion fail EMA, the adaptive-sigma EMA, the
  env logs) are global sums, or means over the global env count;
- a learner's minibatch loss is `(local sum) / (global minibatch size)`, and
  its gradients are summed across ranks before the clip and Adam, so that the
  global-norm clip sees the global gradient;
- the advantage mean and std, the KL behind the adaptive lr and every logged
  mean are global, so that every rank takes the same lr.

A rank's flat sample index is `t * local_envs + n`, the global one
`t * num_envs + (offset + n)`; `local_rows` maps global minibatch indices to
the rows a rank holds. Sum-reductions pack their tensors into one buffer and
make one `all_reduce` per call site: float64 by default, which keeps the
env step's int64 counts exact and adds its float32 sums without loss before
they are cast back; the learners reduce their gradients in float32, as DDP
does.

An `EnvShard` without a process group is the single-process run: it issues
no collective and every reduction is the plain one of the one-rank code.
A group of one rank (`nccl` on one card) issues its collectives all the same.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

_RANK_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class EnvShard:
    """One rank's share of the env axis: `world` ranks, `num_envs` envs in all,
    this rank's `local_envs` starting at `offset`. `group` is None in a single
    process."""

    num_envs: int
    world: int = 1
    rank: int = 0
    group: object = None
    backend: str | None = None

    def __post_init__(self):
        if self.num_envs % self.world:
            raise ValueError(f"world size {self.world} must divide num_envs={self.num_envs}")

    @property
    def local_envs(self) -> int:
        return self.num_envs // self.world

    @property
    def offset(self) -> int:
        return self.rank * self.local_envs

    @property
    def distributed(self) -> bool:
        return self.group is not None

    # ---------------------------------------------------------- random draws
    def generators(self, seed: int, device):
        """(per-rank, shared) generators on `device`. The shared one is seeded
        `seed` on every rank (minibatch permutations, draws shared by every
        env); the per-rank one draws what differs per env. With one rank they
        are one generator seeded `seed`, so that every draw stays the
        single-process one."""
        shared = torch.Generator(device=device)
        shared.manual_seed(int(seed))
        if self.world == 1:
            return shared, shared
        own = torch.Generator(device=device)
        own.manual_seed(int(seed) + (self.rank + 1) * _RANK_SEED_STRIDE)
        return own, shared

    # ------------------------------------------------------------ reductions
    def _reduce(self, buf: torch.Tensor, op) -> torch.Tensor:
        # gloo is the backend of the CPU and of ranks that share one card; its
        # CUDA path stages through the host, so on gloo the packed buffer is
        # always copied to the host and back (one copy each way per call site)
        if self.backend == "gloo" and buf.device.type != "cpu":
            host = buf.cpu()
            dist.all_reduce(host, op=op, group=self.group)
            return host.to(buf.device)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def _packed(self, tensors, op, dtype):
        if not self.distributed:
            return list(tensors)
        tensors = [torch.as_tensor(t) for t in tensors]
        device = next((t.device for t in tensors if t.device.type != "cpu"), torch.device("cpu"))
        buf = torch.cat([t.detach().reshape(-1).to(device, dtype) for t in tensors])
        buf = self._reduce(buf, op)
        out, i = [], 0
        for t in tensors:
            out.append(buf[i:i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def all_sum(self, tensors, dtype=torch.float64):
        """The sums over ranks of `tensors` (a list), by one all-reduce of a
        `dtype` buffer; the tensors themselves in a single process."""
        return self._packed(tensors, dist.ReduceOp.SUM, dtype)

    def all_max(self, tensors):
        """The maxima over ranks of `tensors`, by one all-reduce."""
        return self._packed(tensors, dist.ReduceOp.MAX, torch.float64)

    def env_means(self, tensors):
        """Global means over the env axis of per-env tensors ([local_envs, ...]
        -> [...]), by one all-reduce: every rank holds the same number of envs,
        so the global mean is the sum of the local means over `world`."""
        return self.all_sum([t.to(torch.float32).mean(0) / self.world for t in tensors])

    def share(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """This rank's share of the mean of `x` over a global batch of `rows`
        rows ([local rows, ...]): `x.sum() / (rows * row width)`, whose sum
        over ranks is the global mean; `x.mean()` in a single process."""
        if not self.distributed:
            return x.mean()
        return x.sum() / (rows * math.prod(x.shape[1:]))

    def share0(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """This rank's share of the mean over axis 0 of a global batch of
        `rows` rows ([local rows, ...] -> [...])."""
        return x.mean(0) if not self.distributed else x.sum(0) / rows

    def global_mean0(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """The mean over axis 0 of a global batch of `rows` rows, across every
        rank, without gradient."""
        if not self.distributed:
            return x.mean(0)
        (s,) = self.all_sum([x.detach().sum(0)])
        return s / rows

    def mean_std(self, x: torch.Tensor):
        """Global mean and population std of `x` over every rank's elements
        (two all-reduces: the mean, then the squared deviations from it)."""
        if not self.distributed:
            return x.mean(), x.std(correction=0)
        s, n = self.all_sum([x.sum(), torch.tensor(float(x.numel()), device=x.device)])
        mean = s / n
        (ss,) = self.all_sum([((x - mean) ** 2).sum()])
        return mean, torch.sqrt(ss / n)

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over every rank's elements."""
        if not self.distributed:
            return x.mean()
        s, n = self.all_sum([x.sum(), torch.tensor(float(x.numel()), device=x.device)])
        return s / n

    # ---------------------------------------------------------------- layout
    def local_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """The local flat rows (`t * local_envs + n`) of this rank's samples
        among the global flat indices `idx` (`t * num_envs + env`), in the
        order of `idx`; `idx` itself in a single process."""
        if not self.distributed:
            return idx
        env = idx % self.num_envs
        mine = (env >= self.offset) & (env < self.offset + self.local_envs)
        return ((idx // self.num_envs) * self.local_envs + env - self.offset)[mine]


def backend_for(device, world: int) -> str:
    """`nccl` when each rank on a host owns its own GPU; `gloo` on the CPU and
    when several ranks share one card (NCCL refuses two ranks on one device)."""
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda" and per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int | None = None):
    """The rank's device: a bare `cuda` becomes `cuda:<local rank % cards>`
    (ranks beyond the card count share cards); any other device as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if rank is None else rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_mesh(num_envs: int, device="cuda", world: int | None = None, rank: int | None = None,
              init_method: str | None = None) -> EnvShard:
    """This process's shard of the env axis (`mesh.py:22`). Joins the process
    group that is initialised already (a caller's, or `torchrun`'s through
    `env://` when `WORLD_SIZE` is set), or sets one up from `world`, `rank`
    and `init_method`; with neither, a single process without collectives.
    `world` must divide `num_envs`, as JAX asserts at `train.py:236-237`."""
    if not dist.is_initialized():
        if world is None and "WORLD_SIZE" in os.environ:
            world, rank, init_method = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://"
        if world is None:
            return EnvShard(int(num_envs))
        if num_envs % world:
            raise ValueError(f"world size {world} must divide num_envs={num_envs}")
        backend = backend_for(device, world)
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device, rank))
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank)
    return EnvShard(int(num_envs), dist.get_world_size(), dist.get_rank(), dist.group.WORLD, dist.get_backend())


def _rank_entry(rank, fn, world, backend, store, results, threads, args):
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), backend: str = "gloo", timeout: float | None = 600.0,
              store_dir=None, threads: int | None = None) -> list:
    """`fn(*args)` in `world` fresh processes (the `spawn` start method), each
    a rank of one process group of `backend` over a file store in a new
    directory under `store_dir` (default: the temp dir), with `threads`
    intra-op threads each (default: the host's cores split among the ranks;
    more oversubscribe the cores, where the ranks' idle threads spin against
    each other). Returns the ranks' return values in rank order. Raises if a
    rank raises, or after `timeout` seconds (None: no limit), when every rank
    still alive is terminated."""
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    store_root = tempfile.mkdtemp(prefix="pbhc_ranks_", dir=store_dir)
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(_rank_entry, args=(fn, world, backend, os.path.join(store_root, "store"),
                                                results, threads, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout

    def late():
        return deadline is not None and time.monotonic() > deadline

    out = {}
    try:
        while len(out) < world:
            try:
                rank, value = results.get(timeout=0.5)
                out[rank] = value
                continue
            except queue.Empty:
                pass
            if ctx.join(timeout=0) and results.empty():     # raises if a rank raised
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} ended without a result")
            if late():
                raise TimeoutError(f"{world} ranks did not finish within {timeout:.0f} s")
        while not ctx.join(timeout=None if deadline is None else max(1.0, deadline - time.monotonic())):
            if late():
                raise TimeoutError(f"{world} ranks did not exit within {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
        shutil.rmtree(store_root, ignore_errors=True)
    return [out[r] for r in range(world)]


def _train_state_tensors(ts):
    """Every tensor of a train state that replicates: the networks'
    parameters, the optimizers' moments, the lr (`mesh.py:48-59`: all fields
    but `env_state` and `obs`)."""
    out = []
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if f.name in ("env_state", "obs"):
            continue
        if isinstance(v, nn.Module):
            out += [p.data for p in v.parameters()]
        elif isinstance(v, torch.Tensor):
            out.append(v)
        elif hasattr(v, "mu") and hasattr(v, "nu"):
            out += [*v.mu, *v.nu]
    return out


@torch.no_grad()
def shard_train_state(ts, shard: EnvShard):
    """Rank 0's parameters, optimizer moments and lr broadcast to every rank
    (one packed broadcast), so that the ranks start identical; the env state
    and observations stay each rank's own (`mesh.py:48`). Returns `ts`."""
    if not shard.distributed:
        return ts
    tensors = _train_state_tensors(ts)
    device = tensors[0].device
    buf = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    if shard.backend == "gloo" and device.type != "cpu":   # see EnvShard._reduce
        host = buf.cpu()
        dist.broadcast(host, src=0, group=shard.group)
        buf = host.to(device)
    else:
        dist.broadcast(buf, src=0, group=shard.group)
    i = 0
    for t in tensors:
        t.copy_(buf[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return ts


def replica_checksum(ts) -> torch.Tensor:
    """A float64 checksum of the replicated tensors of a train state."""
    return sum(t.detach().to(torch.float64).sum() * (i + 1) for i, t in enumerate(_train_state_tensors(ts)))


def check_replicas(ts, shard: EnvShard) -> float:
    """Raise unless every rank holds bit-identical replicated state (the
    checksums' maximum and minimum over ranks agree); returns the checksum."""
    c = replica_checksum(ts)
    if not shard.distributed:
        return float(c)
    hi, lo = shard.all_max([c, -c])
    if float(hi) != -float(lo):
        raise RuntimeError(f"rank {shard.rank}: replicated train state differs across ranks "
                           f"(checksums {float(-lo)!r} .. {float(hi)!r})")
    return float(c)
