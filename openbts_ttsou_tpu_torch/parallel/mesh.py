"""The (chan, time) grid of shards and the collectives the sharded
pipelines run over it.

Port of `openbts_ttsou_tpu/parallel/mesh.py`. The JAX package lays a
`jax.sharding.Mesh` over devices and lets XLA place the collectives; here
the grid is explicit. Each shard has a device, and several shards may
share one (four shards on one card in one process). Across processes,
each rank owns a contiguous run of shards, in row-major (chan, time)
order, that covers a rectangle of the grid, and reaches the other ranks'
shards through `torch.distributed`.

A collective takes one value per local shard, a dict keyed by `Shard`,
and returns one per local shard. Values of shards in one process combine
with tensor ops; values of other ranks arrive by point-to-point sends
(`shift`) or one all-gather over the world (`all_reduce`, `all_gather`).
Every rank calls the same collectives in the same order, as an SPMD
program does. Each call adds to `traffic` the bytes that land on one
shard, the output of the op, as the JAX package's collective inventory
counts them per device (`tools/collective_inventory.py`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


def mesh_factors(n: int) -> tuple[int, int]:
    """Factor n shards into (chan, time) axes: prefer a 2-ish time axis
    (halo rings are cheap; channel parallelism is embarrassingly
    parallel, so give it the larger factor)."""
    if n <= 1:
        return (1, 1)
    for t in (2, 4, 3, n):
        if n % t == 0:
            return (n // t, t)
    return (n, 1)


class Shard(NamedTuple):
    """One cell of the grid: its row-major index, its coordinates, its
    device and the rank that holds it."""

    index: int
    chan: int
    time: int
    device: torch.device
    rank: int


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the backends carry it: complex as its real view, bool
    as uint8."""
    if t.is_complex():
        return torch.view_as_real(t.contiguous())
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t.contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        w = torch.view_as_complex(w.contiguous())
    return w.to(device=like.device, dtype=like.dtype)


class Mesh:
    """A (chan, time) grid of shards.

    shape: (n_chan_shards, n_time_shards); devices and ranks list one
    entry per shard in row-major order (ranks default to this process).
    `shape` then reads as the mapping {axis name: size}, as a JAX mesh's
    does."""

    def __init__(self, shape: tuple[int, int],
                 devices: Sequence, ranks: Optional[Sequence[int]] = None,
                 axis_names: tuple[str, str] = ("chan", "time")):
        c, t = shape
        n = c * t
        if len(devices) != n:
            raise ValueError(f"mesh {shape} needs {n} devices, "
                             f"got {len(devices)}")
        self.rank, self.world_size = _world()
        ranks = [self.rank] * n if ranks is None else list(ranks)
        if len(ranks) != n or sorted(ranks) != ranks:
            raise ValueError("each rank must own a contiguous run of shards")
        if max(ranks) >= self.world_size:
            raise ValueError(f"ranks {sorted(set(ranks))} need a process "
                             f"group of {max(ranks) + 1}")
        self.axis_names = tuple(axis_names)
        self.grid = (c, t)
        self.shape = dict(zip(self.axis_names, self.grid))
        self.shards = tuple(Shard(i, i // t, i % t, torch.device(devices[i]),
                                  ranks[i]) for i in range(n))
        self.local = tuple(s for s in self.shards if s.rank == self.rank)
        if not self.local:
            raise ValueError(f"rank {self.rank} holds no shard")
        cs = sorted({s.chan for s in self.local})
        ts = sorted({s.time for s in self.local})
        if len(cs) * len(ts) != len(self.local):
            raise ValueError("a rank's shards must cover a rectangle of "
                             "the grid")
        self.box = (range(cs[0], cs[-1] + 1), range(ts[0], ts[-1] + 1))
        counts = [ranks.count(r) for r in range(self.world_size)]
        self._uniform = len(set(counts)) == 1
        # per collective kind: [calls, bytes that landed on one shard]
        self.traffic: Dict[str, list] = {}

    # -- geometry ---------------------------------------------------------
    def coord(self, shard: Shard, axis: str) -> int:
        return shard.chan if axis == self.axis_names[0] else shard.time

    def at(self, chan: int, time: int) -> Shard:
        return self.shards[chan * self.grid[1] + time]

    def line(self, shard: Shard, axis: str) -> list[Shard]:
        """The shards sharing `shard`'s other coordinate, in order along
        `axis`."""
        if axis == self.axis_names[0]:
            return [self.at(c, shard.time) for c in range(self.grid[0])]
        return [self.at(shard.chan, t) for t in range(self.grid[1])]

    def _count(self, kind: str, nbytes: int) -> None:
        entry = self.traffic.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += nbytes

    def reset_traffic(self) -> None:
        self.traffic = {}

    def _crosses_ranks(self, axis: str) -> bool:
        return any(len({s.rank for s in self.line(sh, axis)}) > 1
                   for sh in self.shards)

    # -- collectives ------------------------------------------------------
    def shift(self, values: Dict[Shard, torch.Tensor], axis: str,
              step: int) -> Dict[Shard, Optional[torch.Tensor]]:
        """Move each shard's value `step` places along `axis` (no wrap):
        shard k receives the value of shard k − step, or None where that
        is off the grid. Values must have one shape and dtype."""
        n = self.shape[axis]
        out: Dict[Shard, Optional[torch.Tensor]] = {}
        ops = []
        pending = []
        # every rank walks the same edge list in the same order, so the
        # sends and receives between two ranks pair up in order
        for dst in self.shards:
            k = self.coord(dst, axis) - step
            if not 0 <= k < n:
                if dst.rank == self.rank:
                    out[dst] = None
                continue
            src = self.line(dst, axis)[k]
            if src.rank == self.rank and dst.rank == self.rank:
                out[dst] = values[src].to(dst.device)
            elif src.rank == self.rank:
                ops.append(dist.P2POp(dist.isend, self._wire_out(values[src]),
                                      dst.rank, tag=dst.index))
            elif dst.rank == self.rank:
                like = values[dst]
                buf = torch.empty_like(_to_wire(like),
                                       device=self._wire_device(like))
                ops.append(dist.P2POp(dist.irecv, buf, src.rank,
                                      tag=dst.index))
                pending.append((dst, buf, like))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, buf, like in pending:
            out[dst] = _from_wire(buf, like)
        if n > 1:
            first = next(iter(values.values()))
            self._count("permute", first.numel() * first.element_size())
        return out

    def all_reduce(self, values: Dict[Shard, torch.Tensor], axis: str,
                   op: str) -> Dict[Shard, torch.Tensor]:
        """Sum (`op="sum"`) or maximum (`"max"`) of the values along
        `axis`, to every shard of the line."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce: no op {op!r}")
        lines = self._gather_lines(values, axis)
        out = {}
        for s, vals in lines.items():
            stacked = torch.stack(vals)
            out[s] = stacked.sum(0) if op == "sum" else stacked.amax(0)
        first = next(iter(values.values()))
        self._count("all-reduce", first.numel() * first.element_size())
        return out

    def all_gather(self, values: Dict[Shard, torch.Tensor],
                   axis: str) -> Dict[Shard, torch.Tensor]:
        """The values of the line along `axis`, stacked in order
        ([n_axis, ...]) on every shard of the line."""
        out = {s: torch.stack(vals)
               for s, vals in self._gather_lines(values, axis).items()}
        first = next(iter(out.values()))
        self._count("all-gather", first.numel() * first.element_size())
        return out

    # -- transport --------------------------------------------------------
    def _wire_device(self, like: torch.Tensor) -> torch.device:
        """Where a buffer for the process group lives: the shard's card
        under NCCL, the CPU under gloo."""
        if dist.get_backend() == "nccl":
            return like.device
        return torch.device("cpu")

    def _wire_out(self, t: torch.Tensor) -> torch.Tensor:
        return _to_wire(t).to(self._wire_device(t))

    def _gather_lines(self, values: Dict[Shard, torch.Tensor], axis: str
                      ) -> Dict[Shard, list]:
        """For each local shard, the values of its line along `axis` on
        its device. Lines within this process read the local values;
        otherwise every rank all-gathers its local values once."""
        if self._crosses_ranks(axis):
            if not self._uniform:
                raise ValueError("collectives across ranks need the same "
                                 "number of shards on every rank")
            mine = torch.stack([_to_wire(values[s]) for s in self.local])
            mine = mine.to(self._wire_device(values[self.local[0]]))
            parts = [torch.empty_like(mine) for _ in range(self.world_size)]
            dist.all_gather(parts, mine)
            owned = {r: [s for s in self.shards if s.rank == r]
                     for r in range(self.world_size)}
            like = values[self.local[0]]
            everyone = {s: _from_wire(parts[r][i], like)
                        for r, ss in owned.items() for i, s in enumerate(ss)}
        else:
            everyone = values
        return {s: [everyone[o].to(s.device) for o in self.line(s, axis)]
                for s in self.local}


def make_mesh(n_shards: Optional[int] = None, device="cuda",
              axis_names: tuple[str, str] = ("chan", "time")) -> Mesh:
    """A (chan, time) mesh of `n_shards` shards (`mesh_factors`).

    One process: every shard on `device`; a device type without an index
    ("cuda") spreads the shards round-robin over the visible cards of that
    type, so on one card all shards share it. Under `torch.distributed`,
    the shards split evenly into contiguous runs, one a rank, each rank's
    on its own `device`. `n_shards` defaults to one a visible device of
    the type, times the world size."""
    rank, world = _world()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world == 1:
        local_devs = [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
    else:
        local_devs = [dev]
    if not local_devs:
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    n = n_shards or world * len(local_devs)
    if n % world:
        raise ValueError(f"{n} shards do not split over {world} ranks")
    per = n // world
    ranks = [i // per for i in range(n)]
    devices = [local_devs[(i - rank * per) % len(local_devs)]
               if ranks[i] == rank else dev for i in range(n)]
    return Mesh(mesh_factors(n), devices, ranks, axis_names)
