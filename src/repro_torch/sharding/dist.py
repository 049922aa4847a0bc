"""Process groups and collectives on ``torch.distributed`` (the port's
counterpart of ``repro/sharding/compat.py``'s ``maybe_init_distributed``
and of the ``jax.lax`` collectives the MR-HAP programs use).

The reference runs each worker's program under ``shard_map`` over a mesh
axis. The port runs one process per worker (a *rank*): every rank runs the
same program on its own block and meets the others in the collectives
below, each over one mesh axis (an ``Axis``: the process group of the
ranks that share every other mesh coordinate). Every rank calls ``solve``
with the same input and gets the same full result back.

Transport. NCCL when every rank of a host has a card of its own; gloo when
ranks share a card or run on the CPU (NCCL refuses two ranks on one card).
Under gloo a CUDA tensor is copied to the host, exchanged there and copied
back (gloo's own CUDA support is partial); the choice is made once, when
the group starts, and asking for NCCL where ranks share a card raises.

Semantics follow ``jax.lax`` with ``tiled=True``:

* ``all_gather`` concatenates every rank's block along ``axis`` in rank
  order;
* ``all_to_all`` splits along ``split_axis``, sends block j to rank j and
  concatenates what it receives along ``concat_axis`` in rank order;
* ``psum_scatter`` gives each rank the sum of its block, added in rank
  order;
* ``pmax``/``pmin`` are exact in any order;
* ``psum`` gathers the operands and adds them in rank order, so its result
  is bit-identical on every rank and under either transport;
* ``chain_sum`` passes a running sum along the ranks, each continuing it
  with its own terms, and broadcasts the last rank's: a sum over the
  ranks that rounds as one process summing every term in rank order.

Every collective adds the bytes this rank sends to the other ranks of the
axis to the axis's ``Traffic`` (a gather sends its block to each of them,
an all-to-all all but its own block).

An axis of an abstract mesh (``sharding.AbstractMesh``, transport
``"dry"``) has no ranks behind it: its gathers, all-to-alls and
reductions return what they would if every rank held this rank's
operand, and count the bytes the real transport would send. The dry run
runs the sharded train step so, on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

#: the transports a group may run on
TRANSPORTS = ("nccl", "gloo")


@dataclasses.dataclass
class Traffic:
    """Bytes this rank sent to other ranks, in all and by the kind of
    collective (the reference's HLO names: "all-gather", "all-reduce",
    "all-to-all", "collective-permute"), and the collectives counted."""
    bytes_sent: int = 0
    by_kind: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    def add(self, nbytes: int, kind: str = "all-gather") -> None:
        self.bytes_sent += int(nbytes)
        self.by_kind[kind] = self.by_kind.get(kind, 0) + int(nbytes)
        self.ops += 1


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""
    name: str
    size: int
    index: int                     # this rank's coordinate along the axis
    group: Optional[object]        # the axis's process group; None if size 1
    ranks: tuple                   # the group's global ranks, by coordinate
    transport: str                 # "nccl" | "gloo" | "none" (one process)
    #                                | "dry" (an abstract mesh: no ranks)
    traffic: Traffic


# ------------------------------------------------------------------ groups
def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default group; 1 when no group is running."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def transport() -> str:
    """The default group's transport, or "none" in a single process."""
    return str(dist.get_backend()) if is_initialized() else "none"


def choose_transport(device: torch.device, local_ranks: int,
                     requested: Optional[str] = None) -> str:
    """NCCL when each of this host's ``local_ranks`` ranks has a card of its
    own, gloo when ranks share a card or run on the CPU. ``requested``
    names one; NCCL where it cannot run raises."""
    if requested not in (None, *TRANSPORTS):
        raise ValueError(f"unknown transport {requested!r}; known: "
                         f"{TRANSPORTS}")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    own_cards = device.type == "cuda" and local_ranks <= cards
    if requested == "nccl" and not own_cards:
        raise ValueError(
            f"NCCL needs a card for each rank: {local_ranks} ranks on this "
            f"host, {cards} card(s) for device {device}; NCCL refuses two "
            "ranks on one card — use transport='gloo'")
    return requested or ("nccl" if own_cards else "gloo")


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The card of this host's ``local_rank``-th rank: round-robin over
    the cards (several ranks share one when there are more ranks than
    cards); the CPU stays the CPU."""
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    if device.index is not None:
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _start(backend: str, device: torch.device, **init) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, **init)


def maybe_init_distributed(device="cuda",
                           transport: Optional[str] = None) -> bool:
    """Join the group that ``torchrun``'s environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), with this rank's card made current.

    A single process — no such environment, or ``WORLD_SIZE`` 1 — is a
    strict no-op that returns False. Returns True when a group is (or
    already was) running; repeated calls are idempotent."""
    if is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world < 2 or not os.environ.get("MASTER_ADDR") \
            or "RANK" not in os.environ:
        return False
    local_rank = int(os.environ.get("LOCAL_RANK") or 0)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE") or world)
    dev = rank_device(torch.device(device), local_rank)
    _start(choose_transport(dev, local_world, transport), dev,
           init_method="env://", rank=int(os.environ["RANK"]),
           world_size=world)
    return True


# -------------------------------------------------------------- collectives
def axis_index(ax: Axis) -> int:
    return ax.index


def _staged(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The tensor the transport exchanges: on the host under gloo."""
    x = x.contiguous()
    return x.cpu() if ax.transport == "gloo" and x.is_cuda else x


def _gathered(x: torch.Tensor, ax: Axis,
              kind: str = "all-gather") -> list[torch.Tensor]:
    """Every rank's ``x`` in rank order, where the transport holds them."""
    src = _staged(x, ax)
    ax.traffic.add((ax.size - 1) * src.nbytes, kind)
    if ax.transport == "dry":
        return [src] * ax.size
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return parts


def all_gather(x: torch.Tensor, ax: Axis, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """``lax.all_gather``: the ranks' blocks concatenated (``tiled``) or
    stacked along ``axis``, in rank order."""
    if ax.size == 1:
        return x if tiled else x.unsqueeze(axis)
    parts = _gathered(x, ax)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return out.to(x.device)


def all_to_all(x: torch.Tensor, ax: Axis, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: block j of ``x`` along
    ``split_axis`` goes to rank j; the blocks received are concatenated
    along ``concat_axis`` in rank order."""
    if ax.size == 1:
        return x
    if x.shape[split_axis] % ax.size:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)}"
                         f" does not split into {ax.size} blocks")
    src = _staged(x.movedim(split_axis, 0), ax)
    ax.traffic.add(src.nbytes // ax.size * (ax.size - 1), "all-to-all")
    if ax.transport == "dry":
        out = src
    else:
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=ax.group)
    blocks = [b.movedim(0, split_axis) for b in out.chunk(ax.size, dim=0)]
    return torch.cat(blocks, dim=concat_axis).to(x.device)


def psum_scatter(x: torch.Tensor, ax: Axis, *, axis: int) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: the sum over the axis of block
    ``index`` of ``x`` along ``axis`` (blocks added in rank order, as
    ``psum`` adds), each rank sending the other ranks their blocks."""
    if ax.size == 1:
        return x
    parts = all_to_all(x, ax, split_axis=axis,
                       concat_axis=axis).chunk(ax.size, dim=axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def barrier(ax: Axis) -> None:
    """Wait until every rank of the axis gets here (one rank: no-op)."""
    if ax.size > 1 and ax.transport != "dry":
        dist.barrier(group=ax.group)


def _reduce(x: torch.Tensor, ax: Axis, fn: Callable) -> torch.Tensor:
    if ax.size == 1:
        return x
    return fn(torch.stack(_gathered(x, ax, "all-reduce")), 0).to(x.device)


def pmax(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return _reduce(x, ax, torch.amax)


def pmin(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return _reduce(x, ax, torch.amin)


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum over the axis, added in rank order on every rank."""
    if ax.size == 1:
        return x
    parts = _gathered(x, ax, "all-reduce")
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.to(x.device)


def chain_sum(continue_sum: Callable[[torch.Tensor], torch.Tensor],
              like: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``continue_sum(carry)`` adds this rank's terms to ``carry``, the
    running sum of every rank before it (zeros like ``like`` on the
    first), in the order one process would; the last rank's result,
    broadcast, is the sum over the axis on every rank. W - 1 hops of one
    operand, then a broadcast: the O(N) traffic of an all-reduce, with the
    one-process rounding."""
    carry = torch.zeros_like(like)
    if ax.size == 1:
        return continue_sum(carry)
    if ax.index > 0:
        buf = _staged(carry, ax)
        dist.recv(buf, src=ax.ranks[ax.index - 1], group=ax.group)
        carry = buf.to(like.device)
    out = _staged(continue_sum(carry), ax)
    last = ax.size - 1
    if ax.index < last:
        dist.send(out, dst=ax.ranks[ax.index + 1], group=ax.group)
        ax.traffic.add(out.nbytes, "collective-permute")
    else:
        ax.traffic.add(last * out.nbytes, "collective-permute")
    dist.broadcast(out, src=ax.ranks[last], group=ax.group)
    return out.to(like.device)


# ------------------------------------------------------------------- spawn
def _rank_main(rank_: int, fn: Callable, args: tuple, world: int, tmp: str,
               device: str, transport_: Optional[str]) -> None:
    dev = rank_device(torch.device(device), rank_)
    if dev.type == "cpu":
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    _start(choose_transport(dev, world, transport_), dev, store=store,
           rank=rank_, world_size=world)
    try:
        # start together: a rank that fails at once must not close its
        # connections under a peer still connecting to it
        dist.barrier()
        torch.save(fn(*args), os.path.join(tmp, f"rank{rank_}.pt"))
        # leave together: a rank that closes its connections while a peer
        # may still be reading from them can reset them under the peer
        try:
            dist.barrier()
        except RuntimeError:  # gloo: "Connection closed by peer"
            pass      # a peer failed and left: ``spawn`` raises its error
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, device="cpu",
          transport: Optional[str] = None, args: tuple = ()) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of a new group on this host and
    return each rank's result, in rank order.

    The ranks are fresh processes (the ``spawn`` start method: CUDA cannot
    be forked) that meet through a file store in a temporary directory;
    on ``"cuda"`` they go round-robin over the cards. ``fn`` must be
    importable by name, and ``fn``, ``args`` and the results picklable. A
    rank that raises ends every rank, and the error is raised here."""
    if world < 1:
        raise ValueError(f"world must be >= 1; got {world}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, world, tmp, str(device), transport),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
