"""Process groups and the collectives of the sharded solves.

The port's counterpart of the ``jax.lax`` collectives that the JAX
package's ``parallel/`` modules call inside ``shard_map``.  One process
runs per rank, over ``torch.distributed``: NCCL on the card (rank r on
``cuda:r``), gloo on the CPU.  Each rank holds its own shard, with no
leading device axis; the JAX constructs map as

    lax.all_gather(send pool)   ->  Comm.all_gather_pool (all_gather_into_tensor,
                                    rank-major, as JAX's (P, S_max) pool)
    lax.psum                    ->  Comm.psum (all_reduce, sum)
    psum(vdot(a, b))            ->  Comm.pdot (the local torch.dot, then psum)
    lax.ppermute                ->  Comm.ppermute (batch_isend_irecv; zeros on
                                    a rank that no pair sends to)
    lax.axis_index              ->  Comm.rank

:func:`init` sets the group up from a ``FileStore`` path or a TCP address
with an explicit timeout.  On the card it binds the rank to ``cuda:rank``
and passes ``device_id``, so NCCL's communicator is made at once (a lazily
made one needs every rank in its first ``batch_isend_irecv``).  Nothing
falls back: without CUDA, or with fewer cards than ranks, ``init`` raises,
and it never puts two ranks on one card.

``counts()`` counts the collectives each kind of call makes on this rank
(``all_gather``, ``all_reduce`` and ``p2p``, one per ``batch_isend_irecv``),
zeroed by ``reset_counts()``: a solve's collectives per iteration are read
from them.
"""

from __future__ import annotations

import datetime
import warnings

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_COUNTS = {"all_gather": 0, "all_reduce": 0, "p2p": 0}


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def counts() -> dict[str, int]:
    return dict(_COUNTS)


class Comm:
    """This rank's view of the group: ``rank``, ``world`` and the
    ``device`` its shard lives on."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device

    def all_gather_pool(self, send: torch.Tensor) -> torch.Tensor:
        """(world·S, ...) rank-major concatenation of every rank's (S, ...)
        ``send`` (the JAX pool's (P, S_max) reshaped flat)."""
        send = send.contiguous()
        out = send.new_empty((self.world * send.shape[0],) + tuple(send.shape[1:]))
        if self.world == 1:
            return out.copy_(send)
        dist.all_gather_into_tensor(out, send)
        _COUNTS["all_gather"] += 1
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        t = t.clone()
        if self.world > 1:
            dist.all_reduce(t)
            _COUNTS["all_reduce"] += 1
        return t

    def pdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """psum of the local dot product (JAX's ``psum(vdot(a, b))``)."""
        return self.psum(torch.dot(a, b))

    def ppermute(self, t: torch.Tensor, pairs) -> torch.Tensor:
        """``lax.ppermute``: rank i sends ``t`` to j for each (i, j) in
        ``pairs``; the result is what this rank received, zeros where no
        pair sends to it."""
        t = t.contiguous()
        recv = torch.zeros_like(t)
        ops = []
        for i, j in pairs:
            if i == self.rank and j == self.rank:
                recv.copy_(t)
            elif i == self.rank:
                ops.append(dist.P2POp(dist.isend, t, j))
            elif j == self.rank:
                ops.append(dist.P2POp(dist.irecv, recv, i))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            _COUNTS["p2p"] += 1
        return recv

    def warm_up(self) -> None:
        """One collective of each kind the solves make (an all-reduce, an
        all-gather, a ring of sends each way), so that the group's first
        use of each, which sets up its connections, falls outside the
        timed solves; not counted."""
        if self.world == 1:
            return
        saved = counts()
        t = torch.ones(1, device=self.device)
        self.psum(t)
        self.all_gather_pool(t)
        n = self.world
        self.ppermute(t, [(i, (i + 1) % n) for i in range(n)])
        self.ppermute(t, [(i, (i - 1) % n) for i in range(n)])
        _COUNTS.update(saved)

    def barrier(self) -> None:
        if self.world > 1:
            if self.device.type == "cuda":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def check_devices(device: str, world: int) -> None:
    """Raise unless ``world`` ranks can run on ``device`` one per card
    (``device`` "cuda") or on the CPU (``device`` "cpu")."""
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {tuple(BACKENDS)}, got {device!r}")
    if world < 1:
        raise ValueError(f"{world} ranks")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; the sharded solve runs "
                               "one rank per NVIDIA card (--device cpu runs it on gloo)")
        have = torch.cuda.device_count()
        if have < world:
            raise RuntimeError(f"{world} ranks need {world} CUDA cards, this machine has "
                               f"{have}; ranks never share a card")


def init(rank: int, world: int, *, device: str = "cuda", store_path: str | None = None,
         address: str | None = None, timeout_s: float = 600.0) -> Comm:
    """Join the group as ``rank`` of ``world``: through the ``FileStore`` at
    ``store_path`` or the TCP ``address`` (``tcp://host:port``), NCCL on
    ``cuda:rank`` or gloo on the CPU, with ``timeout_s`` on every
    collective."""
    check_devices(device, world)
    if (store_path is None) == (address is None):
        raise ValueError("give exactly one of store_path and address")
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*",
                            category=FutureWarning)
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {}
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    else:
        kw["init_method"] = address
    dist.init_process_group(BACKENDS[device], rank=rank, world_size=world,
                            timeout=timeout, **kw)
    return Comm(rank, world, dev)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
