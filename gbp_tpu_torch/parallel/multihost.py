"""Multi-process execution over `torch.distributed` (counterpart of
gbp_tpu/parallel/multihost.py).

The reference's scaling story is "1 chip -> 1 host -> N >= 2 hosts": one
`shard_map` program over a mesh that spans processes.  Here a group of W
ranks holds P partitions, K = P / W consecutive ones on each rank, stacked
[K, ...]; the halo sweeps (`parallel/halo.py`, `parallel/halo_cm.py`, their
schedules and the annealed halo runner), the SPMD sweep (`parallel/spmd.py`)
and the sharded Schur step (`parallel/schur.py`) run unchanged on a rank's
K partitions with `DistComm` as their communicator.

  * `initialize()` wraps `torch.distributed.init_process_group`.  With no
    arguments it reads the `torchrun` environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK); the explicit form
    (`init_method="tcp://localhost:<port>"`, world size, rank) is for
    processes started by hand, as the tests start them.
  * `DistComm(n_parts)` is the communicator over the group: `all_gather`,
    `shift` and `all_reduce` with the results of `halo.LocalComm` on the
    same P partitions, bit for bit.
  * `global_comm(n_parts)` (the reference's `global_mesh`), `is_primary()`,
    and `collect_means(hp, state, comm)`: every rank gets the global means.

Transport, fixed by the group's backend when the communicator is made:
"nccl" moves CUDA tensors between cards directly; "gloo" moves host
tensors, and CUDA tensors are staged through pinned host buffers (copied
down before a collective and up after it, timed in `stats`).  NCCL refuses
two ranks on one card, so several ranks sharing a card run under gloo.

    torchrun --nproc_per_node=2 script.py      # ranks from the environment

    from gbp_tpu_torch.parallel import halo_cm, multihost
    device = multihost.initialize()
    comm = multihost.global_comm(n_parts=4, device=device)
    hp, hcm, state, run = halo_cm.distribute(graph, means, 4, comm=comm)
    state = run(hcm, state, cfg, 50)
    means = multihost.collect_means(hp, state, comm)
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.parallel.halo import sum_in_order


def _rank_device(device) -> torch.device:
    """The rank's device: `device` (None: `default_device()`, the card, or
    its error), a CUDA device without an index being card LOCAL_RANK (mod
    the cards present)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device=None) -> torch.device:
    """Join (or form) the process group; returns the rank's device.

    No arguments: the `torchrun` environment (init_method "env://").  The
    explicit form takes an init_method such as "tcp://localhost:29500",
    the world size and this process's rank.  backend None: "nccl" when the
    rank's device is a CUDA device, else "gloo" (pass "gloo" for several
    ranks on one card).  device None: the card LOCAL_RANK."""
    device = _rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group(backend=backend, **kw)
    return device


def is_primary() -> bool:
    return dist.get_rank() == 0


class DistComm:
    """The halo exchange's collectives over the W ranks of a process group,
    each holding K = n_parts / W consecutive partitions stacked [K, ...]
    (rank r: partitions r K .. r K + K - 1).

    all_gather(x)    [K, n, ...] -> [K, P n, ...], in partition order;
    shift(x, off)    partition p's block goes to partition (p + off) % P
                     (blocks that stay on the rank are copied, the rest go
                     by one `batch_isend_irecv` round, one buffer per peer);
    all_reduce(x)    [K, ...] -> [K, ...]: the sum over all P partitions,
                     an all_gather then `halo.sum_in_order` (partition 0
                     first), so it equals `LocalComm.all_reduce` bit for bit
                     (the backend's own reduction fixes no order).

    `stats` counts the bytes this rank hands to the transport and receives
    from it, the collectives, and the host staging of the gloo transport
    with CUDA tensors (bytes and seconds); `reset_stats()` zeroes it."""

    def __init__(self, n_parts: int, group=None, device=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if n_parts % self.world:
            raise ValueError(f"DistComm: {n_parts} partitions do not divide over "
                             f"{self.world} ranks")
        self.n_parts = n_parts
        self.k = n_parts // self.world
        self.parts = range(self.rank * self.k, (self.rank + 1) * self.k)
        self.device = _rank_device(device)
        self.backend = dist.get_backend(group)
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("DistComm: the nccl backend moves CUDA tensors only")
            self.transport = "nccl"
        elif self.backend == "gloo":
            self.transport = "gloo, staged" if self.device.type == "cuda" else "gloo"
        else:
            raise ValueError(f"DistComm: no transport for backend {self.backend!r}")
        self._pinned = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = dict(collectives=0, bytes_sent=0, bytes_received=0, staged_bytes=0,
                          staging_s=0.0)

    # --- transport ---------------------------------------------------------

    def _peer(self, q: int) -> int:
        return q if self.group is None else dist.get_global_rank(self.group, q)

    def _stage_down(self, x: torch.Tensor, slot: str) -> torch.Tensor:
        """A CUDA tensor copied into a pinned host buffer (one per slot and
        shape, reused), when the transport stages; else x."""
        if self.transport != "gloo, staged":
            return x.contiguous()
        torch.cuda.current_stream(x.device).synchronize()  # the producer's kernels
        t0 = time.perf_counter()
        buf = self._pinned_buffer(x.shape, x.dtype, slot)
        buf.copy_(x)
        self.stats["staging_s"] += time.perf_counter() - t0
        self.stats["staged_bytes"] += buf.numel() * buf.element_size()
        return buf

    def _stage_up(self, h: torch.Tensor) -> torch.Tensor:
        """A host result copied to the rank's card, when the transport
        stages; else h."""
        if self.transport != "gloo, staged":
            return h
        t0 = time.perf_counter()
        out = h.to(self.device)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats["staging_s"] += time.perf_counter() - t0
        self.stats["staged_bytes"] += h.numel() * h.element_size()
        return out

    def _pinned_buffer(self, shape, dtype, slot: str) -> torch.Tensor:
        """The pinned host buffer of one slot, shape and dtype (made once)."""
        key = (slot, tuple(shape), dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return self._pinned[key]

    def _empty(self, shape, dtype, slot: str) -> torch.Tensor:
        """A receive buffer on the transport's side: pinned host memory
        when it stages, else the rank's device."""
        if self.transport != "gloo, staged":
            return torch.empty(shape, dtype=dtype, device=self.device)
        return self._pinned_buffer(shape, dtype, slot)

    def _gather_parts(self, x: torch.Tensor) -> torch.Tensor:
        """x [K, ...] -> [P, ...]: every partition's block, in order."""
        self.stats["collectives"] += 1
        h = self._stage_down(x, "gather.send")
        nbytes = h.numel() * h.element_size()
        out = self._empty((self.n_parts, *x.shape[1:]), x.dtype, "gather.recv")
        dist.all_gather(list(out.chunk(self.world)), h, group=self.group)
        if self.world > 1:
            self.stats["bytes_sent"] += nbytes
            self.stats["bytes_received"] += nbytes * (self.world - 1)
        return self._stage_up(out)

    # --- the three collectives ---------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        g = self._gather_parts(x)
        flat = g.reshape(1, -1, *x.shape[2:])
        return flat.expand(x.shape[0], *flat.shape[1:])

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return sum_in_order(self._gather_parts(x)).unsqueeze(0).expand_as(x)

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """Partition p's block goes to partition (p + offset) % P: the
        reference's ppermute with perm [(p, (p + offset) % P)]."""
        self.stats["collectives"] += 1
        lo, k, n = self.parts.start, self.k, self.n_parts
        h = self._stage_down(x, "shift.send")
        out = self._empty(x.shape, x.dtype, "shift.recv")
        sends, recvs = {}, {}
        for i in range(k):
            src = (lo + i - offset) % n
            if src in self.parts:
                out[i] = h[src - lo]
            else:
                recvs.setdefault(src // k, []).append(i)
        for j in range(k):
            dst = (lo + j + offset) % n
            if dst not in self.parts:
                sends.setdefault(dst // k, []).append((dst, j))
        ops, landed = [], []
        for q, items in sorted(sends.items()):
            buf = h[[j for _, j in sorted(items)]].contiguous()
            ops.append(dist.P2POp(dist.isend, buf, self._peer(q), self.group))
            self.stats["bytes_sent"] += buf.numel() * buf.element_size()
        for q, rows in sorted(recvs.items()):
            buf = torch.empty((len(rows), *x.shape[1:]), dtype=x.dtype, device=h.device)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(q), self.group))
            landed.append((rows, buf))
            self.stats["bytes_received"] += buf.numel() * buf.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for rows, buf in landed:
            out[rows] = buf
        return self._stage_up(out)


def global_comm(n_parts: int, device=None) -> DistComm:
    """The communicator over every rank of the default group (the
    reference's `global_mesh`)."""
    return DistComm(n_parts, device=device)


def collect_means(hp, state, comm) -> tuple:
    """`halo.collect_means` across ranks: the owned means of every
    partition gathered through `comm`, then scattered into global order
    [n, d]; every rank gets the same tensors (on the state's device)."""
    out = []
    for vbi, vb in enumerate(hp.src_graph.vblocks):
        m = state.v[vbi].mean
        allm = comm.all_gather(m)[0].reshape(hp.n_chips, -1, vb.dof)
        ids, val = hp.owned_ids[vbi], hp.owned_valid[vbi]
        g = torch.zeros((vb.count, vb.dof), dtype=m.dtype, device=m.device)
        g[torch.tensor(ids[val], dtype=torch.int64, device=m.device)] = \
            allm[torch.tensor(val, device=m.device)]
        out.append(g)
    return tuple(out)
