"""The explicit collectives of the sharded paths, on torch.distributed
process groups (qtpu's psum, all_gather and ppermute points).

Every op takes a group (a ProcessGroup, e.g. one dim of a DeviceMesh) and
plain tensors. NCCL takes card tensors for all of them. Gloo takes a card
tensor for all_reduce, broadcast and all_gather (`GLOO_CARD_OPS`, read on an
H100 by tools/exp_gloo_card_ops.py); point-to-point (send, recv,
batch_isend_irecv) on a card tensor aborts the process in gloo's TCP
transport ("writev ... Bad address"), so there a card tensor is staged
through host memory explicitly: copied to the host, sent, copied back.
Nothing is decided by catching a failure. `STATS` counts the calls, the staged calls and bytes,
and, while `STATS.timing` is on, the host milliseconds of each (the device
synchronized before and after, so it is a reading of the op alone, for the
correctness phases, not of a pipelined run).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

# the ops gloo runs on a card tensor itself; the point-to-point ops are
# staged through host memory
GLOO_CARD_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})


class _Stats:
    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self):
        self.calls = 0
        self.staged = 0
        self.staged_bytes = 0
        self.ms = 0.0
        self.staged_ms = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "staged": self.staged, "staged_bytes": self.staged_bytes,
                "ms": self.ms, "staged_ms": self.staged_ms}


STATS = _Stats()


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def global_rank(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank)


def _staged(op: str, t: torch.Tensor, group) -> bool:
    return (t.device.type != "cpu" and op not in GLOO_CARD_OPS
            and dist.get_backend(group) == "gloo")


@contextmanager
def _timed(t: torch.Tensor, staged: bool):
    STATS.calls += 1
    if not STATS.timing:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    ms = (time.perf_counter() - t0) * 1e3
    STATS.ms += ms
    if staged:
        STATS.staged_ms += ms


def _to_host(t: torch.Tensor) -> torch.Tensor:
    STATS.staged += 1
    STATS.staged_bytes += t.numel() * t.element_size()
    return t.to("cpu")


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In place over the group; returns t. A group of one leaves t as it is."""
    if group is None:
        return t
    with _timed(t, False):
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place from the group's rank `src`; returns t."""
    if group is None:
        return t
    with _timed(t, False):
        dist.broadcast(t, src=global_rank(group, src), group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = -1, sizes=None) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order.
    sizes: every rank's length along `dim` where they differ (each part
    padded to the longest for the gather and cut back after)."""
    if group is None:
        return t
    if sizes is not None:
        m = max(sizes)
        if t.shape[dim] < m:
            pad = list(t.shape)
            pad[dim] = m - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim=dim)
        parts = all_gather(t, group, dim).split(m, dim=dim)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
    staged = _staged("all_gather", t, group)
    with _timed(t, staged):
        src = _to_host(t) if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        if staged:
            out = out.to(t.device)
    return out


def send(t: torch.Tensor, dst: int, group) -> None:
    """Blocking send to the group's rank `dst`."""
    staged = _staged("send", t, group)
    with _timed(t, staged):
        dist.send(_to_host(t) if staged else t.contiguous(), dst=global_rank(group, dst),
                  group=group)


def recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Blocking receive into t from the group's rank `src`; returns t."""
    staged = _staged("recv", t, group)
    with _timed(t, staged):
        buf = _to_host(t) if staged else t
        dist.recv(buf, src=global_rank(group, src), group=group)
        if staged:
            t.copy_(buf)
    return t


def ring_shift(tensors, group):
    """Each tensor sent to the next rank of the group's ring and replaced by
    the previous rank's (qtpu's ppermute i -> i + 1), as one
    batch_isend_irecv. Returns the received tensors."""
    n, r = size(group), rank(group)
    if n == 1:
        return list(tensors)
    staged = _staged("ring_shift", tensors[0], group)
    with _timed(tensors[0], staged):
        srcs = [_to_host(t) if staged else t.contiguous() for t in tensors]
        outs = [torch.empty_like(s) for s in srcs]
        nxt, prv = global_rank(group, (r + 1) % n), global_rank(group, (r - 1) % n)
        ops = []
        for s, o in zip(srcs, outs):
            ops.append(dist.P2POp(dist.isend, s, nxt, group))
            ops.append(dist.P2POp(dist.irecv, o, prv, group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged:
            outs = [o.to(t.device) for o, t in zip(outs, tensors)]
    return outs
