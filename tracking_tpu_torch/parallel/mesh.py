"""Shards of one stream on one device: the counterpart of the mesh axis and
``shard_map`` that ``tracking_tpu/parallel/spatial.py`` runs on
(``tracking_tpu/parallel/mesh.py``).

:class:`ShardGroup` runs ``fn(rank, ctx, *per_shard_args)`` for ranks
0..n−1, one Python thread per rank, in one process on one device, and
returns the per-rank results. ``ctx`` is the rank's :class:`ShardComm`,
whose collectives are the ones the spatial path uses: ``ppermute``,
``psum``, ``pmax`` and ``all_gather``. Every rank must call the same
collectives in the same order (the SPMD rule of ``shard_map``). The group
keeps these rules:

- collectives reduce in rank order 0..n−1, so a float sum is the same on
  every rank and in every run;
- a sent tensor is cloned before the barrier, so no later in-place write
  of its sender can reach a receiver;
- ``ppermute`` zero-fills where no rank sends, as ``jax.lax.ppermute``;
- a rank that raises aborts the barrier, and :meth:`ShardGroup.run`
  re-raises the first exception; a barrier wait longer than ``timeout``
  seconds fails the run instead of hanging it;
- on CUDA every rank enqueues its work on the device's one current stream
  (the caller's), so the order in which the threads enqueue is the order in
  which the device runs the work. A receiver enqueues its reads of another
  rank's tensor only after the barrier that the sender reached after it
  enqueued that tensor, so no event is needed;
- the CUDA kernels are built before the threads start.

One device, not one card per rank: NCCL refuses two ranks on one GPU, and
gloo's point-to-point calls take CPU tensors only, so every halo band would
cross the host. Threads keep the per-rank code as ``spatial.py`` writes it
(its ``while`` loops hold collectives, which a loop over slabs could not).
A ``torch.distributed`` group, one process per card, is a later step.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import torch

from tracking_tpu_torch.ops import _native


class ShardComm:
    """One rank's handle on its :class:`ShardGroup`: ``rank``, ``n`` and the
    collectives. Built by :meth:`ShardGroup.run`."""

    def __init__(self, group: "ShardGroup", rank: int):
        self.group = group
        self.rank = rank
        self.n = group.n
        self._calls = 0

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (cloned), in rank order. Two slot lists
        alternate: a rank can refill one only after the next barrier, which
        every rank reaches only after it has read this one."""
        slots = self.group._slots[self._calls % 2]
        self._calls += 1
        slots[self.rank] = x.clone()
        self.group._wait()
        return list(slots)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Rank r sends ``x`` to rank r + shift; returns what this rank
        receives, zeros where rank − shift does not exist."""
        got = self._exchange(x)
        src = self.rank - shift
        return got[src] if 0 <= src < self.n else torch.zeros_like(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        got = self._exchange(x)
        acc = got[0]
        for t in got[1:]:
            acc = acc + t
        return acc

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        got = self._exchange(x)
        acc = got[0]
        for t in got[1:]:
            acc = torch.maximum(acc, t)
        return acc

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order (JAX's
        ``all_gather(..., tiled=True)``)."""
        return torch.cat(self._exchange(x), dim=dim)


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class ShardGroup:
    """``n`` ranks as threads on one device (module docstring)."""

    def __init__(self, n: int, timeout: float = 600.0):
        if n < 1:
            raise ValueError(f"a shard group needs at least one rank, got {n}")
        self.n = n
        self.timeout = timeout
        self._barrier: Optional[threading.Barrier] = None
        self._slots = None

    def _wait(self) -> None:
        self._barrier.wait()

    def run(self, fn: Callable, *per_shard_args: Sequence) -> list:
        """``fn(rank, ctx, *(a[rank] for a in per_shard_args))`` on ``n``
        threads; returns the results in rank order."""
        n = self.n
        for a in per_shard_args:
            if len(a) != n:
                raise ValueError(f"expected {n} per-shard values, got {len(a)}")
        t = _first_tensor(per_shard_args)
        stream = None
        if t is not None and t.is_cuda:
            _native.library()  # build before the threads start
            stream = torch.cuda.current_stream(t.device)
        self._barrier = threading.Barrier(n, timeout=self.timeout)
        self._slots = ([None] * n, [None] * n)
        results: list = [None] * n
        errors: list = [None] * n

        def worker(rank: int) -> None:
            try:
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.device(stream.device))
                        stack.enter_context(torch.cuda.stream(stream))
                    results[rank] = fn(rank, ShardComm(self, rank), *(a[rank] for a in per_shard_args))
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=worker, args=(r,), name=f"shard-{r}") for r in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self._slots = None
        first = next((e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)), None)
        if first is not None:
            raise first
        if any(e is not None for e in errors):
            raise TimeoutError(f"shard group: a rank waited more than {self.timeout} s at a collective")
        return results
