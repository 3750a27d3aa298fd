"""Ranks on one device: the counterpart of the mesh and ``shard_map`` that
``tracking_tpu/parallel`` runs on (``tracking_tpu/parallel/mesh.py``).

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
- a rank that raises aborts every barrier, and :meth:`ShardGroup.run`
  re-raises the first exception; a barrier wait longer than ``timeout``
  seconds fails the run instead of hanging it;
- on CUDA every rank enqueues its work on the device's one current stream
  (the caller's), so the order in which the threads enqueue is the order in
  which the device runs the work. A receiver enqueues its reads of another
  rank's tensor only after the barrier that the sender reached after it
  enqueued that tensor, so no event is needed;
- the CUDA kernels are built, and PyTorch's CUDA linear algebra loaded,
  before the threads start.

The 2-D group (a :class:`Mesh` of ``stream`` × ``space`` ranks, rank = i ·
space + j): :meth:`ShardComm.axis` gives a rank its view of one mesh axis,
the ranks that share its other coordinate, with a barrier and slots of
their own. A stream row's ``SpatialCtx`` runs its ``ppermute`` / ``psum`` /
``pmax`` / ``all_gather`` over the ``space`` view, so each stream row
synchronises only with itself: SuBSENSE's auto-reset branch (a host read
of the trigger) and ``sharded_fill``'s injection rounds may run a
different number of collectives in two rows without a deadlock. The
stream axis needs no collective at all. The JAX package sums its fill's
convergence flags over both axes (``SpatialCtx.conv_axes``) only to keep
XLA:CPU's rendezvous in step: a row that has converged runs extra rounds
that re-confirm its fixed point, so rows that stop on their own give the
same bits.

On top of the group: :class:`Mesh` and :func:`make_mesh` (the JAX split
rule), :func:`video_batch_spec` and :func:`shard_video_batch`, and the
stream-batched runners :func:`run_video_batch_shardmap` and
:func:`run_video_batch` (``tracking_tpu/parallel/mesh.py:39-170``). Each
stream keeps its own state tensors (the kernels update banks in place);
states come back stacked leaf by leaf along a leading ``B``, the layout of
JAX's vmapped pytree, and ``states=`` takes that layout. Frames and states
placed on the mesh (``parallel/placed.py``: ``shard_video_batch`` returns
a :class:`~tracking_tpu_torch.parallel.placed.MeshArray`) stay on the
ranks: a runner given one keeps its states placed, where JAX's
``out_specs`` keep them sharded.

The thread group runs on one device: NCCL refuses two ranks on one GPU,
and gloo's point-to-point calls take CPU tensors only, so every halo band
would cross the host. Threads keep the per-rank code as ``spatial.py``
writes it (its ``while`` loops hold collectives, which a loop over slabs
could not). A mesh made with a ``backend`` runs the same per-rank code on
processes instead, one per device (``parallel/dist.py``: ``"nccl"`` one
card a rank, ``"gloo"`` ranks that share the CPU or one card), behind the
same collectives; its pool lives until :meth:`Mesh.close`. Processes
receive their function by pickle, so the rank functions here and in
``spatial.py`` are module-level, with explicit arguments.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tracking_tpu_torch.convert import split_states, stack_states
from tracking_tpu_torch.ops import _native
from tracking_tpu_torch.parallel.placed import (MeshArray, block_of, join, map_tensors, mesh_coords, meta_of, owned,
                                                place, placed_mesh, rank_args, spec_rule)


class _Sync:
    """The barrier and the two alternating slot lists of a set of ranks."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = ([None] * n, [None] * n)


class Collectives:
    """``psum``, ``pmax`` and ``all_gather`` on a ``_exchange`` that returns
    every rank's ``x`` in rank order: reductions run in rank order 0..n−1,
    so a float sum has the same bits on every rank and in every group."""

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError

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


class ShardComm(Collectives):
    """One rank's handle on a set of ranks of its :class:`ShardGroup` (all
    of them, or one mesh axis's: :meth:`axis`): ``rank``, ``n`` and the
    collectives. Built by :meth:`ShardGroup.run`."""

    def __init__(self, group: "ShardGroup", sync: _Sync, rank: int, coords: Optional[Dict[str, int]] = None):
        self.group = group
        self.rank = rank
        self.n = sync.n
        self.coords = coords
        self._sync = sync
        self._calls = 0
        self._views: Dict[str, "ShardComm"] = {}

    def axis(self, name: str) -> "ShardComm":
        """This rank's view of mesh axis ``name``: the ranks that share its
        other coordinate, ranked along ``name``, with a barrier of their own
        (one view a name, so its collectives keep their count)."""
        if name not in self._views:
            if self.coords is None or name not in self.coords:
                raise ValueError(f"no mesh axis {name!r} in this group")
            sync = self.group._syncs[_axis_key(self.coords, name)]
            self._views[name] = ShardComm(self.group, sync, self.coords[name], self.coords)
        return self._views[name]

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (cloned), in rank order. Two slot lists
        alternate: a rank can refill one only after the next barrier, which
        every rank reaches only after it has read this one."""
        slots = self._sync.slots[self._calls % 2]
        self._calls += 1
        slots[self.rank] = x.clone()
        self._sync.barrier.wait()
        return list(slots)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Rank r sends ``x`` to rank r + shift; returns what this rank
        receives, zeros where rank − shift does not exist."""
        got = self._exchange(x)
        src = self.rank - shift
        return got[src] if 0 <= src < self.n else torch.zeros_like(x)


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


def _axis_key(coords: Dict[str, int], name: str):
    return name, tuple((k, v) for k, v in coords.items() if k != name)


class ShardGroup:
    """``n`` ranks as threads on one device (module docstring). ``axes``
    (e.g. ``{"stream": 2, "space": 4}``, product ``n``) makes it a mesh:
    rank r has the row-major coordinates of r, and
    :meth:`ShardComm.axis` its views."""

    def __init__(self, n: int, timeout: float = 600.0, axes: Optional[Dict[str, int]] = None):
        if n < 1:
            raise ValueError(f"a shard group needs at least one rank, got {n}")
        if axes is not None and math.prod(axes.values()) != n:
            raise ValueError(f"mesh axes {axes} do not hold {n} ranks")
        self.n = n
        self.timeout = timeout
        self.axes = dict(axes) if axes is not None else None
        self._syncs: Optional[dict] = None

    def coords(self, rank: int) -> Optional[Dict[str, int]]:
        """Rank ``rank``'s mesh coordinates (row-major), None without axes."""
        return None if self.axes is None else mesh_coords(rank, self.axes)

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
            # PyTorch loads its CUDA linear algebra at the first linalg call,
            # and two threads' first calls race: load it here. The one call
            # left is Eigenbackground's torch.linalg.eigh for a history longer
            # than 64 frames (ops/eigh.py reproduces ssyevd up to 64; tests/
            # test_torch_eigen.py::test_eigenbackground_above_64_frames)
            torch.linalg.inv_ex(torch.eye(4, device=t.device).expand(2, 4, 4))
            stream = torch.cuda.current_stream(t.device)
        self._syncs = {None: _Sync(n, self.timeout)}
        for r in range(n if self.axes else 0):
            c = self.coords(r)
            for name in self.axes:
                key = _axis_key(c, name)
                if key not in self._syncs:
                    self._syncs[key] = _Sync(self.axes[name], self.timeout)
        results: list = [None] * n
        errors: list = [None] * n

        def worker(rank: int) -> None:
            try:
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.device(stream.device))
                        stack.enter_context(torch.cuda.stream(stream))
                    comm = ShardComm(self, self._syncs[None], rank, self.coords(rank))
                    results[rank] = fn(rank, comm, *(a[rank] for a in per_shard_args))
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                errors[rank] = e
                for sync in self._syncs.values():
                    sync.barrier.abort()

        threads = [threading.Thread(target=worker, args=(r,), name=f"shard-{r}") for r in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self._syncs = None
        first = next((e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)), None)
        if first is not None:
            raise first
        if any(e is not None for e in errors):
            raise TimeoutError(f"shard group: a rank waited more than {self.timeout} s at a collective")
        return results


# -- the mesh and the stream-batched runners ------------------------------------------


@dataclasses.dataclass(eq=False)
class Mesh:
    """``stream`` × ``space`` ranks (``jax.sharding.Mesh`` with the axis
    names ``("stream", "space")``): threads on ``device`` when ``backend``
    is None, else processes on ``devices`` (one a rank) behind
    ``torch.distributed``'s ``backend``, started at the first
    :meth:`group` and ended by :meth:`close` (or the ``with`` block).
    Inputs are placed on ``device`` and results come back there."""

    stream: int
    space: int
    device: torch.device
    backend: Optional[str] = None
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        self._pool = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"stream": self.stream, "space": self.space}

    @property
    def size(self) -> int:
        return self.stream * self.space

    def group(self):
        """A :class:`ShardGroup` of the mesh's ranks with its two axes, or
        the mesh's process group (``parallel/dist.py:DistGroup``)."""
        if self.backend is None:
            return ShardGroup(self.size, axes=self.shape)
        if self._pool is None:
            from tracking_tpu_torch.parallel.dist import DistGroup

            self._pool = DistGroup(self.size, self.backend, self.devices)
        return self._pool

    def run(self, fn: Callable, *per_rank_args: Sequence, keep: Sequence[int] = ()) -> Tuple[list, list]:
        """``fn(rank, comm, *args)`` on the mesh's ranks, each ``comm`` with
        its coordinates and axis views. Returns (the results in rank order,
        ``kept``): result index ``keep[k]`` of every rank stays with the
        ranks, and ``kept[k]`` is its per-rank list on a thread mesh, its
        handle id on a process mesh (each rank keeps its own under it; a
        rank that returns None keeps None); those indices read None in the
        results."""
        if self.backend is not None:
            pool = self.group()
            ids = {i: pool.new_id() for i in keep}
            return pool.run(fn, *per_rank_args, axes=self.shape, keep=ids), [ids[i] for i in keep]
        out = self.group().run(fn, *per_rank_args)
        kept = [[None if o is None else o[i] for o in out] for i in keep]
        if keep:
            out = [None if o is None else tuple(None if i in keep else v for i, v in enumerate(o)) for o in out]
        return out, kept

    def cut(self, tree, meta, holders: Optional[Sequence[int]] = None) -> list:
        """A global tree's per-rank blocks for a call (``None`` off
        ``holders``): on a thread mesh contiguous copies on the device, the
        rank's own; on a process mesh views of the caller's tensors, which
        each rank copies onto its device as they arrive."""
        blocks = [block_of(tree, meta, self.shape, r) if holders is None or r in holders else None
                  for r in range(self.size)]
        if self.backend is None:
            blocks = [map_tensors(lambda t: owned(t, self.device), b) for b in blocks]
        return blocks

    def split(self, stream: int) -> "Mesh":
        """The same ranks as ``stream`` × size/stream; a process mesh shares
        its process group (started here if it was not)."""
        if stream < 1 or self.size % stream:
            raise ValueError(f"{self.size} ranks do not split into {stream} streams")
        out = dataclasses.replace(self, stream=stream, space=self.size // stream)
        if self.backend is not None:
            out._pool = self.group()
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_mesh(n_devices: Optional[int] = None, stream: Optional[int] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """2-D mesh (stream × space) of ``n_devices`` ranks, split as
    ``tracking_tpu``'s ``make_mesh``: without ``stream``, n's largest
    divisor d ≤ √n and n / d, the larger of the two on the stream axis (it
    needs no communication).

    ``backend=None``: threads on ``device`` (default the card), one rank
    unless asked. ``"nccl"``: one process a card, rank r on ``cuda:r``, by
    default every card (as JAX's default takes every device); it takes no
    ``device``, and raises without NCCL or with more ranks than cards.
    ``"gloo"``: processes that share ``device`` (default the card; ``"cpu"``
    in the CPU tests)."""
    if backend == "nccl":
        if device is not None:
            raise ValueError("backend 'nccl' puts rank r on cuda:r; it takes no device")
        n = torch.cuda.device_count() if n_devices is None else n_devices
        devices = tuple(torch.device("cuda", r) for r in range(n))
        device = torch.device("cuda", 0)
    else:
        n = 1 if n_devices is None else n_devices
        device = torch.device("cuda" if device is None else device)
        devices = (device,) * n if backend is not None else ()
    if backend is not None:
        from tracking_tpu_torch.parallel.dist import check_backend

        check_backend(backend, devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    if stream is None:
        stream = 1
        for cand in range(math.isqrt(n), 0, -1):
            if n % cand == 0:
                stream = max(cand, n // cand)
                break
    if stream < 1 or n % stream:
        raise ValueError(f"{n} ranks do not split into {stream} streams")
    return Mesh(stream, n // stream, device, backend, devices)


def video_batch_spec() -> tuple:
    """The mesh axis of each dim of a [B, T, H, W, C] video batch: B on
    ``stream``, H on ``space``."""
    return ("stream", None, "space", None, None)


batch_dims = spec_rule(video_batch_spec())  # the dims rule of a [B, T, H, W(, C)] batch


def _on_streams(shape) -> tuple:
    """The dims of a leaf stacked along B and split over ``stream`` only."""
    return ("stream",) + (None,) * (len(shape) - 1)


def shard_video_batch(frames: torch.Tensor, mesh: Mesh) -> MeshArray:
    """A [B, T, H, W(, C)] batch placed on the mesh (``tracking_tpu``
    ``shard_video_batch``): rank i · space + j holds stream block i, row
    block j, [B/stream, T, H/space, W(, C)]. On a thread mesh the blocks are
    copies on its device; on a process mesh each block goes from the
    caller's tensor to its rank's device (a host tensor through shared
    memory, a card's by CUDA IPC, or peer to peer to another card) and
    stays there."""
    b, _, h = frames.shape[:3]
    if b % mesh.stream or h % mesh.space:
        raise ValueError(f"a batch of {b} streams x {h} rows does not split over the mesh {mesh.shape}")
    return place(frames, mesh, video_batch_spec())


def stream_states(algo, frames: torch.Tensor, states=None, copy: bool = True) -> list:
    """One state per stream of ``frames`` [B, T, H, W(, C)]: ``init`` and
    ``warm_start`` on each stream's frame 0, or a stacked ``states`` split
    into per-stream states (``convert.split_states``: copies, the kernels
    update state tensors in place; views where ``copy`` is False, for a
    caller that owns ``states``)."""
    b, _, h, w = frames.shape[:4]
    c = frames.shape[4] if frames.ndim == 5 else 1
    if states is None:
        return [algo.warm_start(algo.init(h, w, c, device=frames.device), frames[i, 0]) for i in range(b)]
    return split_states(states, b, device=frames.device, copy=copy)


def batch_state_meta(algo, states, frames_shape, rule: Callable, axes: Dict[str, int]):
    """The meta tree of a batch's stacked states under ``rule``: that of
    ``states``, or, where the call makes them, of B ``init`` states on the
    ``meta`` device."""
    if states is None:
        b, _, h, w = frames_shape[:4]
        c = frames_shape[4] if len(frames_shape) == 5 else 1
        states = map_tensors(lambda t: t.expand(b, *t.shape), algo.init(h, w, c, device="meta"))
    return meta_of(states, rule, axes)


def run_streams(algo, states: list, frames: torch.Tensor, use_kernels: bool = True, ctx=None):
    """Step ``len(states)`` streams over frames [B, T, ...]: ``t`` outer,
    stream inner, as a multi-camera server runs them. Returns (states,
    masks [B, T, H, W]); ``ctx`` is passed to each step where given."""
    kw = {} if ctx is None else {"ctx": ctx}
    states = list(states)
    masks: List[list] = [[] for _ in states]
    for t in range(frames.shape[1]):
        for i in range(len(states)):
            states[i], fg, _ = algo.step(states[i], frames[i, t], use_kernels=use_kernels, **kw)
            masks[i].append(fg)
    return states, torch.stack([torch.stack(m) for m in masks])


def _stream_rank(rank, comm, algo, states, frames: torch.Tensor, gather_rows: bool, use_kernels: bool):
    """A stream rank's streams [per, T, H, W(, C)], stepped with no
    collective: (states stacked along B, masks). Frames placed with their
    rows over ``space`` are first gathered over the rank's ``space`` row; a
    rank off ``space`` 0 then returns None. ``states``: the rank's own
    stacked block, or None (made here)."""
    if gather_rows:
        frames = comm.axis("space").all_gather(frames, dim=2)
    if comm.coords["space"]:
        return None
    sts, masks = run_streams(algo, stream_states(algo, frames, states, copy=False), frames, use_kernels)
    return stack_states(sts), masks


def run_video_batch_shardmap(algo, frames, mesh: Mesh, states=None, use_kernels: bool = True):
    """Stream-parallel batch (``tracking_tpu`` ``run_video_batch_shardmap``):
    each of the mesh's ``stream`` ranks runs its B/stream whole streams with
    no collective (per-stream state is private). The ``space`` axis only
    replicates that work there, so its ranks off ``space`` 0 hold no stream
    (they only lend their rows of placed frames) and return at once.

    frames [B, T, H, W(, C)] u8, a tensor or a batch placed by
    :func:`shard_video_batch`, B divisible by the stream size; ``states``
    stacked along B, as tensors or placed by an earlier call, or None (made
    on the ranks). Returns (states, masks [B, T, H, W] on the mesh's
    device): the states stacked along B on the mesh's device where frames
    and states are tensors, else placed on the stream ranks."""
    b = frames.shape[0]
    if b % mesh.stream:
        raise ValueError(f"{b} streams do not split over {mesh.stream} stream ranks")
    n, holders = mesh.size, tuple(range(0, mesh.size, mesh.space))
    placed = placed_mesh(frames, states) is not None
    gather_rows = isinstance(frames, MeshArray) and mesh.space > 1
    frame_args = rank_args(mesh, frames, batch_dims) if gather_rows else rank_args(mesh, frames, _on_streams,
                                                                                       holders)
    meta = batch_state_meta(algo, states, frames.shape, _on_streams, mesh.shape)
    out, kept = mesh.run(_stream_rank, [algo] * n, rank_args(mesh, states, _on_streams, holders, clone=True),
                         frame_args, [gather_rows] * n, [use_kernels] * n, keep=(0,) if placed else ())
    masks = torch.cat([out[r][1] for r in holders])
    if placed:
        return MeshArray(mesh, meta, kept[0], holders), masks
    return join([None if o is None else o[0] for o in out], meta, mesh.shape), masks


def run_video_batch(algo, frames, states=None, mesh: Optional[Mesh] = None, use_kernels: bool = True):
    """Multi-stream batch: frames [B, T, H, W(, C)] -> (states stacked along
    B, masks [B, T, H, W]) (``tracking_tpu`` ``run_video_batch``).

    With a mesh whose ``space`` axis splits H into slabs of at least the
    halo, an algorithm whose ``step`` takes ``ctx`` (SuBSENSE, LOBSTER) runs
    :func:`~tracking_tpu_torch.parallel.spatial.run_video_batch_spatial`,
    streams × row shards. Otherwise the frames go to the mesh's device and
    each stream runs unsharded, frame ``t`` of every stream before frame
    ``t + 1``: where the JAX package lets XLA partition the batched scan
    over the mesh, the computation is the same; on a thread mesh (one
    device) there is nothing to partition, and a process mesh runs
    :func:`run_video_batch_shardmap`, the streams split over its stream
    ranks. Placed frames or states (:class:`MeshArray`) run on their mesh
    (``mesh`` may be left out) through those runners, and the states come
    back placed."""
    if mesh is None:
        mesh = placed_mesh(frames, states)
    if mesh is not None:
        from tracking_tpu_torch.parallel.spatial import HALO, run_video_batch_spatial

        h = frames.shape[2]
        if (mesh.space > 1 and "ctx" in inspect.signature(algo.step).parameters and h % mesh.space == 0
                and h // mesh.space >= HALO):
            return run_video_batch_spatial(algo, frames, mesh, states=states, use_kernels=use_kernels)
        if mesh.backend is not None or placed_mesh(frames, states) is not None:
            return run_video_batch_shardmap(algo, frames, mesh, states=states, use_kernels=use_kernels)
        frames = frames.to(mesh.device)
    sts, masks = run_streams(algo, stream_states(algo, frames, states), frames, use_kernels)
    return stack_states(sts), masks
