"""The mesh's ranks as processes, one per device: the counterpart of
``shard_map`` over several chips (``tracking_tpu/parallel/mesh.py``).

:class:`DistGroup` starts ``n`` worker processes (``torch.multiprocessing``,
``spawn``: CUDA cannot be forked) that live until :meth:`DistGroup.close`.
Each joins one ``torch.distributed`` process group (a file store in a
temporary directory) and holds a :class:`DistComm`, which keeps the
semantics of the thread group's ``ShardComm`` (``parallel/mesh.py``):

- ``ppermute(x, shift)``: rank r sends to r + shift through
  ``batch_isend_irecv``; a rank that receives nothing gets zeros. A rank
  with no peer at a hop posts no op, and one with no op at all does not
  enter the batch call;
- ``psum`` / ``pmax``: an ``all_gather``, then the reduction in rank order
  0..n−1 on every rank, so a float sum has the thread group's bits (a
  ring ``all_reduce`` sums in another order);
- ``all_gather(x, dim)``: the ranks' ``x`` concatenated in rank order;
- ``send_recv(sends, sizes)``: bytes to and from any ranks in one batch
  (a reshard's pieces, ``parallel/placed.py``); gloo ranks that share a
  card pass each other CUDA IPC handles, and the receiver copies on the
  card;
- ``axis("stream")`` / ``axis("space")``: the rank's column and row
  groups, made once at start-up with ``dist.new_group`` (every rank makes
  every group, in one order), so a stream row synchronises only with
  itself.

The transport is the backend the caller names: ``"nccl"`` puts rank r on
``cuda:r`` (``torch.cuda.set_device`` before any allocation) and moves
tensors card to card; ``"gloo"`` serves ranks that share one device - the
CPU, or one card, where each CUDA tensor of a collective is staged through
the host, since gloo's point-to-point calls take host tensors only (a
reshard's pieces go by CUDA IPC handle instead, ``send_recv``). A bool
tensor crosses as its bytes.

:meth:`DistGroup.run` sends each rank its arguments and runs a module-level
``fn(rank, comm, *args)`` there (a closure does not pickle). Tensors go
through the ranks' pipes by handle (``torch.multiprocessing``'s reducers):
a CUDA tensor as a CUDA IPC handle, a CPU tensor as shared memory (its
storage moves there, its values unchanged). A rank copies its arguments
onto its device - on the card it shares with the caller device to device,
from another card peer to peer - so the caller's tensors stay as they were;
its results come back the same way and are copied onto the group's
``home`` device, so they outlive the group. A call may instead keep
results on the ranks: each rank holds a registry of blocks by handle id on
its own device (``parallel/placed.py``'s ``MeshArray``), which later calls
name by :class:`~tracking_tpu_torch.parallel.placed.Ref`, so a state kept
there crosses nothing between calls. Each rank takes an equal share
of the parent's intra-op threads. The environment's ``TRACKING_TPU_*``
switches go with each call. The parent builds the CUDA kernels before the
workers start; the workers only load them. A rank that raises fails the
call with its exception (its traceback in a note), and the group is torn
down; a collective that waits longer than ``timeout`` raises in its rank.
The workers import neither JAX nor the JAX package.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
import weakref
from multiprocessing.connection import wait
from multiprocessing.reduction import ForkingPickler
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tracking_tpu_torch.ops import _native
from tracking_tpu_torch.parallel.mesh import Collectives
from tracking_tpu_torch.parallel.placed import Ref, map_tensors, mesh_coords, owned, tensor_bytes

BACKENDS = ("nccl", "gloo")
SWITCHES = "TRACKING_TPU_"  # the environment switches that go with each call


def check_backend(backend: str, devices: Sequence[torch.device]) -> None:
    """Raise unless ``backend`` can carry ranks on ``devices``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' puts one rank on each card, and no card is available")
        if not dist.is_nccl_available():
            raise RuntimeError("backend 'nccl': this torch has no NCCL")
        if len(devices) > torch.cuda.device_count():
            raise RuntimeError(f"backend 'nccl' puts one rank on each card: {len(devices)} ranks, "
                               f"{torch.cuda.device_count()} cards")
        if any(d.type != "cuda" for d in devices) or len({d.index for d in devices}) != len(devices):
            raise ValueError(f"backend 'nccl' needs one card a rank, got {[str(d) for d in devices]}")


class DistComm(Collectives):
    """One rank's handle on a process group (all ranks, or one mesh axis's:
    :meth:`axis`): ``rank``, ``n``, ``coords`` and the collectives.
    ``sent``: the bytes the rank has sent other ranks (a one-element list
    that the world's handle, its layouts and their views share; the worker
    sets it to 0 as each call starts)."""

    def __init__(self, rank: int, members: List[int], group, coords: Dict[str, int], device: torch.device,
                 staged: bool, sent: List[int]):
        self.rank = rank
        self.n = len(members)
        self.coords = coords
        self.device = device
        self._members = members  # global ranks, in this group's rank order
        self._group = group
        self._staged = staged
        self.sent = sent
        self._views: Dict[str, "DistComm"] = {}

    def axis(self, name: str) -> "DistComm":
        if name not in self._views:
            raise ValueError(f"no mesh axis {name!r} in this group")
        return self._views[name]

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        w = x.detach().contiguous().reshape(-1)
        if w.dtype == torch.bool:
            w = w.view(torch.uint8)
        return w.cpu() if self._staged else w

    def _unwire(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        w = w.to(like.device)
        if like.dtype == torch.bool:
            w = w.view(torch.bool)
        return w.reshape(like.shape)

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        w = self._wire(x)
        out = [torch.empty_like(w) for _ in range(self.n)]
        dist.all_gather(out, w, group=self._group)
        self.sent[0] += w.numel() * w.element_size() * (self.n - 1)
        return [self._unwire(o, x) for o in out]

    def _p2p(self, sends: Dict[int, torch.Tensor], recvs: Dict[int, torch.Tensor], count: bool = True) -> None:
        """One batch of sends and receives by this group's rank numbers (a
        rank with none enters no batch); the sends' bytes count in
        ``sent`` where ``count``."""
        ops = [dist.P2POp(dist.isend, w, self._members[r], self._group) for r, w in sends.items()]
        ops += [dist.P2POp(dist.irecv, buf, self._members[r], self._group) for r, buf in recvs.items()]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if count:
            self.sent[0] += sum(w.numel() * w.element_size() for w in sends.values())

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        w = self._wire(x)
        dst, src = self.rank + shift, self.rank - shift
        buf = torch.empty_like(w) if 0 <= src < self.n else None
        self._p2p({dst: w} if 0 <= dst < self.n else {}, {} if buf is None else {src: buf})
        return torch.zeros_like(x) if buf is None else self._unwire(buf, x)

    def send_recv(self, sends: Dict[int, torch.Tensor], sizes: Dict[int, int]) -> Dict[int, torch.Tensor]:
        """Point to point in one batch: ``sends`` {rank: uint8 bytes on this
        rank's device} out, and from each rank of ``sizes`` {rank: bytes}
        its bytes in, returned on this rank's device (a reshard's pieces,
        ``parallel/placed.py``). NCCL and gloo on the CPU carry the bytes
        themselves. Gloo ranks that share a card send each other CUDA IPC
        handles instead (:meth:`_send_recv_ipc`): gloo would stage every
        byte through the host at both ends."""
        if self._staged:
            return self._send_recv_ipc(sends, sizes)
        recvs = {r: torch.empty(nb, dtype=torch.uint8, device=self.device) for r, nb in sizes.items()}
        self._p2p(sends, recvs)
        return recvs

    def _send_recv_ipc(self, sends: Dict[int, torch.Tensor], sizes: Dict[int, int]) -> Dict[int, torch.Tensor]:
        """:meth:`send_recv` between processes on one card: each send goes
        as its CUDA IPC handle (``torch.multiprocessing``'s reducer, the
        hand-offs' channel; its length, then its bytes, over gloo), the
        receiver copies the bytes on the card from the sender's memory,
        and a barrier after the copies lets the senders free theirs."""
        handles = {r: torch.frombuffer(bytearray(ForkingPickler.dumps(w)), dtype=torch.uint8)
                   for r, w in sends.items()}
        lengths = {r: torch.empty(1, dtype=torch.int64) for r in sizes}
        self._p2p({r: torch.tensor([h.numel()]) for r, h in handles.items()}, lengths, count=False)
        bufs = {r: torch.empty(int(n), dtype=torch.uint8) for r, n in lengths.items()}
        self._p2p(handles, bufs, count=False)
        out = {}
        for r, buf in bufs.items():
            there = ForkingPickler.loads(buf.numpy().tobytes())
            if there.numel() != sizes[r]:
                raise RuntimeError(f"rank {self.rank} expected {sizes[r]} bytes from rank {r}, got {there.numel()}")
            out[r] = there.clone()
            del there
        _sync(self.device)
        dist.barrier(group=self._group)
        self.sent[0] += sum(w.numel() for w in sends.values())
        return out


def _axis_groups(axes: Dict[str, int], name: str) -> List[List[int]]:
    """The rank lists of mesh axis ``name``'s groups (those that share the
    other coordinates), each in rank order along ``name``."""
    groups: Dict[tuple, List[int]] = {}
    for r in range(math.prod(axes.values())):
        c = mesh_coords(r, axes)
        groups.setdefault(tuple(v for k, v in c.items() if k != name), []).append(r)
    return list(groups.values())


def _join(rank: int, n: int, backend: str, init_method: str, device: torch.device, timeout: float) -> DistComm:
    """Join the process group; one collective opens its communicator.
    Every rank runs on this host, so gloo talks over the loopback device
    unless the caller named another (a host name may resolve to none)."""
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    world = DistComm(rank, list(range(n)), None, {}, device, backend == "gloo" and device.type == "cuda", [0])
    world.all_gather(torch.zeros(1, device=device))
    return world


def _layout(world: DistComm, axes: Dict[str, int]) -> DistComm:
    """The world's ranks as a mesh of ``axes``: a handle with the rank's
    coordinates and a group for each axis. Every rank makes every group of
    the layout, in one order, then runs one collective on each of its own
    to open its communicator before any point-to-point batch."""
    coords = mesh_coords(world.rank, axes)
    comm = DistComm(world.rank, world._members, None, coords, world.device, world._staged, world.sent)
    for name in axes:
        for members in _axis_groups(axes, name):
            group = dist.new_group(members)
            if world.rank in members:
                comm._views[name] = DistComm(members.index(world.rank), members, group, coords, world.device,
                                             world._staged, world.sent)
    for view in comm._views.values():
        view.all_gather(torch.zeros(1, device=world.device))
    return comm


def _error(e: BaseException, rank: int) -> BaseException:
    """``e`` with the rank's traceback as a note, or a RuntimeError that
    carries it where ``e`` does not pickle."""
    text = f"in rank {rank}:\n{traceback.format_exc()}"
    try:
        e.add_note(text)
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:  # noqa: BLE001 - any pickling failure: send the text
        return RuntimeError(f"{type(e).__name__}: {e}\n{text}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolve(registry: dict, rank: int):
    """A :class:`Ref` -> the rank's block of that handle (a clone where the
    ref asks); a handle the rank does not hold raises."""

    def one(ref: Ref):
        if ref.hid not in registry:
            raise RuntimeError(f"rank {rank} holds no block of placed handle {ref.hid}")
        block = registry[ref.hid]
        return map_tensors(torch.clone, block) if ref.clone else block

    return one


def _worker(rank: int, n: int, backend: str, init_method: str, device: torch.device, timeout: float,
            threads: int, conn) -> None:
    """A rank's process: join, report ready, then run calls until ``None``
    (each layout's groups made at its first call). The registry holds the
    rank's blocks of placed handles by id: a call's ``drop`` ids leave it
    first, its :class:`Ref` arguments name entries, and its results at the
    indices of ``keep`` enter it under their ids. A call with no function
    only drops, and reports the ids held."""
    torch.set_num_threads(threads)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            _native.library()  # built by the parent
        world = _join(rank, n, backend, init_method, device, timeout)
    except BaseException as e:  # noqa: BLE001 - reported to the parent, which raises it
        conn.send(("err", _error(e, rank)))
        return
    conn.send(("ready", None))
    layouts: Dict[tuple, DistComm] = {}
    registry: dict = {}
    try:
        for fn, args, axes, env, keep, drop in iter(conn.recv, None):
            for hid in drop:
                registry.pop(hid, None)
            if fn is None:
                conn.send(("ok", sorted(registry), None))
                continue
            for k in [k for k in os.environ if k.startswith(SWITCHES) and k not in env]:
                del os.environ[k]
            os.environ.update(env)
            try:
                key = tuple(axes.items())
                if key not in layouts:
                    layouts[key] = _layout(world, axes)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                args = map_tensors(lambda t: owned(t, device), args)  # the rank's own copies
                args = map_tensors(_resolve(registry, rank), args, leaf=Ref)
                _sync(device)
                # every rank holds its arguments before any starts, so the
                # ranks' windows run together
                world.all_gather(torch.zeros(1, device=device))
                t_ready = time.perf_counter()
                _native.reset_launches()
                world.sent[0] = 0
                out = fn(rank, layouts[key], *args)
                del args
                _sync(device)
                t_done = time.perf_counter()
                for i, hid in keep.items():
                    registry[hid] = None if out is None else out[i]
                if keep and out is not None:
                    out = tuple(None if i in keep else v for i, v in enumerate(out))
                stats = {"t_ready": t_ready, "t_done": t_done, "launches": dict(_native.LAUNCHES),
                         "sent": world.sent[0]}
                if device.type == "cuda":
                    free, total = torch.cuda.mem_get_info(device)
                    stats.update(peak_allocated=torch.cuda.max_memory_allocated(device),
                                 peak_reserved=torch.cuda.max_memory_reserved(device), device_used=total - free)
                conn.send(("ok", out, stats))
                del out
            except BaseException as e:  # noqa: BLE001 - reported to the parent, which raises it
                conn.send(("err", _error(e, rank)))
    finally:
        dist.destroy_process_group()


def _shutdown(procs, conns, tmpdir: str, graceful: bool) -> None:
    """End the workers (``None`` to each, then a wait; else terminate),
    close the pipes and remove the store's directory."""
    if graceful:
        for conn in conns:
            try:
                conn.send(None)
            except OSError:
                pass
    for p in procs:
        if graceful:
            p.join(10)
        if p.is_alive():
            p.terminate()
            p.join(5)
        if p.is_alive():
            p.kill()
            p.join()
    for conn in conns:
        conn.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


class DistGroup:
    """``n`` ranks as processes, rank r on ``devices[r]`` (module
    docstring). Each call lays the ranks out as a mesh of its ``axes``
    (default ``{"space": n}``): rank r has the row-major coordinates of r
    and a group for each axis, made at the layout's first call, so one
    group of processes serves meshes of several shapes. Results land on
    ``home``, rank 0's device. After a call, :attr:`last` holds
    its seconds on the host's monotonic clock, which every process reads
    (``in_s``: from the call to the first rank's start, when every rank
    has copied its arguments onto its device and the ranks have met in one
    collective; ``compute_s``: from the first rank's start to the last
    rank's end, each device synchronized; ``out_s``: from there to the
    results on ``home``), the kernel
    launches summed over the ranks (``launches``, each rank's counts set to
    0 when its call starts), each rank's own (``ranks``: its ``launches``)
    and its device memory (``ranks``: peak allocated and reserved bytes,
    and the device's bytes in use at the call's end, every process's
    context included), and the bytes of the
    tensors that crossed to the ranks (``bytes_in``: the arguments) and
    back (``bytes_out``: the results; blocks kept on the ranks cross
    nothing), and the bytes the ranks sent one another (``bytes_moved``:
    point-to-point messages - a reshard's pieces, halo bands - and each
    rank's share of a gather or reduction once for every other rank of its
    group). :attr:`start_s`: the seconds the workers took to start and
    join.

    Each rank keeps a registry of blocks of placed handles
    (``parallel/placed.py``): :meth:`run`'s ``keep`` enters results there,
    a :class:`Ref` argument names an entry. Ids a finalizer appended to
    :attr:`drops` leave the registries with the next message;
    :meth:`release` sends them at once, :meth:`held` reports each rank's
    ids. A rank that died takes its blocks with it, and the group's next
    call raises."""

    def __init__(self, n: int, backend: str, devices: Sequence, timeout: float = 600.0):
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{n} ranks need {n} devices, got {len(devices)}")
        check_backend(backend, devices)
        self.n, self.backend, self.devices, self.timeout = n, backend, devices, timeout
        self.home = devices[0]
        self.last: dict = {}
        self.drops: List[int] = []  # released handles' ids, for the next message
        self._next_id = 0
        if any(d.type == "cuda" for d in devices):
            _native.library()  # build once, before the workers load it
        t0 = time.perf_counter()
        self._dir = tempfile.mkdtemp(prefix="tracking_tpu_dist_")
        init_method = f"file://{os.path.join(self._dir, 'store')}"
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        self._closer = weakref.finalize(self, _shutdown, self._procs, self._conns, self._dir, True)
        threads = max(1, torch.get_num_threads() // n)  # the ranks share the host's cores
        for r in range(n):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_worker, name=f"tracking-tpu-rank-{r}", daemon=True,
                            args=(r, n, backend, init_method, devices[r], timeout, threads, there))
            p.start()
            there.close()
            self._procs.append(p)
            self._conns.append(here)
        self._collect()
        self.start_s = time.perf_counter() - t0

    @property
    def closed(self) -> bool:
        return not self._closer.alive

    def _collect(self) -> list:
        """Each rank's next message, in rank order; the first error (or a
        rank that died) tears the group down and is raised."""
        out: list = [None] * self.n
        pending = dict(zip(self._conns, range(self.n)))
        while pending:
            for conn in wait(list(pending)):
                r = pending.pop(conn)
                try:
                    msg = conn.recv()
                except EOFError:
                    msg = ("err", RuntimeError(f"rank {r} ended (exit code {self._procs[r].exitcode})"))
                if msg[0] == "err":
                    self._closer.detach()
                    _shutdown(self._procs, self._conns, self._dir, graceful=False)
                    raise msg[1]
                out[r] = msg[1:]
        return out

    def new_id(self) -> int:
        """A fresh handle id for :meth:`run`'s ``keep``."""
        self._next_id += 1
        return self._next_id

    def _send(self, msgs: Sequence) -> None:
        """Each rank its message, with the ids released since the last; a
        rank that is gone tears the group down and raises."""
        if self.closed:
            raise RuntimeError("the process group is closed")
        drop = self.drops[:]
        del self.drops[: len(drop)]
        for r, (conn, msg) in enumerate(zip(self._conns, msgs)):
            try:
                conn.send(msg + (drop,))
            except OSError as e:
                self._closer.detach()
                _shutdown(self._procs, self._conns, self._dir, graceful=False)
                raise RuntimeError(f"rank {r} is gone (exit code {self._procs[r].exitcode}); its blocks with it") from e

    def run(self, fn: Callable, *per_shard_args: Sequence, axes: Optional[Dict[str, int]] = None,
            keep: Optional[Dict[int, int]] = None) -> list:
        """``fn(rank, comm, *(a[rank] for a in per_shard_args))`` on every
        rank, ``comm`` laid out as a mesh of ``axes``; returns the results
        in rank order, on ``home``. ``keep`` ({result index: handle id})
        leaves those results in each rank's registry; they read None here."""
        axes = {"space": self.n} if axes is None else dict(axes)
        if math.prod(axes.values()) != self.n:
            raise ValueError(f"mesh axes {axes} do not hold {self.n} ranks")
        for a in per_shard_args:
            if len(a) != self.n:
                raise ValueError(f"expected {self.n} per-shard values, got {len(a)}")
        env = {k: v for k, v in os.environ.items() if k.startswith(SWITCHES)}
        args = [tuple(a[r] for a in per_shard_args) for r in range(self.n)]
        t0 = time.perf_counter()
        self._send([(fn, a, axes, env, dict(keep or {})) for a in args])
        replies = self._collect()
        results = [map_tensors(lambda t: t.to(self.home, copy=True), out) for out, _ in replies]
        for d in set(self.devices):  # the copies end before the ranks' tensors are let go
            _sync(d)
        stats = [s for _, s in replies]
        del replies  # the ranks' result tensors, which the copies replace
        start, end = min(s["t_ready"] for s in stats), max(s["t_done"] for s in stats)
        self.last = {
            "in_s": start - t0,
            "compute_s": end - start,
            "out_s": time.perf_counter() - end,
            "bytes_in": tensor_bytes(args),
            "bytes_out": tensor_bytes(results),
            "bytes_moved": sum(s["sent"] for s in stats),
            "launches": {k: sum(s["launches"][k] for s in stats) for k in stats[0]["launches"]},
            "ranks": [{k: v for k, v in s.items() if k not in ("t_ready", "t_done", "sent")} for s in stats],
        }
        return results

    def held(self) -> List[List[int]]:
        """Each rank's registry ids, after the pending releases."""
        self._send([(None, (), None, {}, {})] * self.n)
        return [ids for ids, _ in self._collect()]

    def release(self) -> None:
        """Send the pending releases now."""
        self.held()

    def close(self) -> None:
        """End the workers; the group runs nothing more."""
        self._closer()

    def __enter__(self) -> "DistGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
