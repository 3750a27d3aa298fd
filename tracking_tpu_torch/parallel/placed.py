"""Trees of tensors placed on a mesh: the counterpart of a ``jax.Array``
with a ``NamedSharding`` (``tracking_tpu/parallel/mesh.py:shard_video_batch``,
and the parallel runners' ``out_specs``, which keep their states sharded).

A :class:`MeshArray` holds a tree of tensors (a frame batch, a stacked or
row-sharded state, a tracker state) as one block a rank. Its ``meta`` tree
records each leaf's global shape, dtype and ``dims``: the mesh axis that
each dim is split over, or None (``video_batch_spec()``'s B on ``stream``
and H on ``space``; a row-sharded state leaf's rows on ``space``). An axis
of size 1 splits nothing and reads as None. A leaf is replicated over each
mesh axis its dims do not name: every rank along that axis holds a copy,
and the copy at coordinate 0 is the one :func:`join` reads. ``holders``
are the ranks that hold blocks at all (a stream batch's states on a mesh
with a ``space`` axis live on its ``space`` 0 ranks only); the others hold
None.

On a thread mesh the blocks are tensors on the mesh's one device. On a
process mesh (``parallel/dist.py``) each rank keeps its block in a
registry on its own device under the handle's id, and the parent holds
the id and ``meta`` and no tensor: a call names the block by a
:class:`Ref`, which the rank resolves. A handle is released by
:meth:`MeshArray.delete` (at once) or when it is garbage-collected: its
finalizer only appends the id to the group's list, which goes out with
the group's next message (a send from a GC callback could interleave with
a send under way and corrupt the pipe). Closing the mesh frees every
block. A deleted handle, or one whose group is closed, raises where it is
used; so does a handle passed to a call on other ranks (a thread mesh's
handle on a process mesh, another process group, another device).

A handle moves to another layout of the same ranks (``Mesh.split`` of its
group, or any thread mesh on its device) with :meth:`MeshArray.reshard`,
the counterpart of ``jax.device_put`` of a sharded array onto another
``NamedSharding``; the runners reshard a placed input that a call needs
laid out otherwise, as JAX's ``jit`` does. Only the pieces whose owner
changes move: each rank intersects every block it holds with every block
it must hold (:func:`reshard_plan`, from the two metas alone), copies what
stays, and sends the rest rank to rank (``DistComm.send_recv``: NCCL peer
to peer between cards; between gloo ranks that share a card, a CUDA IPC
handle, the receiver copying on the card; gloo on the CPU). A replicated
leaf's source is its copy at coordinate 0, the one :func:`join` reads.
Nothing crosses the parent, and the old handle keeps its blocks.

The runners (``parallel/mesh.py``, ``parallel/spatial.py``) take placed
frames and states and keep their states placed; each rank steps a clone
of its resident state block (JAX arrays are immutable, and the kernels
update state banks in place), so a handle still holds its state after a
call and running it twice gives the same result.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def map_tensors(fn, tree, leaf=torch.Tensor):
    """``fn`` on every ``leaf`` (a tensor) of a tree of dicts, lists, tuples
    and named tuples; other leaves as they are."""
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v, leaf) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v, leaf) for v in tree)
    return tree


def tensor_bytes(tree) -> int:
    """The bytes of the tensors of a tree (each tensor's own elements)."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()

    map_tensors(add, tree)
    return total


def mesh_coords(rank: int, axes: Dict[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s row-major coordinates on a mesh of ``axes``."""
    out = {}
    for name, size in reversed(list(axes.items())):
        out[name] = rank % size
        rank //= size
    return {k: out[k] for k in axes}


def _rank_at(coords: Dict[str, int], axes: Dict[str, int]) -> int:
    r = 0
    for name, size in axes.items():
        r = r * size + coords[name]
    return r


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A placed leaf: its global shape and dtype, and the mesh axis of each
    dim (None: not split)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    dims: Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Ref:
    """A handle's block named in a call's arguments on a process mesh: the
    rank puts its registry entry there, a clone of it where ``clone``.
    ``owner`` (the parent's :class:`MeshArray`, not sent) keeps the handle,
    and so its blocks, alive while the call's arguments are."""

    hid: int
    clone: bool = False
    owner: object = dataclasses.field(default=None, compare=False, repr=False)

    def __reduce__(self):
        return Ref, (self.hid, self.clone)


def _walk(fn, meta, *trees):
    """``fn(leaf, *blocks)`` over a meta tree and same-structured trees (a
    None tree gives None blocks)."""
    if isinstance(meta, dict):
        return {k: _walk(fn, v, *(None if t is None else t[k] for t in trees)) for k, v in meta.items()}
    if isinstance(meta, (tuple, list)):
        return type(meta)(_walk(fn, v, *(None if t is None else t[i] for t in trees)) for i, v in enumerate(meta))
    return fn(meta, *trees)


def describe(tree, rule: Callable[[Tuple[int, ...]], tuple], axes: Dict[str, int]):
    """The meta tree of a global tree of tensors (any device, ``meta``
    included): each leaf's dims are ``rule(shape)``, an axis of size 1
    read as None. Raises where a split dim does not divide."""

    def one(x):
        shape = tuple(x.shape)
        dims = tuple(d if d is not None and axes[d] > 1 else None for d in rule(shape))
        for size, d in zip(shape, dims):
            if d is not None and size % axes[d]:
                raise ValueError(f"a leaf of shape {shape} does not split over the mesh axis {d!r} of {axes[d]}")
        return Leaf(shape, x.dtype, dims)

    return map_tensors(one, tree)


def meta_leaf(shape, rule: Callable, axes: Dict[str, int], dtype=torch.uint8) -> Leaf:
    """The meta of one global leaf of ``shape`` under ``rule``."""
    return describe(torch.empty(tuple(shape), dtype=dtype, device="meta"), rule, axes)


def relaid(meta, rule: Callable, axes: Dict[str, int]):
    """A meta tree's leaves (global shapes, dtypes) under ``rule`` on a mesh
    of ``axes``."""
    return map_tensors(lambda leaf: meta_leaf(leaf.shape, rule, axes, leaf.dtype), meta, leaf=Leaf)


def leaves(meta) -> List[Leaf]:
    """A meta tree's leaves in tree order."""
    out: List[Leaf] = []
    map_tensors(out.append, meta, leaf=Leaf)
    return out


def _span(leaf: Leaf, axes: Dict[str, int], coords: Dict[str, int], d: int) -> Tuple[int, int]:
    """The global [start, end) of dim ``d`` of the block at ``coords``."""
    size, name = leaf.shape[d], leaf.dims[d]
    if name is None:
        return 0, size
    part = size // axes[name]
    return coords[name] * part, (coords[name] + 1) * part


def _pieces(old: Leaf, old_axes: Dict[str, int], new: Leaf, new_axes: Dict[str, int], dst: int):
    """The pieces of rank ``dst``'s block of a leaf under ``new``: (source
    rank, slices of its block under ``old``, slices of ``dst``'s block,
    elements). A dim split under ``old`` takes each block it crosses; an
    axis that splits no dim of ``old`` is read at coordinate 0."""
    coords = mesh_coords(dst, new_axes)
    per_dim = []
    for d in range(len(new.shape)):
        lo, hi = _span(new, new_axes, coords, d)
        name = old.dims[d]
        if name is None:
            per_dim.append([(None, lo, 0, hi - lo)])
            continue
        part = old.shape[d] // old_axes[name]
        segs, p = [], lo
        while p < hi:
            i = p // part
            end = min(hi, (i + 1) * part)
            segs.append(((name, i), p - i * part, p - lo, end - p))
            p = end
        per_dim.append(segs)
    for combo in itertools.product(*per_dim):
        src = {name: 0 for name in old_axes}
        src.update(ax for ax, _, _, _ in combo if ax is not None)
        numel = 1
        for *_, n in combo:
            numel *= n
        if numel:
            yield (_rank_at(src, old_axes), tuple(slice(a, a + n) for _, a, _, n in combo),
                   tuple(slice(b, b + n) for _, _, b, n in combo), numel)


def reshard_plan(old_meta, old_axes: Dict[str, int], old_holders: Sequence[int], new_meta,
                 new_axes: Dict[str, int], new_holders: Sequence[int]) -> list:
    """Every piece of a reshard, from the two metas alone: (leaf index in
    tree order, source rank, destination rank, source slices, destination
    slices, bytes), destinations in ``new_holders`` order. Raises where a
    piece's source holds no block."""
    plan = []
    for i, (a, b) in enumerate(zip(leaves(old_meta), leaves(new_meta))):
        for dst in new_holders:
            for src, s_sl, d_sl, numel in _pieces(a, old_axes, b, new_axes, dst):
                if src not in old_holders:
                    raise ValueError(f"rank {src} holds no block of a leaf of shape {a.shape}: it cannot be a source")
                plan.append((i, src, dst, s_sl, d_sl, numel * a.dtype.itemsize))
    return plan


def plan_bytes(plan) -> int:
    """The bytes a reshard sends rank to rank (its pieces whose source and
    destination differ)."""
    return sum(nb for _, src, dst, _, _, nb in plan if src != dst)


def _new_block(metas: List[Leaf], axes: Dict[str, int], device) -> List[torch.Tensor]:
    """Empty tensors of a rank's block of each leaf of ``metas``."""
    return [torch.empty(tuple(n if d is None else n // axes[d] for n, d in zip(leaf.shape, leaf.dims)),
                        dtype=leaf.dtype, device=device) for leaf in metas]


def _apply_plan(rank: int, plan, old: Optional[list], new_metas: List[Leaf], new_axes: Dict[str, int],
                holder: bool, exchange, device) -> Optional[list]:
    """Rank ``rank``'s block after a reshard, as a list of leaves in tree
    order (None where it is no ``holder``): its pieces of ``old`` (its old
    leaves, None where it held none) copied where the plan keeps them on
    the rank, the rest sent through ``exchange(sends, sizes)``
    ({destination: uint8 bytes}, {source: bytes expected} -> {source: uint8
    bytes}). A pair's pieces go packed in one message, the widest dtypes
    first, so that every piece starts at a multiple of its element size and
    its bytes view as its dtype."""
    new = _new_block(new_metas, new_axes, device) if holder else None
    plan = sorted(plan, key=lambda p: -new_metas[p[0]].dtype.itemsize)
    sends: Dict[int, list] = {}
    sizes: Dict[int, int] = {}
    for i, src, dst, s_sl, d_sl, nb in plan:
        if src == rank and dst == rank:
            new[i][d_sl].copy_(old[i][s_sl])
        elif src == rank:
            sends.setdefault(dst, []).append(old[i][s_sl].contiguous().reshape(-1).view(torch.uint8))
        elif dst == rank:
            sizes[src] = sizes.get(src, 0) + nb
    got = exchange({dst: torch.cat(parts) for dst, parts in sends.items()}, sizes)
    offsets = dict.fromkeys(got, 0)
    for i, src, dst, s_sl, d_sl, nb in plan:
        if dst == rank and src != rank:
            at = offsets[src]
            new[i][d_sl].copy_(got[src][at : at + nb].view(new[i].dtype).reshape(new[i][d_sl].shape))
            offsets[src] = at + nb
    return new


def block_of(tree, meta, axes: Dict[str, int], rank: int):
    """Rank ``rank``'s block of a global tree: each split dim narrowed to
    the rank's coordinate (views)."""
    coords = mesh_coords(rank, axes)

    def one(leaf, x):
        for d, name in enumerate(leaf.dims):
            if name is not None:
                size = x.shape[d] // axes[name]
                x = x.narrow(d, coords[name] * size, size)
        return x

    return _walk(one, meta, tree)


def join(blocks: Sequence, meta, axes: Dict[str, int]):
    """The global tree from the ranks' blocks (rank order): split dims
    concatenated in coordinate order, replicated leaves read at coordinate
    0 of their other axes."""
    names = list(axes)

    def one(leaf, *parts):
        def rec(fixed: dict, k: int):
            if k == len(names):
                return parts[_rank_at(fixed, axes)]
            name = names[k]
            if name not in leaf.dims:
                return rec({**fixed, name: 0}, k + 1)
            return torch.cat([rec({**fixed, name: i}, k + 1) for i in range(axes[name])], dim=leaf.dims.index(name))

        return rec({}, 0)

    return _walk(one, meta, *blocks)


def owned(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``."""
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def layout_name(mesh) -> str:
    kind = "threads" if mesh.backend is None else f"{mesh.backend} processes"
    return f"{mesh.stream} x {mesh.space} ({kind})"


def _give(rank, comm, block):
    """Rank function of :meth:`MeshArray.gather`: the rank's block."""
    return block


def _narrow(rank, comm, block, dim: int, start: int, length: int):
    """Rank function of :meth:`MeshArray.narrow`: views of the block."""
    return (map_tensors(lambda t: t.narrow(dim, start, length), block),)


def _flat(tree, meta) -> list:
    """A tree's leaves in the order of its meta tree's."""
    out: list = []
    _walk(lambda leaf, x: out.append(x), meta, tree)
    return out


def _unflat(values: Sequence, meta):
    """The tree of ``meta``'s structure with ``values`` as its leaves."""
    it = iter(values)
    return _walk(lambda leaf: next(it), meta)


def _reshard_rank(rank, comm, block, args):
    """Rank function of :meth:`MeshArray.reshard`: the rank's new block,
    kept, from its old one and its peers' pieces."""
    plan, old_meta, new_meta, new_axes, holders = args
    old = None if block is None else _flat(block, old_meta)
    new = _apply_plan(rank, plan, old, leaves(new_meta), new_axes, rank in holders, comm.send_recv, comm.device)
    return (None if new is None else _unflat(new, new_meta),)


class MeshArray:
    """A tree of tensors placed on ``mesh`` (module docstring): ``meta``
    (global shapes, dtypes, dims), ``holders`` (the ranks with blocks) and
    either the per-rank blocks (thread mesh) or the handle id under which
    every rank of the process group keeps its block. Made by
    :func:`~tracking_tpu_torch.parallel.mesh.shard_video_batch` and by the
    runners; read back with :meth:`gather`."""

    def __init__(self, mesh, meta, stash, holders: Optional[Sequence[int]] = None):
        self.mesh = mesh
        self.meta = meta
        self.holders = tuple(range(mesh.size)) if holders is None else tuple(holders)
        self._deleted = False
        if mesh.backend is None:
            self._blocks, self._pool, self._hid = list(stash), None, None
        else:
            self._blocks, self._pool, self._hid = None, mesh.group(), stash
            self._release = weakref.finalize(self, self._pool.drops.append, stash)

    @property
    def shape(self):
        """The global shape (a tree of them for a tree)."""
        return map_tensors(lambda leaf: torch.Size(leaf.shape), self.meta, leaf=Leaf)

    @property
    def layout(self) -> str:
        return layout_name(self.mesh)

    def _live(self) -> None:
        if self._deleted:
            raise RuntimeError("this placed batch was deleted")
        if self._pool is not None and self._pool.closed:
            raise RuntimeError("the process group that held this placed batch is closed: its blocks are gone")

    def _on_ranks(self, mesh) -> None:
        """Raise unless ``mesh`` lays out this handle's ranks: the same
        process group, or a thread mesh on the same device."""
        self._live()
        same = (mesh.backend is None and self.mesh.backend is None
                and torch.device(mesh.device) == torch.device(self.mesh.device)) or (
                    mesh.backend is not None and mesh._pool is self._pool)
        if not same:
            raise ValueError(f"a batch placed on the mesh {self.layout} on {self.mesh.device} was passed to a call on "
                             f"other ranks ({layout_name(mesh)} on {mesh.device})")

    def reshard(self, mesh, spec_or_rule, holders: Optional[Sequence[int]] = None) -> "MeshArray":
        """This tree laid out on ``mesh`` (a layout of the same ranks), each
        leaf split as ``spec_or_rule`` (a partition spec, or a dims rule of
        a shape) and held by ``holders`` (default every rank): the
        counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))`` on a
        sharded array. The handle itself where it is laid out so already;
        else a new one, and this one keeps its blocks (module docstring).
        On a process mesh the pieces go rank to rank in one call, whose
        ``DistGroup.last`` counts them in ``bytes_moved`` (no byte crosses
        the parent); a piece whose source holds no block raises."""
        self._on_ranks(mesh)
        rule = spec_or_rule if callable(spec_or_rule) else spec_rule(spec_or_rule)
        meta = relaid(self.meta, rule, mesh.shape)
        holders = tuple(range(mesh.size)) if holders is None else tuple(holders)
        if mesh.shape == self.mesh.shape and meta == self.meta and holders == self.holders:
            return self
        plan = reshard_plan(self.meta, self.mesh.shape, self.holders, meta, mesh.shape, holders)
        new_metas = leaves(meta)
        if self._pool is None:
            old = [None if b is None else _flat(b, self.meta) for b in self._blocks]
            blocks = [None] * mesh.size
            for dst in holders:
                new = _new_block(new_metas, mesh.shape, mesh.device)
                for i, src, to, s_sl, d_sl, _ in plan:
                    if to == dst:
                        new[i][d_sl].copy_(old[src][i][s_sl])
                blocks[dst] = _unflat(new, meta)
            return MeshArray(mesh, meta, blocks, holders)
        args = [(plan, self.meta, meta, mesh.shape, holders)] * mesh.size
        _, (hid,) = mesh.run(_reshard_rank, self.blocks(), args, keep=(0,))
        return MeshArray(mesh, meta, hid, holders)

    def blocks(self, clone: bool = False) -> list:
        """The per-rank arguments that name the blocks in a call: the blocks
        (cloned where ``clone``) on a thread mesh, :class:`Ref` on a process
        mesh."""
        self._live()
        if self._pool is not None:
            return [Ref(self._hid, clone, self)] * self.mesh.size
        if clone:
            return [map_tensors(torch.clone, b) for b in self._blocks]
        return list(self._blocks)

    def gather(self, device=None):
        """The global tree on ``device`` (default the mesh's device), the
        counterpart of ``jax.device_get``."""
        blocks = self.blocks()
        if self._pool is not None:
            blocks, _ = self.mesh.run(_give, blocks)
        device = self.mesh.device if device is None else device
        return map_tensors(lambda t: t.to(device), join(blocks, self.meta, self.mesh.shape))

    def narrow(self, dim: int, start: int, length: int) -> "MeshArray":
        """Elements ``start`` .. ``start + length`` of dim ``dim`` of every
        leaf, a dim no leaf splits (a chunk of frames of a placed batch):
        views of the blocks, placed where they are."""
        self._live()
        leaves = []
        map_tensors(leaves.append, self.meta, leaf=Leaf)
        if any(leaf.dims[dim] is not None for leaf in leaves):
            raise ValueError(f"dim {dim} is split over the mesh: narrow takes an unsplit dim")
        meta = map_tensors(lambda leaf: dataclasses.replace(
            leaf, shape=leaf.shape[:dim] + (length,) + leaf.shape[dim + 1:]), self.meta, leaf=Leaf)
        n = self.mesh.size
        if self._pool is None:
            stash = [_narrow(r, None, b, dim, start, length)[0] for r, b in enumerate(self._blocks)]
        else:
            _, (stash,) = self.mesh.run(_narrow, self.blocks(), [dim] * n, [start] * n, [length] * n, keep=(0,))
        return MeshArray(self.mesh, meta, stash, self.holders)

    def delete(self) -> None:
        """Free the blocks (on a process mesh, on the ranks at once)."""
        if self._deleted:
            return
        self._deleted = True
        if self._pool is None:
            self._blocks = None
            return
        self._release()
        if not self._pool.closed:
            self._pool.release()

    def __repr__(self) -> str:
        state = "deleted" if self._deleted else f"held by ranks {self.holders}"
        return f"MeshArray({self.shape}, {self.layout}, {state})"


def spec_rule(spec: Sequence[Optional[str]]) -> Callable:
    """The dims rule of a partition spec (``jax.sharding.PartitionSpec``'s
    tuple): its entries for a leaf's leading dims, None for the rest."""
    spec = tuple(spec)
    return lambda shape: (spec + (None,) * len(shape))[: len(shape)]


def _hold(rank, comm, block):
    """Rank function of :func:`place`: the rank's block, kept."""
    return (block,)


def place(tree, mesh, spec) -> MeshArray:
    """``tree`` placed on ``mesh``, every leaf split as ``spec`` (one mesh
    axis or None a leading dim; or a dims rule of a leaf's shape, as
    :meth:`MeshArray.reshard` takes), the counterpart of
    ``jax.device_put(x, NamedSharding(mesh, spec))``: on a thread mesh
    copies on its device; on a process mesh each rank's block goes from the
    caller's tensors to the rank's device and stays in its registry. A
    :class:`MeshArray` is resharded (:meth:`MeshArray.reshard`)."""
    if isinstance(tree, MeshArray):
        return tree.reshard(mesh, spec)
    meta = describe(tree, spec if callable(spec) else spec_rule(spec), mesh.shape)
    blocks = mesh.cut(tree, meta)
    if mesh.backend is not None:
        _, (blocks,) = mesh.run(_hold, blocks, keep=(0,))
    return MeshArray(mesh, meta, blocks)


def placed_mesh(*xs):
    """The mesh of the first :class:`MeshArray` among ``xs``, or None."""
    return next((x.mesh for x in xs if isinstance(x, MeshArray)), None)


def rank_args(mesh, x, rule: Callable, holders: Optional[Sequence[int]] = None, clone: bool = False) -> List:
    """A call's per-rank arguments for ``x``: None on every rank, a
    :class:`MeshArray`'s blocks (resharded to ``rule`` and ``holders`` on
    ``mesh`` where it is laid out otherwise, as JAX's ``jit`` reshards its
    inputs; cloned where ``clone``, while a resharded copy, which nothing
    else holds, is handed over as it is), or a plain tree cut by
    :meth:`Mesh.cut`."""
    if x is None:
        return [None] * mesh.size
    if isinstance(x, MeshArray):
        y = x.reshard(mesh, rule, holders)
        return y.blocks(clone and y is x)
    return mesh.cut(x, describe(x, rule, mesh.shape), holders)


def meta_of(x, rule: Callable, axes: Dict[str, int]):
    """The meta tree of ``x`` on a mesh of ``axes`` under ``rule``: a
    :class:`MeshArray`'s leaves, or a plain tree's (tensors of any device,
    ``meta`` included)."""
    return relaid(x.meta, rule, axes) if isinstance(x, MeshArray) else describe(x, rule, axes)
