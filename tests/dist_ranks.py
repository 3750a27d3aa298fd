"""Rank functions for the process-group tests (``tests/test_torch_dist.py``).

A worker process receives its function by pickle, that is by module and
name, and imports this module to find it: so the functions live at module
level in a file that imports neither JAX nor the JAX package (a child that
imported a test file would import JAX with it)."""

import os
import sys
import time

import torch


def shifts(rank, comm, x, hops):
    """``ppermute`` of ``x`` by each of ``hops``, in order."""
    return [comm.ppermute(x, h) for h in hops]


def reduce_all(rank, comm, x):
    return comm.psum(x), comm.pmax(x), comm.all_gather(x), comm.all_gather(x[None], dim=1)


def rows_and_columns(rank, comm, x):
    """Each stream row runs 1 + 3·(its row) sums over its ``space`` group,
    then one sum over its column, one over everything."""
    space, stream = comm.axis("space"), comm.axis("stream")
    for _ in range(1 + 3 * comm.coords["stream"]):
        row = space.psum(x)
    return (space.rank, space.n, stream.rank, stream.n), row, space.all_gather(x), stream.psum(x), comm.psum(x)


def fail_on(rank, comm, bad):
    """Rank ``bad`` raises; the others wait in a sum."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails")
    return comm.psum(torch.ones(1))


def late_on(rank, comm, late, seconds):
    """Rank ``late`` reaches the sum ``seconds`` after the others."""
    if rank == late:
        time.sleep(seconds)
    return comm.psum(torch.ones(1))


def report(rank, comm, objs):
    """What a rank sees of the objects it was sent and of its process: each
    object's type and config, the port's consensus switches as this process
    reads them, and whether JAX or the JAX package was imported here."""
    from tracking_tpu_torch.bgs.lbsp_family import _use_fused, _use_v2

    return {
        "objs": [(type(o).__name__, o.config) for o in objs],
        "v3": _use_v2(),
        "fused": _use_fused(),
        "env": {k: v for k, v in os.environ.items() if k.startswith("TRACKING_TPU_")},
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
        "tracking_tpu": sorted(m for m in sys.modules if m == "tracking_tpu" or m.startswith("tracking_tpu.")),
    }
