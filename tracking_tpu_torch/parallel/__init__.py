"""Streams and row shards on the ranks of a mesh, counterpart of
``tracking_tpu/parallel``: ``parallel/mesh.py``, the mesh, its thread group
(:class:`~tracking_tpu_torch.parallel.mesh.ShardGroup`, ranks on one device)
and the stream-batched runners; ``parallel/dist.py``, the process group
(one process a rank, NCCL across cards or gloo for ranks that share a
device) behind the same collectives; ``parallel/spatial.py``, row sharding
of a stream; ``parallel/placed.py``, batches and states placed on the
ranks between calls (``MeshArray``)."""

from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch, shard_video_batch  # noqa: F401
from tracking_tpu_torch.parallel.placed import MeshArray, place  # noqa: F401
