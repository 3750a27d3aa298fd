"""Streams and row shards on the ranks of a
:class:`~tracking_tpu_torch.parallel.mesh.ShardGroup` (``parallel/mesh.py``:
the mesh and the stream-batched runners; ``parallel/spatial.py``: row
sharding of a stream), counterpart of ``tracking_tpu/parallel``."""

from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch, shard_video_batch  # noqa: F401
