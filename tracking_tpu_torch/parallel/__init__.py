"""Row sharding of one stream (``parallel/spatial.py``) over the ranks of a
:class:`~tracking_tpu_torch.parallel.mesh.ShardGroup` (``parallel/mesh.py``),
counterpart of ``tracking_tpu/parallel``."""
