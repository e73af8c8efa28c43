"""The parallel path on ``torch.distributed``; counterpart of
``physically_based_ray_tracer_tpu/parallel/``.

``mesh.py`` (process groups, the collective helpers, ``spawn_ranks``),
``shard.py`` (the pixel-sharded frame), ``resharding.py`` (ring donation of
live rays inside the bounce loop), ``object_partition.py`` (instance-
partitioned tracing) and ``scaling.py`` (the scaling harness). Nothing is
imported here, so that the integrator can import ``mesh`` and
``resharding`` without pulling in the renderer.
"""
