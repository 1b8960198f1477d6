"""Sharded execution on torch.distributed: the counterpart of
mlx_video_tpu/parallel/ (``distributed``, ``mesh``, ``sharding``,
``ring_attention``, ``pipeline``), with the collective layer the rank-local
code runs on (``collectives``)."""

# The ROADMAP item that what is not sharded yet waits for, by title.
TRAINER_ITEM = "ROADMAP §1 queue, 'GPipe stages for the sharded trainer'"
