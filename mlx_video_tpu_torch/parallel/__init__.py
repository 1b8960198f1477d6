"""Sharded execution on torch.distributed: the counterpart of
mlx_video_tpu/parallel/ (``distributed``, ``mesh``, ``sharding``,
``ring_attention``, ``pipeline``), with the collective layer the rank-local
code runs on (``collectives``)."""

# The ROADMAP items that what is not sharded yet waits for, by title.
SERVER_ITEM = "ROADMAP §1 queue, 'The server's parallel flags and the sharded AV DiT'"
TRAINER_ITEM = "ROADMAP §1 queue, 'The sharded trainer'"
