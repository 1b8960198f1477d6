"""Feed-forward re-export (reference: ltx_core/model/transformer/feed_forward.py);
the module class ``FeedForward`` stands for the JAX ``init_feed_forward``."""

from mlx_video_tpu_torch.models.ltx.model import FeedForward, feed_forward_apply

__all__ = ["FeedForward", "feed_forward_apply"]
