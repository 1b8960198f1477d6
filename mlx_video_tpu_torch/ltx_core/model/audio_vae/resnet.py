"""Audio resnet re-export (reference: ltx_core/model/audio_vae/resnet.py);
the module class ``ResnetBlock`` stands for the JAX ``init_resnet_block``."""

from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import ResnetBlock, resnet_block

__all__ = ["ResnetBlock", "resnet_block"]
