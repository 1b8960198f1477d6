"""Video VAE re-exports (reference: ltx_core/model/video_vae/__init__.py).

The engine's encoder and decoder are ``nn.Module``s run by plain functions
(mlx_video_tpu_torch/models/ltx/video_vae/); ``VideoEncoder`` and
``VideoDecoder`` here are the reference's class surface over them, binding
an engine module in place or drawing a fresh one on ``device`` (the card
when None) from ``generator``, which must lie there (seed 0 there when not
given).
"""

import torch

from mlx_video_tpu_torch.ltx_core.utils import device_or_card
from mlx_video_tpu_torch.models.ltx.video_vae import ops
from mlx_video_tpu_torch.models.ltx.video_vae.blocks import (
    depth_to_space_upsample,
    pixel_norm,
    resnet_block,
    space_to_depth_downsample,
)
from mlx_video_tpu_torch.models.ltx.video_vae.conv import causal_conv3d
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
    DecoderConfig,
    init_video_decoder,
    video_decoder_apply,
)
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import (
    init_video_encoder,
    video_encoder_apply,
)
from mlx_video_tpu_torch.models.ltx.video_vae.tiling import (
    SpatialTilingConfig,
    TemporalTilingConfig,
    TilingConfig,
    decode_with_tiling,
)

# Minimal compat constants (reference: video_vae/__init__.py:12-14).
VAE_ENCODER_COMFY_KEYS_FILTER: dict = {}
VAE_DECODER_COMFY_KEYS_FILTER: dict = {}


class VideoEncoderConfigurator:
    def __init__(self, *_, **__):
        pass


class VideoDecoderConfigurator:
    def __init__(self, *_, **__):
        pass


def _seeded(generator, device):
    return generator if generator is not None else torch.Generator(device).manual_seed(0)


class VideoEncoder:
    """Class-style adapter over the engine encoder (reference: a
    ``VideoEncoder`` nn.Module)."""

    def __init__(self, config=None, params=None, *, generator=None, dtype=None, device=None):
        from mlx_video_tpu_torch.config import VideoVAEConfig

        self.config = config or VideoVAEConfig()
        if params is None:
            device = device_or_card(device)
            params = init_video_encoder(_seeded(generator, device), self.config, device=device,
                                        dtype=dtype or torch.float32)
        self.params = params

    def __call__(self, video):
        return video_encoder_apply(self.params, self.config, video)


class VideoDecoder:
    """Class-style adapter over the dedicated LTX-2 decoder."""

    def __init__(self, config=None, params=None, *, generator=None, dtype=None, device=None):
        self.config = config or DecoderConfig()
        if params is None:
            device = device_or_card(device)
            params = init_video_decoder(_seeded(generator, device), self.config, device=device,
                                        dtype=dtype or torch.float32)
        self.params = params

    def __call__(self, latents, **kw):
        return video_decoder_apply(self.params, self.config, latents, **kw)

    def decode_tiled(self, latents, tiling_config=None, on_frames_ready=None, **kw):
        """Tile -> decode -> fp32 blend on the host (tiling.decode_with_tiling);
        returns (B, 3, F, H, W) fp32 numpy."""
        weight = next(self.params.parameters())

        def tile(lat):
            x = torch.from_numpy(lat).to(device=weight.device, dtype=weight.dtype)
            return video_decoder_apply(self.params, self.config, x, **kw).float().cpu().numpy()

        host = latents.float().cpu().numpy() if isinstance(latents, torch.Tensor) else latents
        return decode_with_tiling(tile, host, tiling_config or TilingConfig.default(),
                                  on_frames_ready=on_frames_ready)


__all__ = [
    "DecoderConfig",
    "SpatialTilingConfig",
    "TemporalTilingConfig",
    "TilingConfig",
    "VAE_DECODER_COMFY_KEYS_FILTER",
    "VAE_ENCODER_COMFY_KEYS_FILTER",
    "VideoDecoder",
    "VideoDecoderConfigurator",
    "VideoEncoder",
    "VideoEncoderConfigurator",
    "causal_conv3d",
    "decode_with_tiling",
    "depth_to_space_upsample",
    "init_video_decoder",
    "init_video_encoder",
    "ops",
    "pixel_norm",
    "resnet_block",
    "space_to_depth_downsample",
    "video_decoder_apply",
    "video_encoder_apply",
]
