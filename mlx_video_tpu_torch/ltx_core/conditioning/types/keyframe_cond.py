"""(reference: ltx_core/conditioning/types/keyframe_cond.py).

Extends the engine's guide-mode conditioning dataclass with the
reference's token-domain ``apply_to``: keyframe latents are patchified and
appended with PIXEL-space positions (causal fix only at frame 0, time
shifted by ``frame_idx``, divided by fps) and a ``1 - strength`` mask
(reference: keyframe_cond.py:20-42).
"""

from __future__ import annotations

import torch

from mlx_video_tpu_torch.pipelines.conditioning import (
    VideoConditionByKeyframeIndex as _EngineKeyframeCond,
)


class VideoConditionByKeyframeIndex(_EngineKeyframeCond):
    def apply_to(self, latent_state, latent_tools):
        from mlx_video_tpu_torch.ltx_core.components.patchifiers import get_pixel_coords
        from mlx_video_tpu_torch.ltx_core.types import LatentState, VideoLatentShape

        device = latent_state.latent.device
        keyframes = self.keyframes.to(device)
        tokens = latent_tools.patchifier.patchify(keyframes)
        coords = latent_tools.patchifier.get_patch_grid_bounds(
            VideoLatentShape.from_shape(keyframes.shape), device=device
        )
        positions = get_pixel_coords(
            coords,
            latent_tools.scale_factors,
            causal_fix=latent_tools.causal_fix if self.frame_idx == 0 else False,
        ).float()
        positions[:, 0] = (positions[:, 0] + float(self.frame_idx)) / float(latent_tools.fps)
        mask = torch.full(tokens.shape[:2] + (1,), 1.0 - self.strength, dtype=keyframes.dtype, device=device)
        return LatentState(
            latent=torch.cat([latent_state.latent, tokens.to(latent_state.latent.dtype)], dim=1),
            denoise_mask=torch.cat([latent_state.denoise_mask.to(mask.dtype), mask], dim=1),
            positions=torch.cat([latent_state.positions, positions], dim=2),
            clean_latent=torch.cat([latent_state.clean_latent, tokens.to(latent_state.clean_latent.dtype)], dim=1),
        )


__all__ = ["VideoConditionByKeyframeIndex"]
