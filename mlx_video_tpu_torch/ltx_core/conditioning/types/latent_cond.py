"""(reference: ltx_core/conditioning/types/latent_cond.py).

Extends the engine's replace-mode conditioning dataclass
(mlx_video_tpu_torch.pipelines.conditioning) with the reference's
token-domain ``apply_to`` protocol: the conditioning latent is patchified
and APPENDED to the state's token sequence with its own positions (time
coordinate shifted by ``frame_idx`` and divided by fps) and a
``1 - strength`` denoise mask; ``LatentTools.clear_conditioning`` trims
the appended tokens after the loop (reference: latent_cond.py:18-36). The
engine's ``apply_conditioning`` (isinstance checks) sees the subclass as
its own.
"""

from __future__ import annotations

import torch

from mlx_video_tpu_torch.pipelines.conditioning import (
    VideoConditionByLatentIndex as _EngineLatentCond,
)


class VideoConditionByLatentIndex(_EngineLatentCond):
    def apply_to(self, latent_state, latent_tools):
        from mlx_video_tpu_torch.ltx_core.types import LatentState, VideoLatentShape

        device = latent_state.latent.device
        latent = self.latent.to(device)
        tokens = latent_tools.patchifier.patchify(latent)
        # the reference takes the RAW latent grid as positions here (the
        # pixel-coordinate conversion is the keyframe variant's): latent_cond.py:20-26
        positions = latent_tools.patchifier.get_patch_grid_bounds(
            VideoLatentShape.from_shape(latent.shape), device=device
        ).float()
        positions[:, 0] = (positions[:, 0] + float(self.frame_idx)) / float(latent_tools.fps)
        mask = torch.full(tokens.shape[:2] + (1,), 1.0 - self.strength, dtype=latent.dtype, device=device)
        return LatentState(
            latent=torch.cat([latent_state.latent, tokens.to(latent_state.latent.dtype)], dim=1),
            denoise_mask=torch.cat([latent_state.denoise_mask.to(mask.dtype), mask], dim=1),
            positions=torch.cat([latent_state.positions, positions], dim=2),
            clean_latent=torch.cat([latent_state.clean_latent, tokens.to(latent_state.clean_latent.dtype)], dim=1),
        )


__all__ = ["VideoConditionByLatentIndex"]
