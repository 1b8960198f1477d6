from mlx_video_tpu_torch.ltx_core.components.diffusion_steps import EulerDiffusionStep
from mlx_video_tpu_torch.ltx_core.components.guiders import (
    CFGGuider,
    CFGStarRescalingGuider,
    LegacyStatefulAPGGuider,
    LtxAPGGuider,
    STGGuider,
    projection_coef,
)
from mlx_video_tpu_torch.ltx_core.components.noisers import GaussianNoiser
from mlx_video_tpu_torch.ltx_core.components.patchifiers import (
    AudioPatchifier,
    VideoLatentPatchifier,
    get_pixel_coords,
)
from mlx_video_tpu_torch.ltx_core.components.protocols import (
    DiffusionStepProtocol,
    GuiderProtocol,
    Noiser,
    Patchifier,
    SchedulerProtocol,
)
from mlx_video_tpu_torch.ltx_core.components.schedulers import (
    BetaScheduler,
    LinearQuadraticScheduler,
    LTX2Scheduler,
)

__all__ = [
    "EulerDiffusionStep", "CFGGuider", "CFGStarRescalingGuider",
    "LegacyStatefulAPGGuider", "LtxAPGGuider", "STGGuider", "projection_coef",
    "GaussianNoiser", "AudioPatchifier", "VideoLatentPatchifier",
    "get_pixel_coords", "DiffusionStepProtocol", "GuiderProtocol", "Noiser",
    "Patchifier", "SchedulerProtocol", "BetaScheduler",
    "LinearQuadraticScheduler", "LTX2Scheduler",
]
