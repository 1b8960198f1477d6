"""Pipeline constants (reference: ltx_pipelines/utils/constants.py)."""

from mlx_video_tpu_torch.ltx_core.types import SpatioTemporalScaleFactors

DISTILLED_SIGMA_VALUES = [1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0]
STAGE_2_DISTILLED_SIGMA_VALUES = [0.909375, 0.725, 0.421875, 0.0]

DEFAULT_SEED = 10
DEFAULT_1_STAGE_HEIGHT = 512
DEFAULT_1_STAGE_WIDTH = 768
DEFAULT_2_STAGE_HEIGHT = DEFAULT_1_STAGE_HEIGHT * 2
DEFAULT_2_STAGE_WIDTH = DEFAULT_1_STAGE_WIDTH * 2
DEFAULT_NUM_FRAMES = 121
DEFAULT_FRAME_RATE = 24.0
DEFAULT_NUM_INFERENCE_STEPS = 40
DEFAULT_CFG_GUIDANCE_SCALE = 4.0

AUDIO_SAMPLE_RATE = 24000
VIDEO_LATENT_CHANNELS = 128
VIDEO_SCALE_FACTORS = SpatioTemporalScaleFactors.default()

DEFAULT_LORA_STRENGTH = 1.0

# CRF for the H.264 round trip applied to conditioning images — mimics video
# compression artifacts (reference: ltx_pipelines/utils/constants.py).
DEFAULT_IMAGE_CRF = 33

from mlx_video_tpu_torch.pipelines.prompts import DEFAULT_NEGATIVE_PROMPT  # noqa: E402,F401
