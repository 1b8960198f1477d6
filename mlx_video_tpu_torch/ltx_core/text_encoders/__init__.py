"""Text encoder re-exports (reference: ltx_core/text_encoders/*)."""

from mlx_video_tpu_torch.models.gemma3 import Gemma3TextConfig, gemma3_hidden_states  # noqa: F401
from mlx_video_tpu_torch.models.ltx.text_encoder import (  # noqa: F401
    LTX2TextEncoder,
    encode_tokens,
    norm_and_concat_hidden_states,
)
