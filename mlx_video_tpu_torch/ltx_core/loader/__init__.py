"""Model building / loading (reference: ltx_core/loader/*).

The reference ships ``SingleGPUModelBuilder`` plus stub loaders; here the
class delegates to the port's loading layer (loading.py), on the card
unless ``device`` says otherwise.
"""

from pathlib import Path

from mlx_video_tpu_torch.loading import load_model_bundle, resolve_transformer_file, resolve_vae_file  # noqa: F401
from mlx_video_tpu_torch.pipelines.generate import PipelineType

from mlx_video_tpu_torch.ltx_core.loader.primitives import LoraPathStrengthAndSDOps  # noqa: F401

# ComfyUI-export LoRA key renaming (reference: ltx_core/loader/__init__.py:5;
# an empty map in the reference too, kept for import parity with its CLIs).
LTXV_LORA_COMFY_RENAMING_MAP: dict = {}


class SingleGPUModelBuilder:
    """Builds the full model bundle on one card (reference parity name)."""

    def __init__(self, model_path, pipeline: str = "distilled", audio: bool = False, device="cuda"):
        self.model_path = Path(model_path)
        self.pipeline = PipelineType(pipeline)
        self.audio = audio
        self.device = device

    def build(self):
        return load_model_bundle(self.model_path, pipeline=self.pipeline, audio=self.audio, device=self.device)


def fuse_loras(*args, **kwargs):
    """Use mlx_video_tpu_torch.lora.merge_lora_into_params (the reference stub raised too)."""
    raise NotImplementedError(
        "fuse_loras: use mlx_video_tpu_torch.lora.merge_lora_into_params on the model"
    )


class SafetensorsModelStateDictLoader:
    """Parity stub (reference: ltx_core/loader raise/no-op)."""

    def __init__(self, *args, **kwargs):
        pass

    def load(self, *args, **kwargs):
        raise NotImplementedError("Use mlx_video_tpu_torch.io.weights loaders")
