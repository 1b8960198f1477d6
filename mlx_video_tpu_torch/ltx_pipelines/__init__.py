from mlx_video_tpu_torch.ltx_pipelines.bridge import MLXPipelineConfig, TPUPipelineConfig, run_generate
from mlx_video_tpu_torch.ltx_pipelines.distilled import DistilledPipeline
from mlx_video_tpu_torch.ltx_pipelines.ic_lora import ICLoraPipeline
from mlx_video_tpu_torch.ltx_pipelines.keyframe_interpolation import KeyframeInterpolationPipeline
from mlx_video_tpu_torch.ltx_pipelines.ti2vid_one_stage import TI2VidOneStage, TI2VidOneStagePipeline
from mlx_video_tpu_torch.ltx_pipelines.ti2vid_two_stages import TI2VidTwoStages, TI2VidTwoStagesPipeline
from mlx_video_tpu_torch.ltx_pipelines.utils.model_ledger import ModelLedger

__all__ = [
    "DistilledPipeline",
    "ICLoraPipeline",
    "KeyframeInterpolationPipeline",
    "TI2VidOneStage",
    "TI2VidOneStagePipeline",
    "TI2VidTwoStages",
    "TI2VidTwoStagesPipeline",
    "ModelLedger",
    "MLXPipelineConfig",
    "TPUPipelineConfig",
    "run_generate",
]
