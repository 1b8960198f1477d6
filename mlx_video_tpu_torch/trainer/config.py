"""Training configuration + LTX-2-schema YAML loader.

The port's own copy of mlx_video_tpu/trainer/config.py (framework-free code,
copied whole and unchanged in behaviour), so that the port imports nothing of
the JAX package. The port's Trainer refuses, by name, the fields of features
it does not have yet (meshes, pipeline stages, validation, W&B, hub push).

Behavioral spec: reference mlx_video/mlx_trainer/trainer.py:29-91
(TrainingConfig fields) and config.py:7-172 (YAML schema mapping:
model/lora/training_strategy/optimization/acceleration/data/validation/
checkpoints/flow_matching/hub/wandb sections, target-module normalization).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Sequence


@dataclass
class TrainingConfig:
    model_repo: str = ""
    pipeline: str = "dev"
    training_mode: str = "full"  # full | lora
    strategy: str = "text_to_video"  # text_to_video | video_to_video
    with_audio: bool = False
    data_root: Optional[str] = None
    data_sources: Optional[Dict[str, str]] = None
    batch_size: int = 1
    steps: int = 100
    lr: float = 1e-5
    weight_decay: float = 0.01
    seed: int = 42
    log_every: int = 1
    output_dir: str = "./checkpoints"
    save_every: int = 100
    checkpoint_keep_last_n: int = -1
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    target_modules: Optional[Sequence[str]] = None
    grad_accum_steps: int = 1
    max_grad_norm: float = 1.0
    optimizer_type: str = "adamw"
    scheduler_type: str = "constant"
    scheduler_params: Optional[dict] = None
    enable_gradient_checkpointing: bool = False
    first_frame_conditioning_p: float = 0.1
    audio_latents_dir: str = "audio_latents"
    reference_latents_dir: str = "reference_latents"
    timestep_sampling_mode: str = "uniform"
    timestep_sampling_std: float = 1.0
    load_checkpoint: Optional[str] = None
    resume: bool = False
    dummy_width: int = 256
    dummy_height: int = 256
    dummy_num_frames: int = 9
    dummy_prompt_len: int = 256
    debug: bool = False
    validation_prompts: Optional[Sequence[str]] = None
    validation_interval: int = 0
    validation_negative_prompt: str = (
        "worst quality, inconsistent motion, blurry, jittery, distorted"
    )
    validation_skip_initial: bool = False
    validation_seed: Optional[int] = None
    validation_width: Optional[int] = None
    validation_height: Optional[int] = None
    validation_num_frames: Optional[int] = None
    validation_steps: Optional[int] = None
    validation_cfg_scale: Optional[float] = None
    validation_fps: Optional[float] = None
    wandb_enabled: bool = False
    wandb_project: str = "ltx-2-trainer"
    wandb_entity: Optional[str] = None
    wandb_tags: Optional[Sequence[str]] = None
    hub_push: bool = False
    hub_model_id: Optional[str] = None
    progress: bool = True
    mixed_precision_mode: str = "bf16"
    # Catch SIGTERM (TPU maintenance/spot reclaim), checkpoint the current
    # step on every host, and exit cleanly so a restart resumes exactly
    # (parallel/distributed.PreemptionGuard).
    handle_preemption: bool = True
    # TPU-specific (new capability): mesh shape for sharded training.
    mesh_shape: Optional[Sequence[int]] = None
    # With a mesh: ring-attention sequence parallelism over the fsdp axis
    # (long-video training).
    sequence_parallel: bool = False
    # GPipe pipeline parallelism (parallel/pipeline.py): >0 splits the block
    # stack into that many stages on a (data, pipe) mesh. Mutually exclusive
    # with mesh_shape/sequence_parallel; targets cross-slice (DCN) scale-out.
    pipeline_stages: int = 0
    # Microbatches streamed through the pipeline (default: = stages).
    pipeline_microbatches: Optional[int] = None
    # Data-parallel groups alongside the pipeline (mesh = (data, pipe)).
    pipeline_data: int = 1
    # Megatron TP / FSDP inside each pipeline stage (GSPMD auto axes of the
    # (data, pipe, fsdp, tensor) mesh; parallel/pipeline.py).
    pipeline_tensor: int = 1
    pipeline_fsdp: int = 1

    def __post_init__(self) -> None:
        # YAML 1.1 parses "2e-4" / "1e-2" as STRINGS; coerce every numeric
        # field by its annotation so a string max_grad_norm (or lora_alpha,
        # first_frame_conditioning_p, ...) cannot reach the optimizer / a
        # static jit arg as str. Covers the CLI path identically.
        import dataclasses

        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or isinstance(v, bool):
                continue
            t = str(f.type)
            try:
                if t in ("int", "Optional[int]"):
                    setattr(self, f.name, int(v))
                elif t in ("float", "Optional[float]"):
                    setattr(self, f.name, float(v))
            except (TypeError, ValueError) as e:
                raise ValueError(f"TrainingConfig.{f.name}: {e}") from None


def _normalize_target_modules(targets):
    """PT-style target names -> sanitized names (reference: config.py:16-27)."""
    if not targets:
        return targets
    out = []
    for t in targets:
        t = t.replace("to_out.0", "to_out")
        t = t.replace("ff.net.0.proj", "ff.proj_in")
        t = t.replace("ff.net.2", "ff.proj_out")
        t = t.replace("audio_ff.net.0.proj", "audio_ff.proj_in")
        t = t.replace("audio_ff.net.2", "audio_ff.proj_out")
        out.append(t)
    return out


def load_training_config(path: Path) -> TrainingConfig:
    """Load an LTX-2-trainer-schema YAML (reference: config.py:30-172)."""
    import yaml

    raw = yaml.safe_load(Path(path).read_text()) or {}
    model_cfg = raw.get("model", {})
    lora_cfg = raw.get("lora", {})
    strategy_cfg = raw.get("training_strategy", {})
    optim_cfg = raw.get("optimization", {})
    data_cfg = raw.get("data", {})
    ckpt_cfg = raw.get("checkpoints", {})
    flow_cfg = raw.get("flow_matching", {})
    val_cfg = raw.get("validation", {})
    hub_cfg = raw.get("hub", {})
    wandb_cfg = raw.get("wandb", {})
    accel_cfg = raw.get("acceleration", {})

    ts_params = flow_cfg.get("timestep_sampling_params", {}) or {}
    cfg = TrainingConfig(
        model_repo=model_cfg.get("model_path", "Lightricks/LTX-2"),
        pipeline=raw.get("pipeline", "dev"),
        training_mode=model_cfg.get("training_mode", "lora"),
        load_checkpoint=model_cfg.get("load_checkpoint"),
        strategy=strategy_cfg.get("name", "text_to_video"),
        first_frame_conditioning_p=strategy_cfg.get("first_frame_conditioning_p", 0.1),
        with_audio=strategy_cfg.get("with_audio", False),
        audio_latents_dir=strategy_cfg.get("audio_latents_dir", "audio_latents"),
        reference_latents_dir=strategy_cfg.get("reference_latents_dir", "reference_latents"),
        # YAML 1.1 parses "2e-4" as a string; coerce numerics explicitly.
        lr=float(optim_cfg.get("learning_rate", 1e-5)),
        steps=int(optim_cfg.get("steps", 100)),
        batch_size=optim_cfg.get("batch_size", 1),
        grad_accum_steps=optim_cfg.get("gradient_accumulation_steps", 1),
        max_grad_norm=optim_cfg.get("max_grad_norm", 1.0),
        optimizer_type=optim_cfg.get("optimizer_type", "adamw"),
        scheduler_type=optim_cfg.get("scheduler_type", "constant"),
        scheduler_params=optim_cfg.get("scheduler_params", {}) or {},
        enable_gradient_checkpointing=optim_cfg.get("enable_gradient_checkpointing", False),
        data_root=data_cfg.get("preprocessed_data_root"),
        data_sources=data_cfg.get("data_sources"),
        save_every=ckpt_cfg.get("interval") or 0,
        checkpoint_keep_last_n=ckpt_cfg.get("keep_last_n", -1),
        output_dir=raw.get("output_dir", "./checkpoints"),
        seed=raw.get("seed", 42),
        log_every=raw.get("log_every", 1),
        timestep_sampling_mode=flow_cfg.get("timestep_sampling_mode", "uniform"),
        timestep_sampling_std=ts_params.get("std", 1.0),
        lora_rank=lora_cfg.get("rank", 8),
        lora_alpha=lora_cfg.get("alpha", 16.0),
        lora_dropout=lora_cfg.get("dropout", 0.0),
        target_modules=_normalize_target_modules(lora_cfg.get("target_modules")),
        mixed_precision_mode=accel_cfg.get("mixed_precision_mode", "bf16"),
        validation_prompts=val_cfg.get("prompts") or None,
        validation_interval=val_cfg.get("interval") or 0,
        validation_negative_prompt=val_cfg.get(
            "negative_prompt", "worst quality, inconsistent motion, blurry, jittery, distorted"
        ),
        validation_skip_initial=val_cfg.get("skip_initial_validation", False),
        validation_seed=val_cfg.get("seed"),
        validation_width=val_cfg.get("width"),
        validation_height=val_cfg.get("height"),
        validation_num_frames=val_cfg.get("num_frames"),
        validation_steps=val_cfg.get("steps"),
        validation_cfg_scale=val_cfg.get("cfg_scale"),
        validation_fps=val_cfg.get("fps"),
        wandb_enabled=wandb_cfg.get("enabled", False),
        wandb_project=wandb_cfg.get("project", "ltx-2-trainer"),
        wandb_entity=wandb_cfg.get("entity"),
        wandb_tags=wandb_cfg.get("tags"),
        hub_push=hub_cfg.get("push_to_hub", False),
        hub_model_id=hub_cfg.get("hub_model_id"),
        mesh_shape=raw.get("mesh_shape"),
        sequence_parallel=bool(raw.get("sequence_parallel", False)),
        pipeline_stages=int(raw.get("pipeline_stages", 0) or 0),
        pipeline_microbatches=raw.get("pipeline_microbatches"),
        pipeline_data=int(raw.get("pipeline_data", 1) or 1),
        pipeline_tensor=int(raw.get("pipeline_tensor", 1) or 1),
        pipeline_fsdp=int(raw.get("pipeline_fsdp", 1) or 1),
    )

    if cfg.strategy not in {"text_to_video", "video_to_video", "ic_lora"}:
        print(f"[trainer] Warning: unsupported strategy '{cfg.strategy}', using text_to_video.")
        cfg.strategy = "text_to_video"
    if cfg.strategy == "ic_lora":
        cfg.strategy = "video_to_video"
    if cfg.training_mode not in {"full", "lora"}:
        print(f"[trainer] Warning: unsupported training_mode '{cfg.training_mode}', using lora.")
        cfg.training_mode = "lora"
    return cfg
