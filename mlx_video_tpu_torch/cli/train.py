"""``python -m mlx_video_tpu_torch.train`` — the LoRA / full finetune CLI.

Counterpart of mlx_video_tpu/cli/train.py on the same flag names (the port's
own copy of its parser, :func:`base_parser`), plus ``--device`` (default
``cuda``; without CUDA it exits rather than train on the CPU, which takes
``--device cpu``), and ``--enable-gradient-checkpointing`` (the YAML schema's
``optimization.enable_gradient_checkpointing``, which the JAX CLI reaches only
through ``--config``). ``--config`` reads an LTX-2-schema YAML file (PyYAML is
imported only then). ``--with-audio`` trains the AudioVideo DiT over the
``--audio-latents-dir`` latents. The ``--validation-*`` flags are accepted
and, as in the JAX CLI (which builds no validation function), do nothing
here: the CLI prints one line saying so; validation runs through
``Trainer(validation_fn=ValidationSampler(...))``. Options of features the
port does not have yet (meshes, sequence parallelism, W&B, hub push) exit
with a message that names them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def base_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flag surface (mlx_video_tpu/cli/train.py:build_parser)."""
    p = argparse.ArgumentParser(description="LTX-2 trainer (TPU)")
    p.add_argument("--config", default=None, help="LTX-2-schema YAML config")
    p.add_argument("--model-repo", default="Lightricks/LTX-2")
    p.add_argument("--pipeline", default="dev", choices=["dev", "distilled"])
    p.add_argument("--training-mode", default="full", choices=["full", "lora"])
    p.add_argument("--strategy", default="text_to_video",
                   choices=["text_to_video", "video_to_video", "ic_lora"])
    p.add_argument("--with-audio", action="store_true")
    p.add_argument("--data-root", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", default="./checkpoints")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--keep-last-n", type=int, default=-1)
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--scheduler-type", default="constant",
                   choices=["constant", "linear", "cosine"])
    p.add_argument("--timestep-sampling-mode", default="uniform",
                   choices=["uniform", "shifted_logit_normal"])
    p.add_argument("--timestep-sampling-std", type=float, default=1.0)
    p.add_argument("--first-frame-conditioning-p", type=float, default=0.1)
    p.add_argument("--lora-dropout", type=float, default=0.0)
    p.add_argument("--target-modules", nargs="*", default=None)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--no-progress", action="store_true")
    p.add_argument("--load-checkpoint", default=None,
                   help="LoRA/full checkpoint to initialize from")
    p.add_argument("--data-sources", nargs="*", default=None,
                   help="Data source dir names (default: latents conditions)")
    p.add_argument("--audio-latents-dir", default="audio_latents")
    p.add_argument("--reference-latents-dir", default="reference_latents")
    # dummy-dataset geometry (reference: trainer.py DummyDataset flags)
    p.add_argument("--dummy-width", type=int, default=256)
    p.add_argument("--dummy-height", type=int, default=256)
    p.add_argument("--dummy-num-frames", type=int, default=9)
    p.add_argument("--dummy-prompt-len", type=int, default=256)
    # validation sampling
    p.add_argument("--validation-prompts", nargs="*", default=None)
    p.add_argument("--validation-interval", type=int, default=0)
    p.add_argument("--validation-negative-prompt", default=None)
    p.add_argument("--validation-skip-initial", action="store_true")
    p.add_argument("--validation-seed", type=int, default=None)
    p.add_argument("--validation-width", type=int, default=None)
    p.add_argument("--validation-height", type=int, default=None)
    p.add_argument("--validation-num-frames", type=int, default=None)
    p.add_argument("--validation-steps", type=int, default=None)
    p.add_argument("--validation-cfg-scale", type=float, default=None)
    p.add_argument("--validation-fps", type=float, default=None)
    # wandb / hub
    p.add_argument("--wandb-enabled", action="store_true")
    p.add_argument("--wandb-project", default="ltx-2-trainer")
    p.add_argument("--wandb-entity", default=None)
    p.add_argument("--wandb-tags", nargs="*", default=None)
    p.add_argument("--wandb-log-validation", action="store_true")
    p.add_argument("--hub-push", action="store_true")
    p.add_argument("--hub-model-id", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--mesh", default=None, help="data,fsdp,tensor mesh shape, e.g. 1,1,8")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="With --mesh: ring-attention sequence parallelism over "
                        "the fsdp axis (long-video training)")
    p.add_argument("--no-preemption-handler", action="store_true",
                   help="Do not catch SIGTERM for checkpoint-and-exit")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = base_parser()
    p.description = "LTX-2 trainer (PyTorch, CUDA)"
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; exits when CUDA is absent)")
    p.add_argument("--enable-gradient-checkpointing", action="store_true",
                   help="recompute each block's forward in the backward (one block's activations "
                        "held at a time)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")

    from mlx_video_tpu_torch.trainer.config import TrainingConfig, load_training_config
    from mlx_video_tpu_torch.trainer.trainer import Trainer

    if args.config:
        cfg = load_training_config(Path(args.config))
    else:
        cfg = TrainingConfig(
            model_repo=args.model_repo,
            pipeline=args.pipeline,
            training_mode=args.training_mode,
            strategy="video_to_video" if args.strategy == "ic_lora" else args.strategy,
            with_audio=args.with_audio,
            data_root=args.data_root,
            batch_size=args.batch_size,
            steps=args.steps,
            lr=args.lr,
            seed=args.seed,
            output_dir=args.output_dir,
            save_every=args.save_every,
            checkpoint_keep_last_n=args.keep_last_n,
            lora_rank=args.lora_rank,
            lora_alpha=args.lora_alpha,
            grad_accum_steps=args.grad_accum_steps,
            max_grad_norm=args.max_grad_norm,
            scheduler_type=args.scheduler_type,
            timestep_sampling_mode=args.timestep_sampling_mode,
            timestep_sampling_std=args.timestep_sampling_std,
            first_frame_conditioning_p=args.first_frame_conditioning_p,
            lora_dropout=args.lora_dropout,
            target_modules=args.target_modules,
            log_every=args.log_every,
            progress=not args.no_progress,
            load_checkpoint=args.load_checkpoint,
            data_sources={name: name for name in args.data_sources}
            if args.data_sources
            else None,
            audio_latents_dir=args.audio_latents_dir,
            reference_latents_dir=args.reference_latents_dir,
            dummy_width=args.dummy_width,
            dummy_height=args.dummy_height,
            dummy_num_frames=args.dummy_num_frames,
            dummy_prompt_len=args.dummy_prompt_len,
            validation_prompts=args.validation_prompts,
            validation_interval=args.validation_interval,
            **(
                {"validation_negative_prompt": args.validation_negative_prompt}
                if args.validation_negative_prompt is not None
                else {}
            ),
            validation_skip_initial=args.validation_skip_initial,
            validation_seed=args.validation_seed,
            validation_width=args.validation_width,
            validation_height=args.validation_height,
            validation_num_frames=args.validation_num_frames,
            validation_steps=args.validation_steps,
            validation_cfg_scale=args.validation_cfg_scale,
            validation_fps=args.validation_fps,
            wandb_enabled=args.wandb_enabled,
            wandb_project=args.wandb_project,
            wandb_entity=args.wandb_entity,
            wandb_tags=args.wandb_tags,
            hub_push=args.hub_push,
            hub_model_id=args.hub_model_id,
            resume=args.resume,
            debug=args.debug,
            mesh_shape=[int(x) for x in args.mesh.split(",")] if args.mesh else None,
            sequence_parallel=args.sequence_parallel,
            handle_preemption=not args.no_preemption_handler,
            enable_gradient_checkpointing=args.enable_gradient_checkpointing,
        )

    if cfg.validation_prompts or cfg.validation_interval:
        print("train: the --validation-* options are accepted but, as in the JAX CLI, run no validation "
              "(the CLI builds no validation function; pass Trainer(validation_fn=ValidationSampler(...)) "
              "from Python)", flush=True)
    try:
        trainer = Trainer(cfg, device=device)
    except NotImplementedError as e:
        raise SystemExit(f"train: {e}")
    final_loss = trainer.train()
    print(f"Training complete. final loss={final_loss:.6f}")


if __name__ == "__main__":
    main()
