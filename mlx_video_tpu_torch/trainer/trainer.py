"""Trainer: LoRA or full finetuning of the video or audio-video DiT over
precomputed latents, on one device.

Counterpart of mlx_video_tpu/trainer/trainer.py (``Trainer``, single device):
dataset -> model (SPLIT RoPE, VideoOnly, or AudioVideo with ``with_audio``)
-> LoRA injection (lora.py) -> AdamW with its schedule (train_step.py) -> a
loop with gradient accumulation, clip and update -> saves after the step
increment, pruning, and a final save. A ``validation_fn(model, step)`` (e.g.
trainer/validation_sampler.py) runs before the first step (unless
``validation_skip_initial`` or a resume) and after every
``validation_interval``-th step's update, as in the JAX package.

- A bf16 or a quantized base: a model with quantized or int8 linears
  (``QuantLinear``, ``Int8Linear``: frozen formats, the int8 product has no
  weight gradient) trains LoRA only, as the JAX package guards it.
- Stream-exact resume: one batch is one step, the epoch position and the
  step's draws derive from the step counter alone (the step's
  ``torch.Generator`` is seeded from (seed, step), as ``jax.random.fold_in``
  derives the JAX step's key), so a resumed run takes the same batches and the
  same noise as the uninterrupted one.
- The state file holds the trainable tensors and the optimizer state only
  (trainer/checkpoints.py); the base comes back from ``model_repo``.

Not ported yet, and refused by name: meshes, sequence parallelism, pipeline
stages, W&B and hub push.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
from mlx_video_tpu_torch.io.weights import load_dit_params, load_native_params, save_dit_params
from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora, load_lora_into_params, lora_mask, save_lora
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.ops.linear import Int8Linear, QuantLinear
from mlx_video_tpu_torch.trainer import checkpoints as ckpt
from mlx_video_tpu_torch.trainer.config import TrainingConfig
from mlx_video_tpu_torch.trainer.datasets import (
    DummyDataset,
    PrecomputedDataset,
    iter_batches,
    num_batches_per_epoch,
)
from mlx_video_tpu_torch.trainer.strategies import draw_inputs, prepare_text_to_video, prepare_video_to_video
from mlx_video_tpu_torch.trainer.train_step import (
    accumulate_grads,
    apply_updates,
    grad_step,
    make_lr_schedule,
    make_optimizer,
)


def build_model_config(cfg: TrainingConfig) -> LTXModelConfig:
    """The 48-layer SPLIT-RoPE DiT configuration, AudioVideo with
    ``with_audio``."""
    return LTXModelConfig(model_type=LTXModelType.AudioVideo if cfg.with_audio else LTXModelType.VideoOnly,
                          rope_type=LTXRopeType.SPLIT, double_precision_rope=True)


def _unported(cfg: TrainingConfig) -> list:
    """The config fields that ask for what the port does not have yet."""
    asks = {
        "mesh_shape": cfg.mesh_shape,
        "sequence_parallel": cfg.sequence_parallel,
        "pipeline_stages": cfg.pipeline_stages,
        "wandb_enabled": cfg.wandb_enabled,
        "hub_push": cfg.hub_push,
    }
    return [name for name, value in asks.items() if value]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, seeded from (seed, step) alone."""
    derived = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(derived)


class PreemptionGuard:
    """SIGTERM -> a cooperative checkpoint request (single process)."""

    def __init__(self) -> None:
        self._previous = None
        self.preempted = False

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002 (signal API)
        self.preempted = True

    def install(self) -> None:
        self._previous = signal.signal(signal.SIGTERM, self._on_signal)

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None


class Trainer:
    """``params`` is a built model (an ``LTXModel`` on its device) or None to
    load ``cfg.model_repo``; the model is trained in place. ``device``
    defaults to the model's device, else ``cuda``. ``validation_fn(model,
    step)`` gets the model under training (its adapters attached)."""

    def __init__(
        self,
        cfg: TrainingConfig,
        model_config: Optional[LTXModelConfig] = None,
        params: Optional[LTXModel] = None,
        dataset=None,
        validation_fn=None,
        device=None,
    ) -> None:
        unported = _unported(cfg)
        if unported:
            raise NotImplementedError(f"not ported to mlx_video_tpu_torch yet: {', '.join(unported)}")
        if cfg.training_mode not in ("lora", "full"):
            raise ValueError(f"training_mode must be 'lora' or 'full', got {cfg.training_mode!r}")
        if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
            raise ValueError("TF32 is on: the fp32 LoRA products must run in full fp32 (the JAX package's "
                             "Precision.HIGHEST); set torch.backends.cuda.matmul.allow_tf32 = False")
        self.cfg = cfg
        self.validation_fn = validation_fn
        self.model_config = model_config or build_model_config(cfg)
        if cfg.enable_gradient_checkpointing and not self.model_config.gradient_checkpointing:
            self.model_config = dataclasses.replace(self.model_config, gradient_checkpointing=True)
        if device is None:
            device = params.video.scale_shift_table.device if params is not None else "cuda"
        self.device = torch.device(device)

        self.dataset = dataset if dataset is not None else self._load_dataset()
        self.model = params if params is not None else self._load_params()

        if cfg.training_mode != "lora" and any(isinstance(m, (QuantLinear, Int8Linear)) for m in self.model.modules()):
            raise ValueError("Quantized base weights support LoRA training only.")

        if cfg.training_mode == "lora":
            inject_lora(
                self.model,
                self.model_config,
                LoRAConfig(
                    rank=cfg.lora_rank,
                    alpha=cfg.lora_alpha,
                    dropout=cfg.lora_dropout,
                    target_modules=tuple(cfg.target_modules) if cfg.target_modules else None,
                ),
                torch.Generator().manual_seed(cfg.seed),
            )
            trainable = lora_mask(self.model)
        else:
            trainable = {name: p.is_floating_point() for name, p in self.model.named_parameters()}
        for name, p in self.model.named_parameters():
            p.requires_grad_(trainable[name])
        self.params: Dict[str, torch.nn.Parameter] = {
            name: p for name, p in self.model.named_parameters() if trainable[name]
        }

        if cfg.load_checkpoint:
            self._load_checkpoint(Path(cfg.load_checkpoint))

        self.optimizer = make_optimizer(
            learning_rate=make_lr_schedule(cfg.scheduler_type, cfg.lr, cfg.steps),
            weight_decay=cfg.weight_decay,
            max_grad_norm=cfg.max_grad_norm,
        )
        self.opt_state = self.optimizer.init(self.params)
        self.start_step = 0
        if cfg.resume:
            latest = ckpt.latest_checkpoint(Path(cfg.output_dir))
            if latest is not None:
                self.start_step = ckpt.load_train_checkpoint(latest, self.params, self.opt_state)
                print(f"[trainer] Resumed from {latest} at step {self.start_step}")

    # -- setup ------------------------------------------------------------

    def _load_dataset(self):
        cfg = self.cfg
        if cfg.data_root:
            sources = cfg.data_sources
            if sources is None:
                sources = {"latents": "latents", "conditions": "conditions"}
                if cfg.with_audio:
                    sources[cfg.audio_latents_dir] = "audio_latents"
                if cfg.strategy == "video_to_video":
                    sources[cfg.reference_latents_dir] = "ref_latents"
            return PrecomputedDataset(cfg.data_root, sources)
        return DummyDataset(
            width=cfg.dummy_width,
            height=cfg.dummy_height,
            num_frames=cfg.dummy_num_frames,
            prompt_sequence_length=cfg.dummy_prompt_len,
            with_audio=cfg.with_audio,
            with_reference=cfg.strategy == "video_to_video",
        )

    def _dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.mixed_precision_mode == "bf16" else torch.float32

    def _load_params(self) -> LTXModel:
        """The DiT from ``model_repo`` (a file, or a directory of
        safetensors shards) on the trainer's device: PyTorch, MLX, MLX
        pre-quantized or native layout (io/weights.py); floating tensors in
        the training dtype, quantized words, scales and biases as stored.
        The skeleton reads what it has: an AudioVideo one its whole file, a
        VideoOnly one the video part of an AudioVideo file."""
        path = Path(self.cfg.model_repo)
        if not path.exists():
            raise FileNotFoundError(
                f"Model weights not found at {self.cfg.model_repo}; pass params= for in-memory init."
            )
        files = [path] if path.is_file() else sorted(path.glob("*.safetensors"))
        return load_dit_params(files, self.model_config, dtype=self._dtype(), device=self.device)

    def _load_checkpoint(self, path: Path) -> None:
        """Continue-training entry: a saved adapter replaces the injected
        factors; a full transformer export replaces every tensor."""
        if not path.exists():
            raise FileNotFoundError(f"load_checkpoint: {path} does not exist")
        with SafetensorsReader(path) as r:
            is_adapter = any(".lora_A." in k for k in r.keys())
        if is_adapter:
            if self.cfg.training_mode != "lora":
                raise ValueError("load_checkpoint points at a LoRA adapter but training_mode is 'full'")
            load_lora_into_params(self.model, path, self.model_config)
        else:
            loaded = load_native_params(path, self.model_config, dtype=self._dtype(), device=self.device)
            with torch.no_grad():
                self.model.load_state_dict(loaded.state_dict(), strict=True)
        print(f"[trainer] Loaded weights from {path}")

    # -- loop -------------------------------------------------------------

    def _prepare(self, batch):
        if self.cfg.strategy == "video_to_video":
            return prepare_video_to_video(batch, device=self.device)
        return prepare_text_to_video(batch, with_audio=self.cfg.with_audio, device=self.device)

    def train(self) -> float:
        guard = PreemptionGuard()
        if self.cfg.handle_preemption:
            guard.install()
        try:
            return self._train_loop(guard)
        finally:
            guard.uninstall()

    def _train_loop(self, guard: PreemptionGuard) -> float:
        cfg = self.cfg
        accum_steps = max(1, cfg.grad_accum_steps)
        accum = None
        accum_count = 0
        save_pending = False
        last_loss = float("nan")
        self.loss_history = deque(maxlen=4096)
        self.step_seconds = deque(maxlen=4096)  # host clock, ended by reading the loss

        validate = bool(cfg.validation_interval) and self.validation_fn is not None
        if validate and not cfg.validation_skip_initial and self.start_step == 0:
            self.validation_fn(self.model, 0)

        spe = max(1, num_batches_per_epoch(self.dataset, cfg.batch_size))
        step = self.start_step
        epoch = step // spe
        while step < cfg.steps:
            for batch in iter_batches(
                self.dataset, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                skip=(step % spe) if step == self.start_step else 0,
            ):
                if step >= cfg.steps:
                    break
                t0 = time.perf_counter()
                sb = self._prepare(batch)
                draws = draw_inputs(
                    sb, step_generator(cfg.seed, step, self.device),
                    first_frame_conditioning_p=cfg.first_frame_conditioning_p,
                    timestep_sampling_mode=cfg.timestep_sampling_mode,
                    timestep_sampling_std=cfg.timestep_sampling_std,
                )
                loss, grads = grad_step(self.model, self.params, sb, draws, self.model_config)
                if accum is None:
                    accum, accum_count = grads, 1
                else:
                    accum, accum_count = accumulate_grads(accum, grads), accum_count + 1
                if (step + 1) % accum_steps == 0:
                    apply_updates(self.params, self.opt_state, accum, self.optimizer, accum_steps)
                    accum = None

                last_loss = float(loss)
                self.loss_history.append(last_loss)
                self.step_seconds.append(time.perf_counter() - t0)
                if step % cfg.log_every == 0:
                    msg = f"step {step}: loss={last_loss:.6f}"
                    if cfg.debug:
                        msg += f" | step_time={self.step_seconds[-1]:.2f}s"
                    print(msg, flush=True)
                if validate and step > 0 and step % cfg.validation_interval == 0:
                    self.validation_fn(self.model, step)
                step += 1
                # Saves come after the increment (the label counts completed
                # steps) and only at accumulation-window boundaries: a save
                # mid-window could not carry the partial gradient sum, so it
                # waits for the boundary.
                if cfg.save_every and step % cfg.save_every == 0:
                    save_pending = True
                if save_pending and accum is None and step < cfg.steps:
                    save_pending = False
                    self.save_checkpoint(step)
                    ckpt.prune_checkpoints(Path(cfg.output_dir), cfg.checkpoint_keep_last_n)
                if cfg.handle_preemption and accum is None and guard.preempted:
                    self.save_checkpoint(step)
                    ckpt.prune_checkpoints(Path(cfg.output_dir), cfg.checkpoint_keep_last_n)
                    marker = Path(cfg.output_dir) / "PREEMPTED"
                    marker.parent.mkdir(parents=True, exist_ok=True)
                    marker.write_text(str(step))
                    print(f"[trainer] preempted: saved step {step}, exiting for restart")
                    return last_loss
            epoch += 1

        if accum is not None:
            # the final partial window: average over what was accumulated
            apply_updates(self.params, self.opt_state, accum, self.optimizer, accum_count)
        self.save_checkpoint(cfg.steps)
        ckpt.prune_checkpoints(Path(cfg.output_dir), cfg.checkpoint_keep_last_n)
        return last_loss

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, step: int) -> None:
        """The adapter (LoRA) or the whole transformer in the native layout
        (full), plus the resume state."""
        out_dir = Path(self.cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        if self.cfg.training_mode == "lora":
            save_lora(out_dir / f"lora_step_{step}.safetensors", self.model, self.model_config)
        else:
            save_dit_params(out_dir / f"transformer_step_{step}.safetensors", self.model)
        ckpt.save_train_checkpoint(out_dir / f"state_step_{step}.safetensors", self.params, self.opt_state, step)
