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
- SIGTERM (``handle_preemption``): parallel/distributed.py:PreemptionGuard,
  whose stop decision is OR-reduced over the world (every 8th step when
  there is more than one process), so every rank stops at the same step;
  a resume checks that every rank resumes at one step (``all_hosts_agree``).

Sharded training (``mesh_shape`` (data, fsdp, tensor), as JAX's ``Trainer``
with a mesh): the model (LoRA factors injected whole
first) is sharded over it (parallel/sharding.py:shard_params), so each rank
holds its shards of the trainable tensors and AdamW moments of the same
shapes (train_step.py). The batch goes on ``data`` when it divides: each
data rank reads its part (``iter_batches(part=)``) and the parts are
gathered, every rank draws the step's (seed, step) noise for the whole
batch, and the sharded forward takes each rank's rows, so the step is the
single-device function. ``sequence_parallel`` adds the ring over ``fsdp``.
Checkpoints are the unsharded run's files, written by the mesh's first rank
(trainer/checkpoints.py). A mesh of more than one rank needs as many
processes (``torchrun``; NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU).

Not ported yet, and refused by name: pipeline stages (GPipe training,
ROADMAP §1 queue), W&B and hub push.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from mlx_video_tpu_torch.cli.generate import PARALLEL_TRAIN
from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.io.weights import load_dit_params, load_native_params, save_dit_state
from mlx_video_tpu_torch.lora import LoRAConfig, inject_lora, load_lora_into_params, lora_file_tensors, lora_mask
from mlx_video_tpu_torch.models.ltx.model import LTXModel
from mlx_video_tpu_torch.ops.linear import Int8Linear, QuantLinear
from mlx_video_tpu_torch.parallel import distributed
from mlx_video_tpu_torch.parallel.collectives import mesh_groups
from mlx_video_tpu_torch.parallel.sharding import shard_params
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
    """The config fields that ask for what the port does not have yet, the
    parallel one with the ROADMAP item it waits for."""
    asks = {
        f"pipeline_stages ({PARALLEL_TRAIN})": cfg.pipeline_stages,
        "wandb_enabled": cfg.wandb_enabled,
        "hub_push": cfg.hub_push,
    }
    return [name for name, value in asks.items() if value]


def _check_parallel(cfg: TrainingConfig) -> None:
    """JAX's mutual-exclusion errors, and sequence parallelism only over a
    mesh (its ring runs on the mesh's ``fsdp`` axis)."""
    if cfg.pipeline_stages and cfg.mesh_shape:
        raise ValueError("pipeline_stages and mesh_shape are mutually exclusive")
    if cfg.pipeline_stages and cfg.sequence_parallel:
        raise ValueError("pipeline_stages and sequence_parallel are mutually exclusive")
    if cfg.sequence_parallel and not cfg.mesh_shape:
        raise ValueError("sequence_parallel needs mesh_shape: its ring runs over the mesh's fsdp axis")


def _training_mesh(cfg: TrainingConfig, device: torch.device):
    """The (data, fsdp, tensor) mesh of ``mesh_shape`` over the launcher's
    processes (or over this process alone at one rank)."""
    from mlx_video_tpu_torch.parallel.mesh import create_mesh

    shape = tuple(int(x) for x in cfg.mesh_shape)
    n = math.prod(shape)
    if n > 1 and not distributed.launched():
        raise NotImplementedError(
            f"mesh_shape {list(shape)} spans {n} processes and this one runs alone: the trainer starts no ranks "
            f"of its own (launch it with torchrun --nproc-per-node {n} -m mlx_video_tpu_torch.train ...)")
    return mesh_groups(create_mesh(shape, device.type))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, seeded from (seed, step) alone."""
    derived = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(derived)


def _gather_batch(sb, group):
    """Every data rank's part of a prepared batch, whole (bool masks cross
    as bytes)."""
    def whole(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype == torch.bool:
            return group.all_gather(t.to(torch.uint8), dim=0).bool()
        return group.all_gather(t, dim=0)

    return type(sb)(*(whole(t) for t in sb))


class Trainer:
    """``params`` is a built model (an ``LTXModel`` on its device) or None to
    load ``cfg.model_repo``; the model is trained in place (its shards, under
    a mesh: ``self.model``). ``device`` defaults to the model's device, else
    ``cuda`` (``cuda:LOCAL_RANK`` under a launcher). ``validation_fn(model,
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
        _check_parallel(cfg)
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
        if self.device.type == "cuda" and self.device.index is None and distributed.launched():
            self.device = torch.device("cuda", distributed.local_rank())
        self.mesh = _training_mesh(cfg, self.device) if cfg.mesh_shape else None
        self.sp = (self.mesh, "fsdp") if cfg.sequence_parallel else None

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
        if cfg.load_checkpoint:
            self._load_checkpoint(Path(cfg.load_checkpoint))
        if self.mesh is not None:
            self.model = shard_params(self.model, self.mesh)
            if self.primary:
                print(f"[trainer] mesh={self.mesh.shape} sequence_parallel={bool(self.sp)}", flush=True)
        for name, p in self.model.named_parameters():
            p.requires_grad_(trainable[name])
        self.params: Dict[str, torch.nn.Parameter] = {
            name: p for name, p in self.model.named_parameters() if trainable[name]
        }
        self.shards = None if self.mesh is None else (self.model.shard_specs, self.mesh)

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
                self.start_step = ckpt.load_train_checkpoint(latest, self.params, self.opt_state, self.shards)
                if not distributed.all_hosts_agree(self.start_step):
                    raise RuntimeError(f"the ranks resume at different steps (this one at {self.start_step} "
                                       f"from {latest})")
                if self.primary:
                    print(f"[trainer] Resumed from {latest} at step {self.start_step}")

    @property
    def primary(self) -> bool:
        """The rank that writes files: the mesh's first, or the only one."""
        if self.mesh is None:
            return distributed.is_primary_host()
        return all(self.mesh.index(a) == 0 for a in self.mesh.axes)

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

    def _data_part(self):
        """(this data rank, data ranks) when the batch goes on ``data``."""
        data = 1 if self.mesh is None else self.mesh.size("data")
        if data > 1 and self.cfg.batch_size % data == 0:
            return self.mesh.index("data"), data
        return 0, 1

    def _prepare(self, batch):
        if self.cfg.strategy == "video_to_video":
            sb = prepare_video_to_video(batch, device=self.device)
        else:
            sb = prepare_text_to_video(batch, with_audio=self.cfg.with_audio, device=self.device)
        return sb if self._data_part()[1] == 1 else _gather_batch(sb, self.mesh.group("data"))

    def train(self) -> float:
        guard = distributed.PreemptionGuard()
        if self.cfg.handle_preemption:
            guard.install()
        try:
            return self._train_loop(guard)
        finally:
            guard.uninstall()

    def _train_loop(self, guard: distributed.PreemptionGuard) -> float:
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
                skip=(step % spe) if step == self.start_step else 0, part=self._data_part(),
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
                loss, grads = grad_step(self.model, self.params, sb, draws, self.model_config, sp=self.sp)
                if accum is None:
                    accum, accum_count = grads, 1
                else:
                    accum, accum_count = accumulate_grads(accum, grads), accum_count + 1
                if (step + 1) % accum_steps == 0:
                    apply_updates(self.params, self.opt_state, accum, self.optimizer, accum_steps, self.shards)
                    accum = None

                last_loss = float(loss)
                self.loss_history.append(last_loss)
                self.step_seconds.append(time.perf_counter() - t0)
                if step % cfg.log_every == 0 and self.primary:
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
                # the stop decision is every rank's (an OR over the world)
                if cfg.handle_preemption and accum is None and guard.should_checkpoint(step):
                    self.save_checkpoint(step)
                    if self.primary:
                        marker = Path(cfg.output_dir) / "PREEMPTED"
                        marker.parent.mkdir(parents=True, exist_ok=True)
                        marker.write_text(str(step))
                        print(f"[trainer] preempted: saved step {step}, exiting for restart")
                    return last_loss
            epoch += 1

        if accum is not None:
            # the final partial window: average over what was accumulated
            apply_updates(self.params, self.opt_state, accum, self.optimizer, accum_count, self.shards)
        self.save_checkpoint(cfg.steps)
        return last_loss

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, step: int) -> None:
        """The adapter (LoRA) or the whole transformer in the native layout
        (full), plus the resume state, then pruning. Under a mesh every rank
        takes part in gathering each tensor whole, one at a time; the first
        rank alone keeps them, on the host, and writes the unsharded run's
        files. One gather of the trainables feeds both files."""
        out_dir = Path(self.cfg.output_dir)
        whole = ckpt.save_train_checkpoint(out_dir / f"state_step_{step}.safetensors", self.params, self.opt_state,
                                           step, self.shards, write=self.primary)
        if self.cfg.training_mode == "lora":
            if self.primary:
                save_safetensors(out_dir / f"lora_step_{step}.safetensors", lora_file_tensors(whole.items()))
        else:
            state = self.model.state_dict()
            rest = ckpt.gather_whole({k: t for k, t in state.items() if k not in self.params}, self.shards,
                                     keep=self.primary)
            if self.primary:
                save_dit_state(out_dir / f"transformer_step_{step}.safetensors",
                               {k: whole[k] if k in whole else rest[k] for k in state})
        if self.primary:
            ckpt.prune_checkpoints(out_dir, self.cfg.checkpoint_keep_last_n)
