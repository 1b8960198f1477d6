"""GPipe pipeline parallelism for the DiT block stack (forward).

Counterpart of mlx_video_tpu/parallel/pipeline.py. The blocks are split
into P contiguous stages, one a rank of the ``pipe`` axis; M microbatches
stream through them. The schedule runs M + P - 1 ticks: at tick t stage i
works on microbatch t - i (a bubble tick, outside [0, M), computes
nothing) and every stage hands its output to the next by a ring shift over
``pipe`` (JAX's ``ppermute``); stage 0 takes a fresh microbatch instead of
what it receives. The pre-block projections and the output head run on
every rank, and the last stage's outputs are broadcast over ``pipe`` so
every rank returns the whole velocity.

``tensor`` (and ``fsdp``) > 1 on the mesh compose Megatron TP / FSDP inside
each stage by parallel/sharding.py's rules; ``data_axis`` additionally cuts
each microbatch's batch over ``data``. Every model type: the video and audio
streams of an AudioVideo DiT hop from stage to stage together (one ring
shift each a tick, as JAX's ``state_v`` and ``state_a``), and an AudioOnly
DiT's audio alone. Inference only (the GPipe backward comes with the
sharded trainer).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx.model import (
    LTXModel,
    Modality,
    _process_output,
    batch_slice,
    gathered_heads,
    local_block_args,
    local_configs,
    prepare_ltx_args,
    run_blocks,
)
from mlx_video_tpu_torch.parallel.collectives import mesh_groups
from mlx_video_tpu_torch.parallel.distributed import default_device_type, ensure_world
from mlx_video_tpu_torch.parallel.sharding import _clone_tree, _shard


def pipeline_mesh(num_stages: int, data: int = 1, tensor: int = 1, fsdp: int = 1,
                  device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, pipe)`` mesh, or ``(data, pipe, fsdp, tensor)`` when
    ``tensor``/``fsdp`` > 1 (TP / FSDP inside each stage), over the world."""
    device_type = device_type or default_device_type()
    have = ensure_world(device_type)
    n = data * num_stages * tensor * fsdp
    if have != n:
        raise ValueError(f"need {n} devices for (data={data}, pipe={num_stages}, fsdp={fsdp}, tensor={tensor}),"
                         f" have {have}")
    if tensor == 1 and fsdp == 1:
        return init_device_mesh(device_type, (data, num_stages), mesh_dim_names=("data", "pipe"))
    return init_device_mesh(device_type, (data, num_stages, fsdp, tensor),
                            mesh_dim_names=("data", "pipe", "fsdp", "tensor"))


def shard_params_pipeline(model: LTXModel, mesh, axis: str = "pipe") -> LTXModel:
    """This rank's stage: its contiguous blocks, each (and the non-block
    tensors) cut by parallel/sharding.py's rules over the mesh's ``fsdp`` and
    ``tensor`` axes (kept whole when both are 1). The model carries
    ``mesh``, ``pipe_axis`` and ``pipe_layers`` (the whole stack's depth). A
    model already staged on this mesh is returned as it is."""
    mg = mesh_groups(mesh)
    if getattr(model, "mesh", None) is not None:
        if model.mesh is mg and getattr(model, "pipe_axis", None) == axis:
            return model
        raise ValueError(f"the model is already sharded on {model.mesh}")
    p_size, stage = mg.size(axis), mg.index(axis)
    n_layers = len(model.blocks)
    if n_layers % p_size:
        raise ValueError(f"num_layers={n_layers} not divisible by pipe={p_size}")
    per = n_layers // p_size
    staged = _clone_tree(model, lambda name, t, _: t, recurse=False)
    staged._modules["blocks"] = nn.ModuleList(model.blocks[stage * per:(stage + 1) * per])
    out = _shard(staged, mg)
    out.pipe_axis, out.pipe_layers = axis, n_layers
    return out


def pipeline_ltx_apply(model: LTXModel, config: LTXModelConfig, video: Optional[Modality] = None,
                       audio: Optional[Modality] = None, *, num_microbatches: Optional[int] = None,
                       data_axis: Optional[str] = None):
    """DiT forward with the block stack pipeline-parallel over the staged
    model's ``pipe`` axis (:func:`shard_params_pipeline`); returns the whole
    (video, audio) velocities on every rank, None for a modality not given."""
    if video is None and audio is None:
        raise ValueError("the pipelined forward needs a video or an audio modality")
    mesh, axis = model.mesh, model.pipe_axis
    pipe = mesh.group(axis)
    p_size, stage = mesh.size(axis), mesh.index(axis)
    m = int(num_microbatches) if num_microbatches else p_size
    if model.pipe_layers % p_size:
        raise ValueError(f"num_layers={model.pipe_layers} not divisible by pipe={p_size}")
    b = (video if video is not None else audio).latent.shape[0]
    if b % m:
        raise ValueError(f"batch={b} not divisible by num_microbatches={m}")
    mb = b // m
    data = mesh.group(data_axis) if data_axis else None
    if data is not None and mb % data.size:
        raise ValueError(f"microbatch size {mb} not divisible by {data_axis}={data.size}")
    local_mb = mb if data is None else mb // data.size
    tp = mesh.size("tensor")
    heads = gathered_heads(model)
    args = prepare_ltx_args(heads, config, video, audio)
    local = [None if a is None else local_block_args(a, config.rope_type, mesh, tp, None) for a in args]
    video_cfg, audio_cfg = local_configs(config, video, audio, tp)

    def micro(a, j: int):
        return None if a is None else batch_slice(a, j * mb + (0 if data is None else data.rank * local_mb), local_mb)

    outs = [[None] * m, [None] * m]  # the last stage's (video, audio) tokens, by microbatch
    state = [None, None]
    for t in range(m + p_size - 1):
        j = t - stage
        if 0 <= j < m:
            inputs = [None if a is None else a._replace(x=a.x if stage == 0 else s)
                      for a, s in zip((micro(a, j) for a in local), state)]
            ys = run_blocks(model, *inputs, video_cfg, audio_cfg, config)
            if stage == p_size - 1:
                for k in (0, 1):
                    outs[k][j] = ys[k]
        else:  # the GPipe bubble: nothing to compute, the shifts still run
            ys = [None if a is None else (s if s is not None else torch.zeros_like(micro(a, 0).x))
                  for a, s in zip(local, state)]
        if p_size > 1:
            state = [None if y is None else pipe.ring_shift(y) for y in ys]

    def tokens(k: int) -> torch.Tensor:
        x = local[k].x
        last = torch.cat(outs[k]) if stage == p_size - 1 else torch.zeros(
            (m * local_mb,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out = pipe.broadcast(last, src=p_size - 1)
        if data is not None:  # (m, local_mb) -> (m, mb): each microbatch's data slices, in order
            parts = data.all_gather(out.reshape((m, local_mb) + out.shape[1:]), dim=1)
            out = parts.reshape((b,) + out.shape[1:])
        return out

    heads_out = (getattr(heads, "video", None), getattr(heads, "audio", None))
    return tuple(None if a is None else _process_output(h, tokens(k), a.embedded_timestep, config.norm_eps)
                 for k, (a, h) in enumerate(zip(args, heads_out)))


def apply_from_tuple(pp):
    """Adapter for the ``pp = (mesh, axis, num_microbatches[, data_axis])``
    tuple threaded through denoise: a function with ``ltx_apply``'s
    signature that runs the pipelined forward (the model is the staged one;
    ``mesh`` and ``axis`` are what it was staged on)."""
    num_mb = pp[2]
    data_axis = pp[3] if len(pp) > 3 else None

    def apply(model, config, video=None, audio=None, sp=None, pab=None):
        if pab is not None:
            raise ValueError("attn_broadcast_interval does not compose with pipeline_parallel")
        return pipeline_ltx_apply(model, config, video, audio, num_microbatches=num_mb, data_axis=data_axis)

    return apply
