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
each microbatch's batch over ``data``. The VideoOnly DiT, inference only
(the GPipe backward comes with the sharded trainer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mlx_video_tpu_torch.config import LTXModelConfig
from mlx_video_tpu_torch.models.ltx.model import (
    LTXModel,
    Modality,
    _prepare_modality,
    _process_output,
    batch_slice,
    local_block_args,
    run_blocks,
)
from mlx_video_tpu_torch.parallel import SERVER_ITEM
from mlx_video_tpu_torch.parallel.collectives import mesh_groups
from mlx_video_tpu_torch.parallel.distributed import default_device_type, ensure_world
from mlx_video_tpu_torch.parallel.sharding import _clone_tree, _shard, gather


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
    (video, None) velocity on every rank."""
    if audio is not None or video is None:
        raise ValueError(f"the pipelined forward runs the video DiT only: audio waits for the AV DiT's sharded "
                         f"forward ({SERVER_ITEM})")
    mesh, axis = model.mesh, model.pipe_axis
    pipe = mesh.group(axis)
    p_size, stage = mesh.size(axis), mesh.index(axis)
    m = int(num_microbatches) if num_microbatches else p_size
    if model.pipe_layers % p_size:
        raise ValueError(f"num_layers={model.pipe_layers} not divisible by pipe={p_size}")
    b = video.latent.shape[0]
    if b % m:
        raise ValueError(f"batch={b} not divisible by num_microbatches={m}")
    mb = b // m
    data = mesh.group(data_axis) if data_axis else None
    if data is not None and mb % data.size:
        raise ValueError(f"microbatch size {mb} not divisible by {data_axis}={data.size}")
    local_mb = mb if data is None else mb // data.size
    specs = model.shard_specs
    tp = mesh.size("tensor")
    head = gather(model.video, specs, mesh, prefix="video.")
    args = _prepare_modality(head, video, config, config.inner_dim, config.positional_embedding_max_pos,
                             config.num_attention_heads)
    video_cfg = config.get_video_config()
    local = local_block_args(args, config.rope_type, mesh, tp, None)
    video_cfg = dataclasses.replace(video_cfg, heads=video_cfg.heads // tp)

    def micro(j: int):
        start = j * mb + (0 if data is None else data.rank * local_mb)
        return batch_slice(local, start, local_mb)

    outs = [None] * m
    state = None
    for t in range(m + p_size - 1):
        j = t - stage
        if 0 <= j < m:
            mb_args = micro(j)
            x_in = mb_args.x if stage == 0 else state
            y = run_blocks(model, mb_args._replace(x=x_in), video_cfg, config)
            if stage == p_size - 1:
                outs[j] = y
        else:  # the GPipe bubble: nothing to compute, the shift still runs
            y = state if state is not None else torch.zeros_like(micro(0).x)
        if p_size > 1:
            state = pipe.ring_shift(y)
    last = torch.cat(outs) if stage == p_size - 1 else torch.zeros(
        (m * local_mb,) + tuple(local.x.shape[1:]), dtype=local.x.dtype, device=local.x.device)
    tokens = pipe.broadcast(last, src=p_size - 1)
    if data is not None:  # (m, local_mb) -> (m, mb): each microbatch's data slices, in order
        parts = data.all_gather(tokens.reshape((m, local_mb) + tokens.shape[1:]), dim=1)
        tokens = parts.reshape((b,) + tokens.shape[1:])
    return _process_output(head, tokens, args.embedded_timestep, config.norm_eps), None


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
