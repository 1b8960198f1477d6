"""Megatron TP / FSDP sharding of the LTX DiT's tensors over a mesh.

Counterpart of mlx_video_tpu/parallel/sharding.py, with its rules
(``_RULES``, a copy) and its ``spec_for_path`` on the JAX tree's paths:
column-parallel (out on ``tensor``) q/k/v, ``ff.proj_in`` and the adaLN
linears; row-parallel (in on ``tensor``) ``to_out`` and ``ff.proj_out``;
the other matrix axis on ``fsdp``; the stacked layer axis never sharded.

Where JAX places whole arrays with a ``NamedSharding`` and XLA inserts the
collectives, each rank here keeps its own slice of every tensor
(:func:`shard_params`) and the forward runs on the slices with explicit
collectives (parallel/collectives.py):

- the port's layouts: an ``nn.Linear`` weight and an ``Int8Linear``
  ``int8_weight`` are (out, in) where JAX's are (in, out), so their specs
  swap; the quantized leaves are MLX (out, in·bits/32) in both packages and
  keep JAX's (already swapped) spec; a block tensor is one layer of a JAX
  stack, so the stack's leading None goes;
- a slice is a new contiguous tensor (K2 refuses views); a tensor no axis
  of size > 1 cuts is kept as it is, shared with the source model;
- a block's row-parallel linears and its q/k RMSNorm weights get the
  ``tensor`` group (``tp_group``): ops/linear.py sums their outputs over it
  and ops/norms.py their sums of squares;
- the forward all-gathers a block's ``fsdp``-sharded tensors before it runs
  and drops them after (:func:`gather`), and runs the per-modality
  projections and heads on fully gathered copies;
- LoRA factors (``lora_A`` (r, in), ``lora_B`` (out, r)) follow their
  linear's ``tensor`` cut alone (:func:`factor_specs`): a column-parallel
  linear keeps B's rows of its out slice and A whole, a row-parallel one A's
  columns of its in slice and B whole; no factor is ``fsdp``-cut (JAX
  replicates them, no rule naming them).

The same rules shard the LTX-2 text encoder (models/ltx/text_encoder.py):
its Gemma-3 layers (``language_model.layers.N``, a JAX stack) run
tensor-parallel with their ``o_proj``/``down_proj`` marked row-parallel;
Gemma's q/k norms scale each head's features, so every rank keeps them whole
(JAX cuts them by the ``(q|k)_norm`` rule, where GSPMD keeps the function
whole); the embedding table, the feature extractor and the connectors are
held cut and gathered whole at use.

Quantize first, then shard (the JAX CLI's order): W8A8 per-row scales and
q4 group scales then come from whole rows.

Training (trainer/): a block's column-parallel linears get the ``tensor``
group too (``tp_copy``: ops/linear.py enters them through
collectives.copy_to), and :func:`gather` is differentiable: an ``fsdp`` cut
gathers with collectives.gather_sum (the gradient reduce-scattered back to
its shard), a ``tensor`` cut with gather_split (the whole tensor's work is
repeated alike on every rank of the group).

The conv stacks (the upsampler, the VAE decoder) stay whole on every rank
(JAX's ``replicate_params``); their activations are cut by rows of H over
``fsdp`` x ``tensor`` (:func:`spatial_spec`, :func:`shard_spatial`), the
rank-local rule of JAX's ``spatial_sharding``, and the convs exchange halo
rows (models/ltx/video_vae/conv.py).
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from mlx_video_tpu_torch.parallel.collectives import MeshGroups, gather_split, gather_sum, mesh_groups

Spec = Tuple[Optional[str], ...]

# Ordered (pattern, spec-for-matrix) rules matched against "/"-joined JAX tree
# paths. Specs are written for the *unstacked* (in, out) / vector layout; a
# leading layer axis (blocks) gets None prepended automatically.
_RULES = [
    # attention projections
    (r"(audio_)?attn\d/to_(q|k|v)/weight$", ("fsdp", "tensor")),
    (r"(audio_to_video|video_to_audio)_attn/to_(q|k|v)/weight$", ("fsdp", "tensor")),
    (r"(audio_)?attn\d/to_(q|k|v)/bias$", ("tensor",)),
    (r"(audio_to_video|video_to_audio)_attn/to_(q|k|v)/bias$", ("tensor",)),
    (r"attn\d?/to_out/weight$", ("tensor", "fsdp")),
    (r"_attn/to_out/weight$", ("tensor", "fsdp")),
    (r"to_out/bias$", (None,)),
    (r"(q|k)_norm/weight$", ("tensor",)),
    # feed-forward
    (r"ff/proj_in/weight$", ("fsdp", "tensor")),
    (r"ff/proj_in/bias$", ("tensor",)),
    (r"ff/proj_out/weight$", ("tensor", "fsdp")),
    (r"ff/proj_out/bias$", (None,)),
    # block adaLN tables: (6|5, dim)
    (r"scale_shift_table(_a2v_ca_(audio|video))?$", (None, "fsdp")),
    # top-level projections
    (r"patchify_proj/weight$", (None, "tensor")),
    (r"patchify_proj/bias$", ("tensor",)),
    (r"caption_projection/linear1/weight$", ("fsdp", "tensor")),
    (r"caption_projection/linear1/bias$", ("tensor",)),
    (r"caption_projection/linear2/weight$", ("tensor", "fsdp")),
    (r"caption_projection/linear2/bias$", (None,)),
    (r"proj_out/weight$", ("tensor", None)),
    (r"proj_out/bias$", (None,)),
    # adaLN MLPs
    (r"adaln[a-z_]*/emb/timestep_embedder/linear1/weight$", (None, "tensor")),
    (r"adaln[a-z_]*/emb/timestep_embedder/linear1/bias$", ("tensor",)),
    (r"adaln[a-z_]*/emb/timestep_embedder/linear2/weight$", ("tensor", "fsdp")),
    (r"adaln[a-z_]*/emb/timestep_embedder/linear2/bias$", (None,)),
    (r"adaln[a-z_]*/linear/weight$", ("fsdp", "tensor")),
    (r"adaln[a-z_]*/linear/bias$", ("tensor",)),
    # Gemma-3 text encoder (layer stack under "layers/")
    (r"self_attn/(q|k|v)_proj/weight$", ("fsdp", "tensor")),
    (r"self_attn/(q|k|v)_proj/bias$", ("tensor",)),
    (r"self_attn/o_proj/weight$", ("tensor", "fsdp")),
    (r"self_attn/o_proj/bias$", (None,)),
    (r"mlp/(gate|up)_proj/weight$", ("fsdp", "tensor")),
    (r"mlp/(gate|up)_proj/bias$", ("tensor",)),
    (r"mlp/down_proj/weight$", ("tensor", "fsdp")),
    (r"mlp/down_proj/bias$", (None,)),
    (r"embed_tokens/weight$", ("fsdp", None)),
    (r"feature_extractor/aggregate_embed/weight$", ("fsdp", "tensor")),
]


def spec_for_path(path_str: str, ndim: int) -> Spec:
    """Partition spec (a tuple of axis names or None, one a dimension) of one
    JAX param leaf; stacked block leaves get a leading None for the layer
    axis. JAX's function, returning a tuple where it returns a
    ``PartitionSpec``."""
    # W8A8 leaves: int8_weight has the weight's (in, out) layout; int8_scale
    # is (out,) like a bias.
    transpose = False
    if path_str.endswith("int8_weight"):
        path_str = path_str[: -len("int8_weight")] + "weight"
    elif path_str.endswith("int8_scale"):
        path_str = path_str[: -len("int8_scale")] + "bias"
    else:
        # Affine-quantized leaves (MLX layout): quant_weight is (out,
        # in*bits/32) and scales/biases are (out, in/group): the dense
        # (in, out) spec with its matrix axes swapped.
        for leaf in ("quant_weight", "scales", "biases"):
            if path_str.endswith("/" + leaf):
                path_str = path_str[: -len(leaf)] + "weight"
                transpose = True
                break
    stacked = (path_str.startswith("blocks/") or "/blocks/" in path_str
               or path_str.startswith("layers/") or "/layers/" in path_str)
    for pattern, spec in _RULES:
        if re.search(pattern, path_str):
            base = tuple(spec)
            if transpose and len(base) == 2:
                base = (base[1], base[0])
            if stacked:
                base = (None,) + base
            return (base + (None,) * ndim)[:ndim]
    return (None,) * ndim


_STACKS = ("blocks", "layers")  # the module lists JAX stacks along a leading layer axis
_FACTORS = ("lora_A", "lora_B")


def jax_path(name: str) -> Tuple[str, bool]:
    """The JAX tree path of a port tensor name (``blocks.3.attn1.to_q.weight``
    -> ``blocks/attn1/to_q/weight``; ``language_model.layers.3.mlp...`` ->
    ``language_model/layers/mlp...``) and whether the leaf is stacked."""
    parts = name.split(".")
    at = next((i for i in range(1, len(parts)) if parts[i].isdigit() and parts[i - 1] in _STACKS), None)
    if at is not None:
        parts = parts[:at] + parts[at + 1:]
    return "/".join(parts), at is not None


def port_spec(name: str, ndim: int) -> Spec:
    """The spec of a port tensor in the port's layout: JAX's spec of the same
    leaf, without the stack's axis, with the matrix axes swapped where the
    port's layout is (out, in) and JAX's (in, out)."""
    path, stacked = jax_path(name)
    if re.search(r"self_attn/(q|k)_norm/weight$", path):  # Gemma's per-head norms: whole on every rank
        return (None,) * ndim
    spec = spec_for_path(path, ndim + stacked)[int(stacked):]
    leaf = path.rsplit("/", 1)[-1]
    if ndim == 2 and leaf in ("weight", "int8_weight"):
        spec = (spec[1], spec[0])
    return spec


def factor_specs(weight_spec: Spec) -> Tuple[Spec, Spec]:
    """The specs of a linear's LoRA factors (A (r, in), B (out, r)) from its
    (out, in) weight spec: the ``tensor`` cut of each dimension alone."""
    out_ax, in_ax = (("tensor" if "tensor" in _axes_of(e) else None) for e in weight_spec)
    return (None, in_ax), (out_ax, None)


def spec_of(specs: Dict[str, Spec], name: str) -> Spec:
    """The spec of tensor ``name`` of a sharded model: its entry in
    ``specs``, or for LoRA leaves attached after sharding, the one
    :func:`factor_specs` derives from their linear's weight (a scale: none)."""
    if name in specs:
        return specs[name]
    owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if leaf == "lora_scale":
        return ()
    if leaf in _FACTORS:
        for w in ("weight", "quant_weight", "int8_weight"):
            key = f"{owner}.{w}" if owner else w
            if key in specs:
                return factor_specs(specs[key])[_FACTORS.index(leaf)]
    raise KeyError(name)


def _tensors(model: nn.Module) -> Iterable[Tuple[str, torch.Tensor]]:
    yield from model.named_parameters()
    yield from model.named_buffers()


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """Spec of every parameter and buffer of a port DiT or text encoder, by
    name (a LoRA factor's from its linear's, :func:`factor_specs`)."""
    tensors = list(_tensors(model))
    specs = {name: port_spec(name, t.dim()) for name, t in tensors if name.rsplit(".", 1)[-1] not in _FACTORS}
    specs.update({name: spec_of(specs, name) for name, _ in tensors if name not in specs})
    return specs


def data_spec(ndim: int, batch_axes=("data",)) -> Spec:
    """Batch-sharded spec for activations and inputs: axis 0 on ``data`` (a
    one-axis tuple is that axis, as ``PartitionSpec`` writes it)."""
    axes = tuple(batch_axes)
    return (axes[0] if len(axes) == 1 else axes,) + (None,) * (ndim - 1)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slice(t: torch.Tensor, spec: Spec, mesh: MeshGroups, name: str = "tensor") -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: each dimension cut into
    equal parts over its axes (row-major over several), a new contiguous
    tensor; ``t`` itself when no axis of size > 1 cuts it."""
    out = t
    for d, entry in enumerate(spec):
        axes = [a for a in _axes_of(entry) if mesh.size(a) > 1]
        if not axes:
            continue
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * mesh.size(a), idx * mesh.size(a) + mesh.index(a)
        if out.shape[d] % parts:
            raise ValueError(f"{name}: dimension {d} of size {out.shape[d]} does not divide over "
                             f"{'x'.join(axes)}={parts}")
        step = out.shape[d] // parts
        out = out.narrow(d, idx * step, step)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def shard_batch(tree, mesh):
    """This rank's ``data`` slice of every tensor's batch axis in a pytree of
    tensors (dicts, lists, tuples, NamedTuples)."""
    mg = mesh_groups(mesh)

    def put(x):
        if isinstance(x, torch.Tensor):
            return local_slice(x, data_spec(x.dim()), mg, "batch")
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(put(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return x

    return put(tree)


def _clone_tree(module: nn.Module, fn, prefix: str = "", recurse: bool = True) -> nn.Module:
    """A structural copy of ``module``: new module objects (their plain
    attributes shared), each parameter and buffer replaced by
    ``fn(name, tensor, owner)``."""
    new = copy.copy(module)
    new._parameters = {}
    for k, p in module._parameters.items():
        if p is None:
            new._parameters[k] = None
            continue
        t = fn(prefix + k, p, module)
        # a gathered tensor that carries a gradient stays in the graph
        new._parameters[k] = t if (t is p or t.requires_grad) else nn.Parameter(t, requires_grad=False)
    new._buffers = {k: (None if b is None else fn(prefix + k, b, module)) for k, b in module._buffers.items()}
    new._modules = {k: (m if (m is None or not recurse) else _clone_tree(m, fn, f"{prefix}{k}.", recurse))
                    for k, m in module._modules.items()}
    return new


def _mark_tensor_parallel(module: nn.Module, specs: Dict[str, Spec], tp) -> None:
    """Give the row-parallel linears (in-dimension on ``tensor``) and the
    q/k RMSNorm weights of ``module`` (a sharded block) the ``tensor`` group
    as ``tp_group``, and its column-parallel linears (out-dimension on
    ``tensor``) as ``tp_copy``."""
    for name, sub in module.named_modules():
        w = next((n for n in ("weight", "quant_weight", "int8_weight") if n in sub._parameters or n in sub._buffers),
                 None)
        if w is None:
            continue
        spec = specs[f"{name}.{w}" if name else w]
        if (len(spec) == 2 and spec[1] == "tensor") or (len(spec) == 1 and spec[0] == "tensor"):
            sub.tp_group = tp
        elif len(spec) == 2 and spec[0] == "tensor":
            sub.tp_copy = tp


def _sub_specs(specs: Dict[str, Spec], prefix: str) -> Dict[str, Spec]:
    return {k[len(prefix):]: v for k, v in specs.items() if k.startswith(prefix)}


def _shard(model: nn.Module, mesh: MeshGroups) -> nn.Module:
    # a text encoder's Gemma, or a Gemma model of its own
    lm = getattr(model, "language_model", model if hasattr(model, "embed_tokens") else None)
    tp = mesh.size("tensor")
    if lm is not None and lm.config.num_key_value_heads % tp:
        raise ValueError(f"tensor={tp} does not divide the Gemma's {lm.config.num_key_value_heads} key/value heads")
    specs = param_specs(model)
    new = _clone_tree(model, lambda name, t, _: local_slice(t, specs[name], mesh, name))
    new.shard_specs = specs
    new.mesh = mesh
    # the layers that run tensor-parallel
    stack = "blocks" if lm is None else "layers" if lm is model else "language_model.layers"
    if tp > 1:
        for i, layer in enumerate(new.get_submodule(stack)):
            _mark_tensor_parallel(layer, _sub_specs(specs, f"{stack}.{i}."), mesh.group("tensor"))
    if lm is not None and lm is not model:  # the Gemma forward reads its own mesh and specs
        new.language_model.mesh, new.language_model.shard_specs = mesh, _sub_specs(specs, "language_model.")
    return new


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """This rank's share of a port DiT, of a text encoder's
    ``TextEncoderModel`` or of a ``Gemma3Model`` on ``mesh`` (a ``DeviceMesh`` or a
    :class:`MeshGroups`): a model of the same modules whose tensors are the
    rank's slices (:func:`local_slice`), carrying ``mesh`` and the specs, with
    the tensor-parallel groups set. A model already sharded on this mesh is
    returned as it is."""
    mg = mesh_groups(mesh)
    if getattr(model, "mesh", None) is not None:
        if model.mesh is mg:
            return model
        raise ValueError(f"the model is already sharded on {model.mesh}")
    return _shard(model, mg)


def gather(module: nn.Module, specs: Dict[str, Spec], mesh: MeshGroups, axes=("data", "fsdp", "tensor"),
           prefix: str = "", recurse: bool = True) -> nn.Module:
    """A copy of ``module`` (a submodule of a sharded model at ``prefix``)
    whose tensors cut over ``axes`` are all-gathered whole along them; the
    others, and ``module`` itself when nothing is cut, are shared. Under autograd a gathered tensor
    is the shard's function: ``tensor`` cuts gather with gather_split, the
    others with gather_sum."""
    if not any(mesh.size(a) > 1 for a in axes):
        return module

    def full(name, t, _):
        for d, entry in enumerate(spec_of(specs, prefix + name)):
            for a in reversed([a for a in _axes_of(entry) if a in axes and mesh.size(a) > 1]):
                t = (gather_split if a == "tensor" else gather_sum)(t, mesh.group(a), dim=d)
        return t

    return _clone_tree(module, full, recurse=recurse)


def unshard(t: torch.Tensor, spec: Spec, mesh: MeshGroups) -> torch.Tensor:
    """The whole tensor from every rank's :func:`local_slice` of it under
    ``spec`` (all-gathers, every rank taking part; no gradient)."""
    for d, entry in enumerate(spec):
        for a in reversed([a for a in _axes_of(entry) if mesh.size(a) > 1]):
            t = mesh.group(a).all_gather(t, dim=d)
    return t


def local_factors(model: nn.Module, name: str, a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's slices of a LoRA pair (A (r, in), B (out, r)) for the
    linear ``name`` of ``model``; the pair itself when the model is not
    sharded."""
    specs = getattr(model, "shard_specs", None)
    if specs is None:
        return a, b
    a_spec, b_spec = spec_of(specs, f"{name}.lora_A"), spec_of(specs, f"{name}.lora_B")
    return local_slice(a, a_spec, model.mesh, f"{name}.lora_A"), local_slice(b, b_spec, model.mesh, f"{name}.lora_B")


def spatial_spec(mesh, shape: Sequence[int], h_axis: int = 3) -> Spec:
    """JAX's ``spatial_sharding`` spec of a video tensor of ``shape``: the
    batch on ``data`` when it divides (and ``data`` > 1); H on ``fsdp``,
    then on ``fsdp`` x ``tensor``, each axis taken while the product of
    those taken divides H (greedily; none: H stays whole)."""
    mg = mesh_groups(mesh)
    spec = [None] * len(shape)
    if mg.size("data") > 1 and shape[0] % mg.size("data") == 0:
        spec[0] = "data"
    h_axes = []
    for a in ("fsdp", "tensor"):
        parts = 1
        for x in h_axes + [a]:
            parts *= mg.size(x)
        if shape[h_axis] % parts == 0:
            h_axes.append(a)
    if h_axes:
        spec[h_axis] = tuple(h_axes) if len(h_axes) > 1 else h_axes[0]
    return tuple(spec)


def spatial_group(mesh, spec: Spec, h_axis: int = 3):
    """The group over the axes that cut H under ``spec`` (flattened
    row-major, collectives.MeshGroups.flat): the row split's halo group."""
    return mesh_groups(mesh).flat(_axes_of(spec[h_axis]))


def shard_spatial(x: torch.Tensor, mesh, h_axis: int = 3) -> torch.Tensor:
    """This rank's rows (and batch) of a (B, C, F, H, W) video tensor under
    :func:`spatial_spec`; ``x`` itself without a mesh."""
    if mesh is None or x is None:
        return x
    return local_slice(x, spatial_spec(mesh, x.shape, h_axis), mesh_groups(mesh), "video")


def gather_spatial(x: torch.Tensor, mesh, spec: Spec, h_axis: int = 3) -> torch.Tensor:
    """The whole tensor from every rank's :func:`shard_spatial` part: the
    rows over the H group, then the batch over ``data``."""
    mg = mesh_groups(mesh)
    x = spatial_group(mg, spec, h_axis).all_gather(x, dim=h_axis)
    if spec[0] == "data":
        x = mg.group("data").all_gather(x, dim=0)
    return x
