"""int8 transfer parking of a module's tensors, for the ``low_memory`` plan.

Counterpart of mlx_video_tpu/io/staging.py. Under ``low_memory`` the
upsampler, the VAE decoder and encoder, and the audio decoder and vocoder
live off the card (or, with ``aux_park_device``, as int8 on it) while the
transformer denoises, and come in for their phase only
(pipelines/generate.py). A parked module is a :class:`ParkedModule`: the
module's structure with every parameter and buffer on the ``meta`` device,
and beside it the payload of each tensor on the park's device: per-group
symmetric int8 codes and fp32 scales (:func:`park_int8`), or the tensor as
it is (:func:`park`, the plain staging). On the host a payload sits in
pinned memory, so that the copies back to the card are asynchronous.

The codec is the JAX module's, element for element:

- groups of ``_GROUP_SIZE`` rows of the tensor flattened to (rows, output
  channels), one fp32 scale a (group, output channel): ``amax / 127``, 1 for
  an all-zero group; codes ``round(x / scale)`` (half to even) clipped to
  +-127; the last group padded with zeros;
- only floating tensors of at least 2 dimensions and ``_MIN_QUANT_SIZE``
  elements are quantized; the rest ride raw;
- the groups are defined on the JAX package's layout, where the output
  channel is the last axis and the blocks of a stacked key
  (io/jax_bridge.py: ``res_blocks``, ...) are one array along a leading
  axis. So each tensor is viewed in JAX's order first, as the bridge maps it
  (a linear's (out, in) as (in, out), a conv's (O, I, k...) as (k..., I,
  O), the vocoder's 1-D convs (O, I, K) and transposed convs (I, O, K) as
  (K, I, O)), and the blocks JAX stacks are stacked here too: the codes
  and scales are JAX's, bit for bit. The codes keep that layout;
- the divisor 127 is a tensor, as ops/int8.py:scale_from_absmax divides it:
  on the card PyTorch turns a division by a Python number into a product
  with its reciprocal.

A tensor on the card is quantized on the card, so only int8 bytes cross to
the host. :func:`unpark_begin` issues the host-to-card copies on a side
CUDA stream (``non_blocking``, from pinned memory) and records an event;
:func:`unpark_finish` makes the current stream wait on that event,
dequantizes on the card in plain PyTorch (fp32 codes times scales, cast to
the tensor's dtype, back in the port's layout) and calls ``record_stream``
on what the side stream wrote. Its result is a new module holding the
tensors; the park itself is left as it was.

A module that :func:`unpark_finish` made remembers its park: parking it
again re-commits that park to the new device and quantizes nothing, since
its tensors are the park's values. (The JAX function quantizes the
dequantized tree once more, which can move a scale by an ulp of the
dtype.) So a bundle keeps one set of codes, and every run decodes with the
same weights.
"""

from __future__ import annotations

import copy
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from mlx_video_tpu_torch.io.jax_bridge import _TO_JAX, STACKED_KEYS, TABLES
from mlx_video_tpu_torch.models.ltx.audio_vae.audio_vae import AudioDecoder, AudioEncoder
from mlx_video_tpu_torch.models.ltx.audio_vae.vocoder import Vocoder
from mlx_video_tpu_torch.models.ltx.video_vae.encoder import VideoEncoder

_MIN_QUANT_SIZE = 65536
_GROUP_SIZE = 64
_CHUNK = 1 << 24  # elements the codec converts to fp32 at a time

# the modules whose JAX trees stack nothing (io/jax_bridge.py's encoder, audio and vocoder trees)
_UNSTACKED = (VideoEncoder, AudioDecoder, AudioEncoder, Vocoder)

# a module that unpark_finish made -> the park it came from
_ORIGINS: "weakref.WeakKeyDictionary[nn.Module, ParkedModule]" = weakref.WeakKeyDictionary()
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


@dataclass
class Codes:
    """One JAX leaf (a tensor, or a stack of blocks' tensors) as per-group int8."""

    q: torch.Tensor  # int8 codes in the leaf's JAX layout; stacked: (blocks, ...)
    scale: torch.Tensor  # fp32 (groups, output channels)
    dtype: torch.dtype  # the tensors' own
    perm: Tuple[int, ...]  # a member tensor's port layout -> JAX layout
    stacked: bool

    def to(self, device: torch.device, non_blocking: bool = False, written: Optional[list] = None) -> "Codes":
        return Codes(_to(self.q, device, non_blocking, written), _to(self.scale, device, non_blocking, written),
                     self.dtype, self.perm, self.stacked)


Payload = Union[Codes, Tuple[torch.Tensor, ...]]


@dataclass
class _Slot:
    """A JAX leaf of the parked module: its tensors' paths, their meta stand-ins
    in the skeleton, and the payload (codes, or the tensors themselves)."""

    paths: Tuple[str, ...]
    stand_ins: Tuple[torch.Tensor, ...]
    payload: Payload


def _payload_to(payload: Payload, device: torch.device, non_blocking: bool = False,
                written: Optional[list] = None) -> Payload:
    if isinstance(payload, Codes):
        return payload.to(device, non_blocking, written)
    return tuple(_to(t, device, non_blocking, written) for t in payload)


class ParkedModule:
    """A module's structure (``skeleton``: every tensor on the ``meta``
    device) and its tensors' payloads (``slots``) on the park's device.
    ``int8``: made by :func:`park_int8`."""

    def __init__(self, skeleton: nn.Module, slots: List[_Slot], int8: bool):
        self.skeleton, self.slots, self.int8 = skeleton, slots, int8

    def _payload_tensors(self) -> List[torch.Tensor]:
        return [t for s in self.slots
                for t in ((s.payload.q, s.payload.scale) if isinstance(s.payload, Codes) else s.payload)]

    def nbytes(self) -> int:
        """The bytes of the payloads."""
        return sum(t.numel() * t.element_size() for t in self._payload_tensors())

    def module_bytes(self) -> int:
        """The bytes of the module's tensors in their own dtypes."""
        return sum(t.numel() * t.element_size() for s in self.slots for t in s.stand_ins)

    def devices(self) -> set:
        return {t.device for t in self._payload_tensors()}

    def tensor(self, path: str) -> torch.Tensor:
        """The tensor at ``path`` on the park's device (dequantized if it has codes)."""
        for slot in self.slots:
            if path in slot.paths:
                tensors = _dequantize(slot.payload) if isinstance(slot.payload, Codes) else slot.payload
                return tensors[slot.paths.index(path)]
        raise KeyError(path)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _to(t: torch.Tensor, device: torch.device, non_blocking: bool = False,
        written: Optional[list] = None) -> torch.Tensor:
    """``t`` on ``device``: itself if it is there (on the host, when CUDA is
    present, only if it is pinned), else a copy, pinned on the host;
    ``written`` collects the copies made."""
    pin = device.type == "cpu" and torch.cuda.is_available()
    if t.device == device and not (pin and not t.is_pinned()):
        return t
    if pin:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
    else:
        out = t.to(device, non_blocking=non_blocking)
    if written is not None:
        written.append(out)
    return out


def _should_quantize(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point() and leaf.dim() >= 2 and leaf.numel() >= _MIN_QUANT_SIZE


def _jax_order(root: nn.Module, path: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The permutation that views the tensor at ``path`` of ``root`` in the
    JAX package's layout (io/jax_bridge.py's mapping)."""
    parts = path.split(".")
    name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if isinstance(root, Vocoder) and name == "weight" and t.dim() == 3:
        return (2, 0, 1) if path.startswith("ups.") else (2, 1, 0)
    if name == "weight" and t.dim() in _TO_JAX and parent not in TABLES:
        return _TO_JAX[t.dim()]
    if name == "int8_weight" and t.dim() == 2:
        return (1, 0)
    return tuple(range(t.dim()))


def _units(module: nn.Module) -> List[Tuple[Tuple[str, ...], Tuple[torch.Tensor, ...], bool]]:
    """The module's parameters and buffers grouped as the JAX tree holds
    them: (paths, tensors, stacked), the blocks of a stacked leaf in block
    order. A tensor held under two names is listed once."""
    stacked_keys = () if isinstance(module, _UNSTACKED) else STACKED_KEYS
    units: Dict[Tuple[str, ...], list] = {}
    seen = set()
    for prefix, sub in module.named_modules():
        for name, t in (*sub._parameters.items(), *sub._buffers.items()):
            if t is None or id(t) in seen:
                continue
            seen.add(id(t))
            path = f"{prefix}.{name}" if prefix else name
            parts = path.split(".")
            block = [i > 0 and parts[i - 1] in stacked_keys and p.isdigit() for i, p in enumerate(parts)]
            key = tuple("*" if b else p for p, b in zip(parts, block))
            index = tuple(int(p) for p, b in zip(parts, block) if b)
            units.setdefault(key, []).append((index, path, t))
    out = []
    for key, members in units.items():
        members.sort(key=lambda m: m[0])
        out.append((tuple(m[1] for m in members), tuple(m[2] for m in members), "*" in key))
    return out


def _group_chunks(rows: int, cout: int):
    """(first group, first row, past-the-last row) of each chunk of whole
    groups of about ``_CHUNK`` elements: the groups are independent, so the
    fp32 work goes a chunk at a time."""
    step = max(1, _CHUNK // (_GROUP_SIZE * cout)) * _GROUP_SIZE
    for r0 in range(0, rows, step):
        yield r0 // _GROUP_SIZE, r0, min(rows, r0 + step)


def _quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group symmetric int8 of ``w`` along its last axis (the module
    docstring), on ``w``'s device: (codes in ``w``'s shape, fp32 scales).
    Counterpart of both ``_quantize_np`` and ``_quantize_jnp``."""
    cout = w.shape[-1]
    r = w.reshape(-1, cout)
    rows = r.shape[0]
    q = torch.empty((rows, cout), dtype=torch.int8, device=w.device)
    scale = torch.empty((-(-rows // _GROUP_SIZE), cout), dtype=torch.float32, device=w.device)
    d127 = torch.full((), 127.0, device=w.device)
    for g0, r0, r1 in _group_chunks(rows, cout):
        f = r[r0:r1].to(torch.float32)
        pad = -(r1 - r0) % _GROUP_SIZE
        if pad:
            f = torch.cat([f, f.new_zeros(pad, cout)])
        g = f.reshape(-1, _GROUP_SIZE, cout)
        amax = g.abs().amax(dim=1)
        s = torch.where(amax > 0, amax / d127, torch.ones_like(amax))
        scale[g0:g0 + s.shape[0]] = s
        q[r0:r1] = torch.clamp(torch.round(g / s[:, None, :]), -127, 127).to(torch.int8).reshape(-1, cout)[:r1 - r0]
    return q.reshape(w.shape), scale


def _dequantize(codes: Codes) -> Tuple[torch.Tensor, ...]:
    """The member tensors of ``codes``, in their dtype and the port's layout,
    on the codes' device. Counterpart of ``_dequant_leaves``."""
    cout = codes.q.shape[-1]
    r = codes.q.reshape(-1, cout)
    rows = r.shape[0]
    out = torch.empty((rows, cout), dtype=codes.dtype, device=r.device)
    for g0, r0, r1 in _group_chunks(rows, cout):
        f = r[r0:r1].to(torch.float32)
        pad = -(r1 - r0) % _GROUP_SIZE
        if pad:
            f = torch.cat([f, f.new_zeros(pad, cout)])
        g = f.reshape(-1, _GROUP_SIZE, cout) * codes.scale[g0:g0 + f.shape[0] // _GROUP_SIZE, None, :]
        out[r0:r1] = g.reshape(-1, cout)[:r1 - r0]
    leaf = out.reshape(codes.q.shape)
    inverse = tuple(sorted(range(len(codes.perm)), key=codes.perm.__getitem__))
    return tuple(m.permute(inverse).contiguous() for m in (leaf.unbind(0) if codes.stacked else (leaf,)))


def _park_fresh(module: nn.Module, device: torch.device, quantize: bool,
                work: Optional[torch.device] = None) -> ParkedModule:
    memo: dict = {}
    slots = []
    with torch.no_grad():
        for paths, tensors, stacked in _units(module):
            stand_ins = []
            for t in tensors:
                stand_in = torch.empty(t.shape, dtype=t.dtype, device="meta")
                if isinstance(t, nn.Parameter):
                    stand_in = nn.Parameter(stand_in, requires_grad=t.requires_grad)
                memo[id(t)] = stand_in
                stand_ins.append(stand_in)
            perm = _jax_order(module, paths[0], tensors[0])
            leaf = (torch.stack([t.detach().permute(perm) for t in tensors]) if stacked
                    else tensors[0].detach().permute(perm))
            if quantize and _should_quantize(leaf):
                q, scale = _quantize(leaf if work is None else leaf.to(work))
                payload: Payload = Codes(_to(q, device), _to(scale, device), leaf.dtype, perm, stacked)
            else:
                payload = tuple(_to(t.detach(), device) for t in tensors)
            slots.append(_Slot(paths, tuple(stand_ins), payload))
    return ParkedModule(copy.deepcopy(module, memo), slots, quantize)


def park(tree: Optional[Union[nn.Module, ParkedModule]], device, quantize: bool = False, work=None
         ) -> Optional[ParkedModule]:
    """``tree``'s tensors committed to ``device``, each as codes (with
    ``quantize``, where :func:`_should_quantize`; computed on ``work``, a JAX
    leaf at a time, when given, else where the tensor is) or as it is. A park, or a
    module unparked from one, re-commits that park and quantizes nothing,
    unless the park is plain and ``quantize`` asks for codes (a plain-staged
    tree is quantized as JAX quantizes one). A module is left as it was."""
    if tree is None:
        return None
    device = _device(device)
    origin = tree if isinstance(tree, ParkedModule) else _ORIGINS.get(tree)
    if origin is not None and (origin.int8 or not quantize):
        slots = [_Slot(s.paths, s.stand_ins, _payload_to(s.payload, device)) for s in origin.slots]
        return ParkedModule(origin.skeleton, slots, origin.int8)
    if isinstance(tree, ParkedModule):  # its tensors, where they are
        tree = unpark_int8(tree, next(iter(tree.devices()), torch.device("cpu")))
    return _park_fresh(tree, device, quantize, None if work is None else _device(work))


def park_int8(tree: Optional[Union[nn.Module, ParkedModule]], device) -> Optional[ParkedModule]:
    """Quantize the large floating tensors of ``tree`` (on their own device,
    so that only int8 bytes move) and commit everything to ``device``;
    idempotent on a parked tree (the module docstring)."""
    return park(tree, device, quantize=True)


def park_of(tree) -> Optional[ParkedModule]:
    """``tree`` if it is a park, the park a module was unparked from, else None."""
    if isinstance(tree, ParkedModule) or tree is None:
        return tree
    return _ORIGINS.get(tree)


def is_parked(tree) -> bool:
    """``tree`` is a park holding int8 codes."""
    return isinstance(tree, ParkedModule) and any(isinstance(s.payload, Codes) for s in tree.slots)


@dataclass
class _Handle:
    device: torch.device
    parked: Optional[ParkedModule] = None
    moved: Optional[List[Payload]] = None
    event: Optional["torch.cuda.Event"] = None
    written: Optional[List[torch.Tensor]] = None
    module: Optional[nn.Module] = None  # a module already on the device


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def unpark_begin(tree: Optional[Union[nn.Module, ParkedModule]], device) -> Optional[_Handle]:
    """Issue the copies of ``tree``'s payloads to ``device`` (on the card:
    ``non_blocking`` on a side stream, then an event) and return the handle
    for :func:`unpark_finish`. Neither waits nor dequantizes, so device work
    in flight overlaps the copies. A module whose tensors are all on
    ``device`` passes through; one elsewhere is copied over as it is."""
    if tree is None:
        return None
    device = _device(device)
    if isinstance(tree, nn.Module):
        if all(t.device == device for t in (*tree.parameters(), *tree.buffers())):
            return _Handle(device, module=tree)
        tree = _park_fresh(tree, torch.device("cpu"), quantize=False)
    if device.type != "cuda":
        return _Handle(device, tree, [_payload_to(s.payload, device) for s in tree.slots])
    stream, written = _side_stream(device), []
    with torch.cuda.stream(stream):
        moved = [_payload_to(s.payload, device, non_blocking=True, written=written) for s in tree.slots]
        event = torch.cuda.Event()
        event.record(stream)
    return _Handle(device, tree, moved, event, written)


def unpark_finish(handle: Optional[_Handle]) -> Optional[nn.Module]:
    """The module of :func:`unpark_begin`'s handle: the current stream waits
    for the copies, the codes are dequantized on it, and the copies are
    recorded as used by it. The module's parameters are the dequantized
    tensors, in their own dtype."""
    if handle is None:
        return None
    if handle.module is not None:
        return handle.module
    if handle.event is not None:
        current = torch.cuda.current_stream(handle.device)
        current.wait_event(handle.event)
        for t in handle.written:
            t.record_stream(current)
    memo: dict = {}
    with torch.no_grad():
        for slot, payload in zip(handle.parked.slots, handle.moved):
            tensors = _dequantize(payload) if isinstance(payload, Codes) else payload
            for stand_in, t in zip(slot.stand_ins, tensors):
                memo[id(stand_in)] = (nn.Parameter(t, requires_grad=stand_in.requires_grad)
                                      if isinstance(stand_in, nn.Parameter) else t)
    module = copy.deepcopy(handle.parked.skeleton, memo)
    _ORIGINS[module] = handle.parked
    return module


def unpark_int8(tree: Optional[Union[nn.Module, ParkedModule]], device) -> Optional[nn.Module]:
    """``tree`` on ``device`` as a module (int8 on the wire, dequantized there)."""
    return unpark_finish(unpark_begin(tree, device))
