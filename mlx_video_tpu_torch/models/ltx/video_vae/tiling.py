"""Spatio-temporal tiled decoding with trapezoidal blending.

The port's own copy of mlx_video_tpu/models/ltx/video_vae/tiling.py (framework-free code, copied whole and
unchanged in behaviour), so that the port imports nothing of the JAX package, plus
:func:`decode_with_tiling_device`, the PyTorch counterpart of the JAX module's device-blend path.

Behavioral spec: reference mlx_video/models/ltx/video_vae/tiling.py:17-509
(interval math, mask shapes, presets, causal temporal adjustment).

The tile loop runs on the host, one decoder call per tile. :func:`decode_with_tiling` accumulates in host
fp32 NumPy buffers; :func:`decode_with_tiling_device` keeps the fp32 canvas and its weights on the tiles'
device and reads back only finalised frame ranges. Both hand each finalised range to ``on_frames_ready``
(streaming decode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np


def compute_trapezoidal_mask_1d(
    length: int,
    ramp_left: int,
    ramp_right: int,
    left_starts_from_0: bool = False,
) -> np.ndarray:
    """1D trapezoidal blend mask with linear ramps (reference: tiling.py:17-62).

    The left ramp excludes the 0 endpoint unless ``left_starts_from_0`` (used
    by causal temporal tiles); the right ramp excludes both endpoints.
    """
    if length <= 0:
        raise ValueError("Mask length must be positive.")
    ramp_left = max(0, min(ramp_left, length))
    ramp_right = max(0, min(ramp_right, length))

    mask = np.ones(length, dtype=np.float32)
    if ramp_left > 0:
        interval = ramp_left + 1 if left_starts_from_0 else ramp_left + 2
        fade_in = np.linspace(0.0, 1.0, interval, dtype=np.float32)[:-1]
        if not left_starts_from_0:
            fade_in = fade_in[1:]
        n = min(ramp_left, len(fade_in))
        mask[:n] *= fade_in[:n]
    if ramp_right > 0:
        fade_out = np.array(
            [(ramp_right + 1 - i) / (ramp_right + 1) for i in range(1, ramp_right + 1)],
            dtype=np.float32,
        )
        mask[length - ramp_right :] *= fade_out
    return np.clip(mask, 0.0, 1.0)


@dataclass(frozen=True)
class SpatialTilingConfig:
    """Spatial tile geometry in output pixels (reference: tiling.py:65-82)."""

    tile_size_in_pixels: int
    tile_overlap_in_pixels: int = 0

    def __post_init__(self) -> None:
        if self.tile_size_in_pixels < 64:
            raise ValueError(f"tile_size_in_pixels must be at least 64, got {self.tile_size_in_pixels}")
        if self.tile_size_in_pixels % 32 != 0:
            raise ValueError(f"tile_size_in_pixels must be divisible by 32, got {self.tile_size_in_pixels}")
        if self.tile_overlap_in_pixels % 32 != 0:
            raise ValueError(
                f"tile_overlap_in_pixels must be divisible by 32, got {self.tile_overlap_in_pixels}"
            )
        if self.tile_overlap_in_pixels >= self.tile_size_in_pixels:
            raise ValueError(
                f"Overlap must be less than tile size, got {self.tile_overlap_in_pixels} and "
                f"{self.tile_size_in_pixels}"
            )


@dataclass(frozen=True)
class TemporalTilingConfig:
    """Temporal tile geometry in output frames (reference: tiling.py:85-102)."""

    tile_size_in_frames: int
    tile_overlap_in_frames: int = 0

    def __post_init__(self) -> None:
        if self.tile_size_in_frames < 16:
            raise ValueError(f"tile_size_in_frames must be at least 16, got {self.tile_size_in_frames}")
        if self.tile_size_in_frames % 8 != 0:
            raise ValueError(f"tile_size_in_frames must be divisible by 8, got {self.tile_size_in_frames}")
        if self.tile_overlap_in_frames % 8 != 0:
            raise ValueError(
                f"tile_overlap_in_frames must be divisible by 8, got {self.tile_overlap_in_frames}"
            )
        if self.tile_overlap_in_frames >= self.tile_size_in_frames:
            raise ValueError(
                f"Overlap must be less than tile size, got {self.tile_overlap_in_frames} and "
                f"{self.tile_size_in_frames}"
            )


@dataclass(frozen=True)
class TilingConfig:
    """Spatial + temporal tiling presets (reference: tiling.py:105-211)."""

    spatial_config: Optional[SpatialTilingConfig] = None
    temporal_config: Optional[TemporalTilingConfig] = None

    @classmethod
    def default(cls) -> "TilingConfig":
        return cls(
            spatial_config=SpatialTilingConfig(512, 64),
            temporal_config=TemporalTilingConfig(64, 24),
        )

    @classmethod
    def spatial_only(cls, tile_size: int = 512, overlap: int = 64) -> "TilingConfig":
        return cls(spatial_config=SpatialTilingConfig(tile_size, overlap), temporal_config=None)

    @classmethod
    def temporal_only(cls, tile_size: int = 64, overlap: int = 24) -> "TilingConfig":
        return cls(spatial_config=None, temporal_config=TemporalTilingConfig(tile_size, overlap))

    @classmethod
    def aggressive(cls) -> "TilingConfig":
        return cls(
            spatial_config=SpatialTilingConfig(256, 64),
            temporal_config=TemporalTilingConfig(32, 8),
        )

    @classmethod
    def conservative(cls) -> "TilingConfig":
        return cls(
            spatial_config=SpatialTilingConfig(768, 64),
            temporal_config=TemporalTilingConfig(96, 24),
        )

    @classmethod
    def auto(
        cls,
        height: int,
        width: int,
        num_frames: int,
        spatial_threshold: int = 512,
        temporal_threshold: int = 65,
    ) -> Optional["TilingConfig"]:
        """Heuristic config by resolution / frames / output size
        (reference: tiling.py:152-211)."""
        needs_spatial = height > spatial_threshold or width > spatial_threshold
        needs_temporal = num_frames > temporal_threshold
        if not needs_spatial and not needs_temporal:
            return None

        estimated_output_gb = (3 * num_frames * height * width * 4) / (1024**3)
        if estimated_output_gb > 2.0 or (height * width > 768 * 1024 and num_frames > 100):
            return cls.aggressive()

        spatial_config = None
        temporal_config = None
        if needs_spatial:
            max_dim = max(height, width)
            tile_size = 512 if 768 < max_dim <= 1024 else 384
            spatial_config = SpatialTilingConfig(tile_size, 64)
        if needs_temporal:
            if num_frames > 200:
                tile, overlap = 32, 8
            elif num_frames > 100:
                tile, overlap = 48, 16
            else:
                tile, overlap = 64, 24
            temporal_config = TemporalTilingConfig(tile, overlap)
        return cls(spatial_config=spatial_config, temporal_config=temporal_config)


@dataclass
class DimensionIntervals:
    starts: List[int]
    ends: List[int]
    left_ramps: List[int]
    right_ramps: List[int]


def split_in_spatial(size: int, overlap: int, dimension_size: int) -> DimensionIntervals:
    """Overlapping intervals covering a spatial dim (reference: tiling.py:223-235)."""
    if dimension_size <= size:
        return DimensionIntervals([0], [dimension_size], [0], [0])
    amount = (dimension_size + size - 2 * overlap - 1) // (size - overlap)
    starts = [i * (size - overlap) for i in range(amount)]
    ends = [s + size for s in starts]
    ends[-1] = dimension_size
    return DimensionIntervals(
        starts, ends, [0] + [overlap] * (amount - 1), [overlap] * (amount - 1) + [0]
    )


def split_in_temporal(size: int, overlap: int, dimension_size: int) -> DimensionIntervals:
    """Temporal intervals with causal -1-frame start adjust
    (reference: tiling.py:238-254)."""
    if dimension_size <= size:
        return DimensionIntervals([0], [dimension_size], [0], [0])
    iv = split_in_spatial(size, overlap, dimension_size)
    starts, left = list(iv.starts), list(iv.left_ramps)
    for i in range(1, len(starts)):
        starts[i] -= 1
        left[i] += 1
    return DimensionIntervals(starts, iv.ends, left, iv.right_ramps)


def map_temporal_slice(
    begin: int, end: int, left_ramp: int, right_ramp: int, scale: int
) -> Tuple[slice, np.ndarray]:
    """Latent temporal interval -> output frame slice + mask
    (reference: tiling.py:257-265). Causal: frame 0 maps to itself, later
    latents to ``1 + (i-1)*scale``."""
    start = begin * scale
    stop = 1 + (end - 1) * scale
    left_scaled = 1 + (left_ramp - 1) * scale if left_ramp > 0 else 0
    mask = compute_trapezoidal_mask_1d(stop - start, left_scaled, right_ramp * scale, True)
    return slice(start, stop), mask


def map_spatial_slice(
    begin: int, end: int, left_ramp: int, right_ramp: int, scale: int
) -> Tuple[slice, np.ndarray]:
    """Latent spatial interval -> output pixel slice + mask
    (reference: tiling.py:268-276)."""
    mask = compute_trapezoidal_mask_1d(
        (end - begin) * scale, left_ramp * scale, right_ramp * scale, False
    )
    return slice(begin * scale, end * scale), mask


def tile_latent_shapes(
    latents_shape,
    tiling_config: TilingConfig,
    spatial_scale: int = 32,
    temporal_scale: int = 8,
):
    """Distinct latent tile shapes ``(f, h, w)`` the tiled decode will
    dispatch for ``latents_shape`` — first-occurrence order. Used to
    pre-load the decoder stage executables (one per distinct shape) while
    the decoder params are still on the host->HBM wire (generate_video's
    decode warmup)."""
    _, _, f_latent, h_latent, w_latent = latents_shape
    if tiling_config is None:
        return [(f_latent, h_latent, w_latent)]
    if tiling_config.spatial_config is not None:
        s_cfg = tiling_config.spatial_config
        s_tile = s_cfg.tile_size_in_pixels // spatial_scale
        s_overlap = s_cfg.tile_overlap_in_pixels // spatial_scale
    else:
        s_tile, s_overlap = max(h_latent, w_latent), 0
    if tiling_config.temporal_config is not None:
        t_cfg = tiling_config.temporal_config
        t_tile = t_cfg.tile_size_in_frames // temporal_scale
        t_overlap = t_cfg.tile_overlap_in_frames // temporal_scale
    else:
        t_tile, t_overlap = f_latent, 0
    t_iv = split_in_temporal(t_tile, t_overlap, f_latent)
    h_iv = split_in_spatial(s_tile, s_overlap, h_latent)
    w_iv = split_in_spatial(s_tile, s_overlap, w_latent)
    seen, out = set(), []
    for ts, te in zip(t_iv.starts, t_iv.ends):
        for hs, he in zip(h_iv.starts, h_iv.ends):
            for ws, we in zip(w_iv.starts, w_iv.ends):
                shape = (te - ts, he - hs, we - ws)
                if shape not in seen:
                    seen.add(shape)
                    out.append(shape)
    return out


def _tile_work(latents, tiling_config, spatial_scale: int, temporal_scale: int):
    """Shared tiling plan: flattened tile grid + output geometry.

    Returns (work, t_iv, num_t, out_f, out_h, out_w) where each work item is
    ``(t_idx, last_of_group, tile, region_slices, masks)`` in dispatch order.
    """
    b, c, f_latent, h_latent, w_latent = latents.shape

    out_f = 1 + (f_latent - 1) * temporal_scale
    out_h = h_latent * spatial_scale
    out_w = w_latent * spatial_scale

    if tiling_config.spatial_config is not None:
        s_cfg = tiling_config.spatial_config
        s_tile = s_cfg.tile_size_in_pixels // spatial_scale
        s_overlap = s_cfg.tile_overlap_in_pixels // spatial_scale
    else:
        s_tile, s_overlap = max(h_latent, w_latent), 0

    if tiling_config.temporal_config is not None:
        t_cfg = tiling_config.temporal_config
        t_tile = t_cfg.tile_size_in_frames // temporal_scale
        t_overlap = t_cfg.tile_overlap_in_frames // temporal_scale
    else:
        t_tile, t_overlap = f_latent, 0

    t_iv = split_in_temporal(t_tile, t_overlap, f_latent)
    h_iv = split_in_spatial(s_tile, s_overlap, h_latent)
    w_iv = split_in_spatial(s_tile, s_overlap, w_latent)
    num_t = len(t_iv.starts)

    work = []  # (t_idx, last_of_group, tile, region, blend)
    for t_idx in range(num_t):
        out_t, t_mask = map_temporal_slice(
            t_iv.starts[t_idx], t_iv.ends[t_idx], t_iv.left_ramps[t_idx], t_iv.right_ramps[t_idx],
            temporal_scale,
        )
        for h_idx in range(len(h_iv.starts)):
            out_h_sl, h_mask = map_spatial_slice(
                h_iv.starts[h_idx], h_iv.ends[h_idx], h_iv.left_ramps[h_idx],
                h_iv.right_ramps[h_idx], spatial_scale,
            )
            for w_idx in range(len(w_iv.starts)):
                out_w_sl, w_mask = map_spatial_slice(
                    w_iv.starts[w_idx], w_iv.ends[w_idx], w_iv.left_ramps[w_idx],
                    w_iv.right_ramps[w_idx], spatial_scale,
                )
                tile = latents[
                    :,
                    :,
                    t_iv.starts[t_idx] : t_iv.ends[t_idx],
                    h_iv.starts[h_idx] : h_iv.ends[h_idx],
                    w_iv.starts[w_idx] : w_iv.ends[w_idx],
                ]
                last = h_idx == len(h_iv.starts) - 1 and w_idx == len(w_iv.starts) - 1
                work.append((t_idx, last, tile, (out_t, out_h_sl, out_w_sl), (t_mask, h_mask, w_mask)))
    return work, t_iv, num_t, out_f, out_h, out_w


def decode_with_tiling(
    decode_tile_fn: Callable[[np.ndarray], np.ndarray],
    latents,
    tiling_config: TilingConfig,
    spatial_scale: int = 32,
    temporal_scale: int = 8,
    on_frames_ready: Optional[Callable[[np.ndarray, int], None]] = None,
) -> np.ndarray:
    """Tile -> decode -> fp32 weighted blend -> normalize
    (reference: tiling.py:279-509).

    decode_tile_fn: maps a latent tile (B, C, f, h, w) to RGB (B, 3, F, H, W);
    typically a jitted decoder call (one compile per distinct tile shape).
    Accumulation happens in host fp32 buffers; with ``on_frames_ready``,
    finalized frame ranges are emitted as soon as no future tile can touch
    them (streaming decode).
    """
    latents = np.asarray(latents)
    b = latents.shape[0]

    # Flatten the tile grid up-front so the decode loop can PIPELINE:
    # dispatch tile n+1's decode (async under jit) before fetching tile n's
    # frames, overlapping the host readback of each tile with the device
    # compute of the next (the readback was ~half the warm decode phase,
    # PERF.md r3). Depth 1 bounds HBM to two tiles' activations.
    work, t_iv, num_t, out_f, out_h, out_w = _tile_work(
        latents, tiling_config, spatial_scale, temporal_scale
    )

    output = np.zeros((b, 3, out_f, out_h, out_w), dtype=np.float32)
    weights = np.zeros((b, 1, out_f, out_h, out_w), dtype=np.float32)
    emitted = 0

    def _accumulate(decoded_dev, region_sl, masks, t_idx, last_of_group):
        decoded = np.asarray(decoded_dev, dtype=np.float32)
        out_t, out_h_sl, out_w_sl = region_sl
        t_mask, h_mask, w_mask = masks
        dt = min(decoded.shape[2], out_t.stop - out_t.start)
        dh = min(decoded.shape[3], out_h_sl.stop - out_h_sl.start)
        dw = min(decoded.shape[4], out_w_sl.stop - out_w_sl.start)
        blend = (
            t_mask[:dt].reshape(1, 1, -1, 1, 1)
            * h_mask[:dh].reshape(1, 1, 1, -1, 1)
            * w_mask[:dw].reshape(1, 1, 1, 1, -1)
        )
        region = (
            slice(None),
            slice(None),
            slice(out_t.start, out_t.start + dt),
            slice(out_h_sl.start, out_h_sl.start + dh),
            slice(out_w_sl.start, out_w_sl.start + dw),
        )
        output[region] += decoded[:, :, :dt, :dh, :dw] * blend
        weights[region] += blend
        # Emit frames no future temporal tile can touch (streaming decode,
        # reference: tiling.py:453-484). Runs when the group's LAST tile is
        # blended — identical data/order to the unpipelined loop, since no
        # t_idx+1 tile has been blended yet at that point.
        nonlocal emitted
        if on_frames_ready is not None and last_of_group and num_t > 1 and t_idx < num_t - 1:
            next_start_latent = t_iv.starts[t_idx + 1]
            next_start_out = 0 if next_start_latent == 0 else 1 + (next_start_latent - 1) * temporal_scale
            if next_start_out > emitted:
                w_slice = np.maximum(weights[:, :, emitted:next_start_out], 1e-8)
                on_frames_ready(output[:, :, emitted:next_start_out] / w_slice, emitted)
                emitted = next_start_out

    pending = None
    for t_idx, last, tile, region_sl, masks in work:
        dev = decode_tile_fn(tile)
        if pending is not None:
            _accumulate(*pending)
        pending = (dev, region_sl, masks, t_idx, last)
    if pending is not None:
        _accumulate(*pending)

    weights = np.maximum(weights, 1e-8)
    output = output / weights
    if on_frames_ready is not None and emitted < out_f:
        on_frames_ready(output[:, :, emitted:], emitted)
    return output


def decode_with_tiling_device(
    decode_tile_fn: Callable,
    latents,
    tiling_config: TilingConfig,
    spatial_scale: int = 32,
    temporal_scale: int = 8,
    on_frames_ready: Optional[Callable[[np.ndarray, int], None]] = None,
) -> np.ndarray:
    """:func:`decode_with_tiling` with the blend and normalisation on the
    latents' device (the JAX module's ``decode_with_tiling_device``).

    ``latents`` is a torch tensor; ``decode_tile_fn`` maps a latent tile (a
    view of it) to RGB on the same device. Each tile is blended into an fp32
    canvas and weight buffer there, in the host path's order and arithmetic,
    and only finalised frame ranges come back, normalised, as fp32 numpy (the
    JAX module reads them back in fp16). Emission points and the return value
    are the host path's. The canvas costs 4 x (3 + 1) / 3 bytes a video
    element on the device.
    """
    import torch

    b, device = latents.shape[0], latents.device
    work, t_iv, num_t, out_f, out_h, out_w = _tile_work(latents, tiling_config, spatial_scale, temporal_scale)
    canvas = torch.zeros((b, 3, out_f, out_h, out_w), dtype=torch.float32, device=device)
    weights = torch.zeros((b, 1, out_f, out_h, out_w), dtype=torch.float32, device=device)
    chunks: List[np.ndarray] = []
    emitted = 0

    def emit(stop: int) -> None:
        nonlocal emitted
        chunk = (canvas[:, :, emitted:stop] / weights[:, :, emitted:stop].clamp_min(1e-8)).cpu().numpy()
        if on_frames_ready is not None:
            on_frames_ready(chunk, emitted)
        chunks.append(chunk)
        emitted = stop

    for t_idx, last, tile, region_sl, masks in work:
        decoded = decode_tile_fn(tile).float()
        out_t, out_h_sl, out_w_sl = region_sl
        dt = min(decoded.shape[2], out_t.stop - out_t.start)
        dh = min(decoded.shape[3], out_h_sl.stop - out_h_sl.start)
        dw = min(decoded.shape[4], out_w_sl.stop - out_w_sl.start)
        t_mask, h_mask, w_mask = (torch.from_numpy(m[:n]).to(device) for m, n in zip(masks, (dt, dh, dw)))
        blend = t_mask.reshape(1, 1, -1, 1, 1) * h_mask.reshape(1, 1, 1, -1, 1) * w_mask.reshape(1, 1, 1, 1, -1)
        region = (slice(None), slice(None), slice(out_t.start, out_t.start + dt),
                  slice(out_h_sl.start, out_h_sl.start + dh), slice(out_w_sl.start, out_w_sl.start + dw))
        canvas[region] += decoded[:, :, :dt, :dh, :dw] * blend
        weights[region] += blend
        if on_frames_ready is not None and last and num_t > 1 and t_idx < num_t - 1:
            next_start_latent = t_iv.starts[t_idx + 1]
            next_start_out = 0 if next_start_latent == 0 else 1 + (next_start_latent - 1) * temporal_scale
            if next_start_out > emitted:
                emit(next_start_out)
    if emitted < out_f:
        emit(out_f)
    return np.concatenate(chunks, axis=2) if len(chunks) > 1 else chunks[0]
