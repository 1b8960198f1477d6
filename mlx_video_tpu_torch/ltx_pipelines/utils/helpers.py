"""Denoising-loop helpers over LatentState, on tensors.

Counterpart of ltx_pipelines/utils/helpers.py (reference
ltx_pipelines/utils/helpers.py:29-382: the Euler loop, the
gradient-estimating Euler loop, state noising, modality construction, and
the composed denoise toolkit). The transformer these helpers call is an
``X0Model`` (ltx_core/model/transformer), which runs the engine DiT
(models/ltx/model.py:ltx_apply, its attention on K1 on the card) and takes
``perturbations=None``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, List, Optional, Tuple

import torch

from mlx_video_tpu_torch.ltx_core.components.protocols import DiffusionStepProtocol, Noiser
from mlx_video_tpu_torch.ltx_core.types import LatentState
from mlx_video_tpu_torch.ltx_core.utils import get_device, to_denoised, to_velocity  # noqa: F401 (get_device: parity export)
from mlx_video_tpu_torch.models.ltx.model import Modality


def cleanup_memory() -> None:
    """Return the caching allocator's free blocks to the card (reference
    calls mx.clear_cache)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def post_process_latent(denoised: torch.Tensor, denoise_mask: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """Blend denoised with clean by the denoise mask (reference: helpers.py:234-236)."""
    mask = denoise_mask.to(denoised.dtype)
    return denoised * mask + clean.to(denoised.dtype) * (1.0 - mask)


def timesteps_from_mask(denoise_mask: torch.Tensor, sigma) -> torch.Tensor:
    """(B, S, 1)-mask -> per-token sigma (reference: helpers.py:251-253)."""
    return (denoise_mask[..., 0] if denoise_mask.dim() == 3 else denoise_mask) * float(sigma)


def modality_from_latent_state(
    state: LatentState, context: torch.Tensor, sigma, enabled: bool = True, context_mask=None
) -> Optional[Modality]:
    """(reference: helpers.py:238-249). The engine model treats a ``None``
    modality as disabled, so ``enabled=False`` returns None instead of a
    Modality(enabled=False)."""
    if not enabled:
        return None
    return Modality(
        latent=state.latent,
        timesteps=timesteps_from_mask(state.denoise_mask, sigma).to(state.latent.dtype),
        positions=state.positions,
        context=context,
        context_mask=context_mask,
    )


def euler_denoising_loop(
    sigmas,
    video_state: LatentState,
    audio_state: LatentState,
    stepper: DiffusionStepProtocol,
    denoise_fn: Callable,
) -> Tuple[LatentState, LatentState]:
    """(reference: helpers.py:91-108)."""
    for step_idx in range(int(len(sigmas) - 1)):
        denoised_video, denoised_audio = denoise_fn(video_state, audio_state, sigmas, step_idx)
        denoised_video = post_process_latent(
            denoised_video, video_state.denoise_mask, video_state.clean_latent
        )
        denoised_audio = post_process_latent(
            denoised_audio, audio_state.denoise_mask, audio_state.clean_latent
        )
        video_state = replace(
            video_state, latent=stepper.execute(video_state.latent, denoised_video, sigmas, step_idx)
        )
        audio_state = replace(
            audio_state, latent=stepper.execute(audio_state.latent, denoised_audio, sigmas, step_idx)
        )
    return video_state, audio_state


def gradient_estimating_euler_denoising_loop(
    sigmas,
    video_state: LatentState,
    audio_state: LatentState,
    stepper: DiffusionStepProtocol,
    denoise_fn: Callable,
    ge_gamma: float = 2.0,
) -> Tuple[LatentState, LatentState]:
    """Gradient-estimating Euler: extrapolate with the velocity delta
    (reference: helpers.py:110-151)."""
    prev_v_vel = prev_a_vel = None

    def update(noisy, denoised, sigma, prev):
        current = to_velocity(noisy, denoised, sigma)
        if prev is not None:
            total = ge_gamma * (current - prev) + prev
            denoised = to_denoised(noisy, total, sigma)
        return current, denoised

    for step_idx in range(int(len(sigmas) - 1)):
        denoised_video, denoised_audio = denoise_fn(video_state, audio_state, sigmas, step_idx)
        denoised_video = post_process_latent(
            denoised_video, video_state.denoise_mask, video_state.clean_latent
        )
        denoised_audio = post_process_latent(
            denoised_audio, audio_state.denoise_mask, audio_state.clean_latent
        )
        if float(sigmas[step_idx + 1]) == 0:
            return (
                replace(video_state, latent=denoised_video),
                replace(audio_state, latent=denoised_audio),
            )
        prev_v_vel, denoised_video = update(
            video_state.latent, denoised_video, float(sigmas[step_idx]), prev_v_vel
        )
        prev_a_vel, denoised_audio = update(
            audio_state.latent, denoised_audio, float(sigmas[step_idx]), prev_a_vel
        )
        video_state = replace(
            video_state, latent=stepper.execute(video_state.latent, denoised_video, sigmas, step_idx)
        )
        audio_state = replace(
            audio_state, latent=stepper.execute(audio_state.latent, denoised_audio, sigmas, step_idx)
        )
    return video_state, audio_state


def noise_state(state: LatentState, noiser: Noiser, noise_scale: float = 1.0) -> LatentState:
    """Mask-scaled renoising of a state (reference: helpers.py:153-231)."""
    noise = noiser.noise(state.latent)
    mask = state.denoise_mask.to(state.latent.dtype)
    # broadcast (B, 1, F, 1, 1) or (B, S, 1) masks over the latent
    while mask.dim() < state.latent.dim():
        mask = mask[..., None]
    effective = noise_scale * mask.reshape(mask.shape[: state.latent.dim()])
    latent = noise * effective + state.latent * (1.0 - effective)
    return replace(state, latent=latent)


_UNICODE_REPLACEMENTS = str.maketrans(
    "‘’“”—– ′−", "''\"\"-- '-"
)


def clean_response(text: str) -> str:
    """Normalize enhanced-prompt text: strip chat-template artifacts, map
    typographic unicode to ASCII, and drop everything before the first
    alphabetic character (reference: helpers.py:351-360)."""
    text = text.strip()
    for token in ("<start_of_turn>model", "<end_of_turn>", "<eos>"):
        text = text.replace(token, "")
    text = text.translate(_UNICODE_REPLACEMENTS)
    for i, char in enumerate(text):
        if char.isalpha():
            return text[i:]
    return text


def generate_enhanced_prompt(
    text_encoder,
    prompt: str,
    image_path: str = None,
    image_long_side: int = 896,
    seed: int = 42,
) -> str:
    """Enhance ``prompt`` with the Gemma text encoder and normalize the
    response (reference: helpers.py:363-381).

    With ``image_path`` the image is decoded and resized
    aspect-ratio-preserving to ``image_long_side`` on its long side, then the
    I2V enhancement path runs; otherwise T2V. The response goes through
    :func:`clean_response`."""
    import logging

    if image_path:
        from mlx_video_tpu_torch.ltx_pipelines.utils.media_io import decode_image, resize_aspect_ratio_preserving

        image = resize_aspect_ratio_preserving(decode_image(image_path), image_long_side)
        prompt = text_encoder.enhance_i2v(prompt, image, seed=seed)
    else:
        prompt = text_encoder.enhance_t2v(prompt, seed=seed)
    logging.info("Enhanced prompt: %s", prompt)
    return clean_response(prompt)


def assert_resolution(height: int, width: int, is_two_stage: bool) -> None:
    """(reference: helpers.py:382+)."""
    divisor = 64 if is_two_stage else 32
    if height % divisor or width % divisor:
        raise ValueError(f"height/width must be divisible by {divisor}, got {height}x{width}")


# ---------------------------------------------------------------------------
# Pipeline-building helpers (reference: helpers.py:38-348): the composed
# state/denoise toolkit over the token domain. They drive the same engine
# components the monolithic generate_video uses (the DiT, conditioning
# items), re-composed the reference way.


def image_conditionings_by_replacing_latent(
    images: List[Tuple[str, int, float]],
    height: int,
    width: int,
    video_encoder,
    dtype,
    device=None,
) -> list:
    """Encode images -> replace-mode conditioning items
    (reference: helpers.py:38-64; that code passes ``latent_idx=`` to a
    constructor whose parameter is ``frame_idx``, reproduced here with the
    working spelling)."""
    from mlx_video_tpu_torch.ltx_core.conditioning import VideoConditionByLatentIndex
    from mlx_video_tpu_torch.ltx_pipelines.utils.media_io import load_image_conditioning

    conditionings = []
    for image_path, frame_idx, strength in images:
        image = load_image_conditioning(
            image_path=image_path, height=height, width=width, dtype=dtype, device=device
        )
        encoded = video_encoder(image)
        conditionings.append(
            VideoConditionByLatentIndex(latent=encoded, frame_idx=frame_idx, strength=strength)
        )
    return conditionings


def image_conditionings_by_adding_guiding_latent(
    images: List[Tuple[str, int, float]],
    height: int,
    width: int,
    video_encoder,
    dtype,
    device=None,
) -> list:
    """Encode images -> guide-mode (keyframe) conditioning items
    (reference: helpers.py:67-88)."""
    from mlx_video_tpu_torch.ltx_core.conditioning import VideoConditionByKeyframeIndex
    from mlx_video_tpu_torch.ltx_pipelines.utils.media_io import load_image_conditioning

    conditionings = []
    for image_path, frame_idx, strength in images:
        image = load_image_conditioning(
            image_path=image_path, height=height, width=width, dtype=dtype, device=device
        )
        encoded = video_encoder(image)
        conditionings.append(
            VideoConditionByKeyframeIndex(keyframes=encoded, frame_idx=frame_idx, strength=strength)
        )
    return conditionings


def state_with_conditionings(
    latent_state: LatentState, conditioning_items: list, latent_tools
) -> LatentState:
    """Apply each conditioning item to a TOKEN-domain state
    (reference: helpers.py:225-231)."""
    for conditioning in conditioning_items:
        latent_state = conditioning.apply_to(latent_state=latent_state, latent_tools=latent_tools)
    return latent_state


def create_noised_state(
    tools,
    conditionings: list,
    noiser: Noiser,
    dtype,
    device=None,
    noise_scale: float = 1.0,
    initial_latent: Optional[torch.Tensor] = None,
) -> LatentState:
    """Initial token-domain state + conditionings + additive noise
    (reference: helpers.py:207-222). The state starts at the tools' target
    shape on ``device`` (the card when None) and is patchified here (the reference's
    create_initial_state patchifies internally)."""
    state = tools.create_initial_state(dtype=dtype, initial_latent=initial_latent, device=device)
    state = tools.patchify(state)
    state = state_with_conditionings(state, conditionings, tools)
    noise = noiser.noise(state.latent) * noise_scale
    return replace(state, latent=state.latent + noise)


def noise_video_state(
    output_shape,
    noiser: Noiser,
    conditionings: list,
    components,
    dtype,
    noise_scale: float = 1.0,
    initial_latent: Optional[torch.Tensor] = None,
):
    """(reference: helpers.py:153-179). Returns (state, video_tools). The
    state lies on ``components.device`` (the card when None)."""
    from mlx_video_tpu_torch.ltx_core.tools import VideoLatentTools
    from mlx_video_tpu_torch.ltx_core.types import VideoLatentShape

    video_latent_shape = VideoLatentShape.from_pixel_shape(
        shape=output_shape,
        latent_channels=components.video_latent_channels,
        scale_factors=components.video_scale_factors,
    )
    video_tools = VideoLatentTools(
        target_shape=video_latent_shape,
        scale_factors=components.video_scale_factors,
        fps=output_shape.fps,
    )
    state = create_noised_state(
        tools=video_tools,
        conditionings=conditionings,
        noiser=noiser,
        dtype=dtype,
        device=components.device,
        noise_scale=noise_scale,
        initial_latent=initial_latent,
    )
    return state, video_tools


def noise_audio_state(
    output_shape,
    noiser: Noiser,
    conditionings: list,
    components,
    dtype,
    noise_scale: float = 1.0,
    initial_latent: Optional[torch.Tensor] = None,
):
    """(reference: helpers.py:182-204). Returns (state, audio_tools). The
    state lies on ``components.device`` (the card when None)."""
    from mlx_video_tpu_torch.ltx_core.tools import AudioLatentTools
    from mlx_video_tpu_torch.ltx_core.types import AudioLatentShape

    audio_latent_shape = AudioLatentShape.from_video_pixel_shape(output_shape)
    audio_tools = AudioLatentTools(target_shape=audio_latent_shape)
    state = create_noised_state(
        tools=audio_tools,
        conditionings=conditionings,
        noiser=noiser,
        dtype=dtype,
        device=components.device,
        noise_scale=noise_scale,
        initial_latent=initial_latent,
    )
    return state, audio_tools


def simple_denoising_func(video_context: torch.Tensor, audio_context: torch.Tensor, transformer):
    """Unguided AV denoising step closure over an X0Model
    (reference: helpers.py:255-268)."""

    def simple_denoising_step(
        video_state: LatentState, audio_state: LatentState, sigmas, step_index: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma = sigmas[step_index]
        pos_video = modality_from_latent_state(video_state, video_context, sigma)
        pos_audio = modality_from_latent_state(audio_state, audio_context, sigma)
        return transformer(video=pos_video, audio=pos_audio, perturbations=None)

    return simple_denoising_step


def guider_denoising_func(
    guider,
    v_context_p: torch.Tensor,
    v_context_n: torch.Tensor,
    a_context_p: torch.Tensor,
    a_context_n: torch.Tensor,
    transformer,
):
    """Guided AV denoising step closure: positive forward + (when the guider
    is enabled) negative forward combined via ``guider.delta``
    (reference: helpers.py:271-298)."""

    def guider_denoising_step(
        video_state: LatentState, audio_state: LatentState, sigmas, step_index: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma = sigmas[step_index]
        pos_video = modality_from_latent_state(video_state, v_context_p, sigma)
        pos_audio = modality_from_latent_state(audio_state, a_context_p, sigma)
        denoised_video, denoised_audio = transformer(
            video=pos_video, audio=pos_audio, perturbations=None
        )
        if guider.enabled():
            neg_video = modality_from_latent_state(video_state, v_context_n, sigma)
            neg_audio = modality_from_latent_state(audio_state, a_context_n, sigma)
            neg_denoised_video, neg_denoised_audio = transformer(
                video=neg_video, audio=neg_audio, perturbations=None
            )
            denoised_video = denoised_video + guider.delta(denoised_video, neg_denoised_video)
            denoised_audio = denoised_audio + guider.delta(denoised_audio, neg_denoised_audio)
        return denoised_video, denoised_audio

    return guider_denoising_step


def denoise_audio_video(
    output_shape,
    conditionings: list,
    noiser: Noiser,
    sigmas,
    stepper: DiffusionStepProtocol,
    denoising_loop_fn,
    components,
    dtype,
    noise_scale: float = 1.0,
    initial_video_latent: Optional[torch.Tensor] = None,
    initial_audio_latent: Optional[torch.Tensor] = None,
    denoise_fn=None,
) -> Tuple[LatentState, LatentState]:
    """Full composed AV denoise: noised states -> loop -> clear conditioning
    tokens -> unpatchify (reference: helpers.py:301-348), on
    ``components.device`` (the card when None). The reference's
    ``denoising_loop_fn`` closes over its denoise step; this one also takes
    it explicitly as ``denoise_fn`` (the loop helpers in this module take
    ``(sigmas, video_state, audio_state, stepper, denoise_fn)``)."""
    video_state, video_tools = noise_video_state(
        output_shape=output_shape,
        noiser=noiser,
        conditionings=conditionings,
        components=components,
        dtype=dtype,
        noise_scale=noise_scale,
        initial_latent=initial_video_latent,
    )
    audio_state, audio_tools = noise_audio_state(
        output_shape=output_shape,
        noiser=noiser,
        conditionings=[],
        components=components,
        dtype=dtype,
        noise_scale=noise_scale,
        initial_latent=initial_audio_latent,
    )

    if denoise_fn is not None:
        video_state, audio_state = denoising_loop_fn(
            sigmas, video_state, audio_state, stepper, denoise_fn
        )
    else:
        video_state, audio_state = denoising_loop_fn(sigmas, video_state, audio_state, stepper)

    video_state = video_tools.clear_conditioning(video_state)
    video_state = video_tools.unpatchify(video_state)
    audio_state = audio_tools.clear_conditioning(audio_state)
    audio_state = audio_tools.unpatchify(audio_state)
    return video_state, audio_state
