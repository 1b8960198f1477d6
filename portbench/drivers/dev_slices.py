"""Driver of the dev traffic: consecutive slices of the dev schedule through
the port's ``denoise`` (pipelines/denoise.py), classifier-free guidance
batched over the doubled batch, one image conditioning at frame 0 in
replace mode, one client, each call ended by a synchronise.

What a traffic file (``"driver": "dev_slices"``) sets: ``height``,
``width``, ``num_frames``, ``steps`` (the schedule), ``slice_steps`` (the
steps a call takes), ``cfg_scale``, ``check_calls`` and ``trace_calls``.

Set-up draws the DiT and the VAE encoder, the prompt and negative
embeddings and a smooth conditioning image from the seed, encodes the image
with the program's encoder (``video_encoder_apply``) and builds the
conditioned state as ``generate_video`` does (``_conditioned_state``). A
call takes the next ``slice_steps`` steps from the state the last one left;
when the schedule ends, the next call starts it again from fresh noise
(wrap w draws from :func:`noise_seed`).

The reference follows the program slice by slice: it starts a sampled
slice from the program's own latents at the slice's start (a whole run of
the schedule takes longer than a window) with its own encoded clean latent,
and the start that this skips, the encoded image, is compared by itself.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np

from portbench import flops
from portbench.drivers.distilled import picks_of, program_bundle, rel_l2
from portbench.reference import ltx_dev
from portbench.reference.ltx_video import DiT
from portbench.weights import draw_context, draw_weights

UNIT = "dev_step"


def noise_seed(seed: int, wrap: int) -> int:
    return (int(seed) * 1_000_003 + 7 + 1000 * wrap) % 2 ** 62


def seeded_image(seed: int, height: int, width: int, device, dtype):
    """A smooth RGB frame (1, 3, 1, H, W) in [-1, 1]: 12 x 12 uniform draws
    upsampled bilinearly."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0x1A6E)
    low = torch.rand((1, 3, 12, 12), generator=g, device=device)
    img = F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False)
    return (img * 2.0 - 1.0).to(dtype)[:, :, None]


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    import torch

    from mlx_video_tpu_torch.config import VideoVAEConfig
    from mlx_video_tpu_torch.models.ltx.video_vae.encoder import VideoEncoder, video_encoder_apply
    from mlx_video_tpu_torch.pipelines.positions import create_position_grid
    from mlx_video_tpu_torch.pipelines.schedulers import ltx2_scheduler

    dt = getattr(torch, cfg["dtype"])
    weights = draw_weights(cfg, seed, device, parts=("encoder",))
    context = draw_context(cfg, seed, device)
    neg = draw_context(cfg, seed + 1, device)
    image = seeded_image(seed, traffic["height"], traffic["width"], device, dt)
    e = cfg["encoder"]
    vae_cfg = VideoVAEConfig(in_channels=e["in_channels"], out_channels=e["out_channels"], latent_channels=e["out_channels"],
                             patch_size=e["patch_size"], encoder_blocks=tuple((n, dict(b)) for n, b in e["blocks"]))
    encoder = VideoEncoder(vae_cfg, device="meta", dtype=dt)
    encoder.load_state_dict(weights["encoder"], strict=True, assign=True)
    with torch.no_grad():
        encoded = video_encoder_apply(encoder, vae_cfg, image)
    bundle, _ = program_bundle(cfg, {"dit": weights["dit"]}, context, device)
    t = traffic
    frames = 1 + (t["num_frames"] - 1) // 8
    lh, lw = t["height"] // 32, t["width"] // 32
    state = {"cfg": cfg, "traffic": t, "seed": seed, "device": device, "weights": weights, "context": context,
             "neg": neg, "image": image, "encoded": encoded.float().cpu(), "bundle": bundle,
             "shape": (1, cfg["in_channels"], frames, lh, lw),
             "positions": torch.from_numpy(create_position_grid(1, frames, lh, lw)).to(device),
             "sigmas": ltx2_scheduler(steps=t["steps"], num_tokens=frames * lh * lw), "encoded_dev": encoded}
    state["cond"] = fresh(state, 0)
    call(state, -1)
    state["cond"] = fresh(state, 0)
    return state


def fresh(state: dict, wrap: int):
    """The conditioned state at the schedule's start, its noise from
    :func:`noise_seed` (``generate_video``'s ``_conditioned_state``)."""
    import torch

    from mlx_video_tpu_torch.pipelines.conditioning import VideoConditionByLatentIndex
    from mlx_video_tpu_torch.pipelines.generate import _conditioned_state

    dev, shape = state["device"], state["shape"]
    g = torch.Generator(device=dev).manual_seed(noise_seed(state["seed"], wrap))

    def noise(s):
        return torch.randn(s, generator=g, device=dev, dtype=torch.float32).to(state["encoded_dev"].dtype)

    zeros = torch.zeros(shape, dtype=state["encoded_dev"].dtype, device=dev)
    cond = [VideoConditionByLatentIndex(latent=state["encoded_dev"], frame_idx=0, strength=1.0)]
    return _conditioned_state(zeros, cond, noise, float(state["sigmas"][0]))


def call(state: dict, i: int) -> dict:
    """Slice ``i`` (-1: the warm-up, on the first slice): ``slice_steps``
    guided steps from the carried state; returns the latents before and
    after (host), the slice's sigmas and its steps."""
    import torch

    from mlx_video_tpu_torch.pipelines import denoise as dn

    t = state["traffic"]
    per = t["steps"] // t["slice_steps"]
    k = max(i, 0) % per
    if i > 0 and k == 0:
        state["cond"] = fresh(state, i // per)
    cond = state["cond"]
    sig = state["sigmas"][k * t["slice_steps"]:(k + 1) * t["slice_steps"] + 1]
    with torch.no_grad():
        latents, _ = dn.denoise(state["bundle"].transformer, state["bundle"].transformer_config, cond.latent,
                                state["positions"], state["context"], sig, neg_context=state["neg"],
                                cfg_scale=t["cfg_scale"], state=cond)
    if str(state["device"]).startswith("cuda"):
        torch.cuda.synchronize()
    state["cond"] = cond._replace(latent=latents)
    return {"start": cond.latent.float().cpu(), "end": latents.float().cpu(), "mask": cond.denoise_mask.float().cpu(),
            "sigmas": [float(s) for s in sig], "units": len(sig) - 1, "phases": {}}


def release(state: dict) -> None:
    import torch

    for key in ("bundle", "cond", "encoded_dev"):
        state.pop(key, None)
    gc.collect()
    if str(state["device"]).startswith("cuda"):
        torch.cuda.empty_cache()


def work(cfg: dict, traffic: dict) -> dict:
    """One step's model work: a forward of the doubled batch."""
    f = 1 + (traffic["num_frames"] - 1) // 8
    s = f * (traffic["height"] // 32) * (traffic["width"] // 32)
    cap = cfg["caption_positions"]
    linears = [(m, k, nn, c * cfg["num_layers"]) for m, k, nn, c in flops.dit_block_linears(cfg, 2, s, cap)]
    return {"flops": flops.dit_forward_flops(cfg, 2, s, cap), "block_linears": linears,
            "self_attention": [(2, s, cfg["num_attention_heads"], cfg["attention_head_dim"], cfg["num_layers"])]}


def reference(state: dict, record: dict, clean, lowp: bool = False):
    import torch

    dev = state["device"]
    dit = DiT(state["weights"]["dit"], state["cfg"], lowp=lowp)
    dt = getattr(torch, state["cfg"]["dtype"])
    with torch.no_grad():
        return ltx_dev.cfg_slice(dit, record["start"].to(dev, dt), clean.to(dev, dt), record["mask"].to(dev, dt),
                                 state["context"], state["neg"], record["sigmas"], state["traffic"]["cfg_scale"])


def encode_reference(state: dict, lowp: bool = False):
    import torch

    with torch.no_grad():
        return ltx_dev.encode(state["weights"]["encoder"], state["cfg"]["encoder"], state["image"], lowp)


def numbers(state: dict, records: List[dict], picks: List[int], lowp: bool = False, program=None) -> Dict[str, float]:
    """``encode_rel_l2``: the encoded image against the reference's encoder;
    ``slice_rel_l2``: the worst sampled slice's end latents against the
    reference's steps from the same start. ``program`` (the control) stands
    in place of the program's outputs: (encoded, {pick: end latents})."""
    clean = encode_reference(state)
    enc = state["encoded"] if program is None else program[0]
    slices = []
    for i in picks:
        end = records[i]["end"] if program is None else program[1][i]
        slices.append(rel_l2(end.numpy(), reference(state, records[i], clean).float().cpu().numpy()))
    return {"encode_rel_l2": rel_l2(enc.numpy(), clean.float().cpu().numpy()),
            "slice_rel_l2": max(slices) if all(np.isfinite(slices)) else float("nan")}


def judge(state: dict, records: List[dict], seed: int) -> Dict[str, float]:
    return numbers(state, records, picks_of(records, state["traffic"]["check_calls"], seed))


def control(state: dict, records: List[dict], picks: List[int]) -> Dict[str, float]:
    """The reference in float8 in the program's place, judged as the program
    is: its encoded image and its slices from the program's starts."""
    enc = encode_reference(state, lowp=True)
    ends = {i: reference(state, records[i], enc, lowp=True).float().cpu() for i in picks}
    return numbers(state, records, picks, program=(enc.float().cpu(), ends))
