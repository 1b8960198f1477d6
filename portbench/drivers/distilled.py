"""Driver of the distilled traffic: closed-loop calls of the port's
``generate_video`` (pipelines/generate.py), the distilled pipeline from a
prompt embedding to decoded frames, ``num_videos`` videos a call, one client.

What a traffic file (portbench/traffic/*.json, ``"driver": "distilled"``)
sets: ``height``, ``width``, ``num_frames``, ``stage1_steps``,
``stage2_steps``, ``num_videos``, ``tiling``, ``check_calls`` (the calls the
reference recomputes after the window) and ``trace_calls`` (the calls a
traced run profiles).

The weights and the prompt embedding are drawn from the seed on the card
(portbench/weights.py) and loaded into the program's modules as they are;
the reference (portbench/reference/ltx_video.py) reads the same tensors.
Call i's video j draws its noise from the seed :func:`call_seeds` gives.
"""

from __future__ import annotations

import gc
import random
from typing import Dict, List

import numpy as np

from portbench import flops
from portbench.reference import ltx_video
from portbench.weights import draw_context, draw_weights, quantized_names

UNIT = "video"


def call_seeds(seed: int, i: int, n: int) -> List[int]:
    """The noise seeds of call ``i``'s ``n`` videos (call -1: the warm-up)."""
    return [(int(seed) * 1_000_003 + 1000 * (i + 1) + j) % 2 ** 62 for j in range(n)]


def program_bundle(cfg: dict, weights: Dict[str, Dict], context, device):
    """The program's ModelBundle and TextConditioning over the drawn tensors
    (the upsampler and the decoder where ``weights`` holds them)."""
    import torch

    from mlx_video_tpu_torch.config import LTXModelConfig, LTXModelType, LTXRopeType
    from mlx_video_tpu_torch.models.ltx.model import LTXModel
    from mlx_video_tpu_torch.models.ltx.upsampler import LatentUpsampler
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, VideoDecoder
    from mlx_video_tpu_torch.ops.quant import use_quant_linears
    from mlx_video_tpu_torch.pipelines.generate import ModelBundle, TextConditioning

    dt = getattr(torch, cfg["dtype"])
    config = LTXModelConfig(
        model_type=LTXModelType.VideoOnly, num_attention_heads=cfg["num_attention_heads"],
        attention_head_dim=cfg["attention_head_dim"], in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"], num_layers=cfg["num_layers"],
        cross_attention_dim=cfg["cross_attention_dim"], caption_channels=cfg["caption_channels"],
        positional_embedding_theta=cfg["positional_embedding_theta"],
        positional_embedding_max_pos=tuple(cfg["positional_embedding_max_pos"]),
        rope_type=LTXRopeType(cfg["rope_type"]), double_precision_rope=True,
        timestep_scale_multiplier=cfg["timestep_scale_multiplier"], norm_eps=cfg["norm_eps"])
    dit = LTXModel(config, device="meta", dtype=dt)
    q = cfg.get("quant")
    if q:
        use_quant_linears(dit, {name: (q["bits"], q["group_size"], getattr(torch, q["scale_dtype"]))
                                for name in quantized_names(cfg)})
    dit.load_state_dict(weights["dit"], strict=True, assign=True)
    dcfg = DecoderConfig(**cfg["decoder"])
    ups = dec = None
    if "upsampler" in weights:
        u = cfg["upsampler"]
        ups = LatentUpsampler(u["in_channels"], u["mid_channels"], u["num_blocks"], device="meta", dtype=dt)
        ups.load_state_dict(weights["upsampler"], strict=True, assign=True)
    if "decoder" in weights:
        dec = VideoDecoder(dcfg, device="meta", dtype=dt)
        dec.load_state_dict(weights["decoder"], strict=True, assign=True)
    bundle = ModelBundle(transformer=dit, transformer_config=config, vae_decoder=dec, vae_decoder_config=dcfg,
                         upsampler=ups)
    return bundle, TextConditioning(video_embeddings=context)


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Weights and embedding from the seed, the program over them, and one
    warm-up call at the traffic's shapes."""
    weights = draw_weights(cfg, seed, device)
    context = draw_context(cfg, seed, device)
    bundle, text = program_bundle(cfg, weights, context, device)
    state = {"cfg": cfg, "traffic": traffic, "seed": seed, "device": device, "weights": weights,
             "context": context, "bundle": bundle, "text": text}
    call(state, -1)
    return state


def call(state: dict, i: int) -> dict:
    """One timed call; returns its record: seeds, final latents and frames
    (host), phase seconds, and the videos it completed."""
    from mlx_video_tpu_torch.pipelines.generate import generate_video

    t = state["traffic"]
    seeds = call_seeds(state["seed"], i, t["num_videos"])
    res = generate_video(state["bundle"], state["text"], height=t["height"], width=t["width"],
                         num_frames=t["num_frames"], seeds=seeds, num_videos=t["num_videos"],
                         stage1_steps=t["stage1_steps"], stage2_steps=t["stage2_steps"], tiling=t["tiling"])
    return {"seeds": seeds, "latents": res.latents, "video": res.video, "phases": dict(res.phase_seconds),
            "units": t["num_videos"]}


def release(state: dict) -> None:
    """Drop the program's modules and state; the drawn tensors stay for the
    reference."""
    import torch

    state.pop("bundle", None)
    state.pop("text", None)
    gc.collect()
    if str(state["device"]).startswith("cuda"):
        torch.cuda.empty_cache()


def work(cfg: dict, traffic: dict) -> dict:
    """One video's model work (portbench/flops.py): a call's over its
    videos."""
    call = flops.distilled_call(cfg, traffic)
    n = traffic["num_videos"]
    return {"flops": call["flops"] / n, "block_linears": [(m, k, nn, c / n) for m, k, nn, c in call["block_linears"]]}


def reference(state: dict, seeds, lowp: bool = False) -> dict:
    import torch

    with torch.no_grad():
        return ltx_video.distilled(state["weights"], state["cfg"], state["traffic"], state["context"], seeds,
                                   state["device"], lowp=lowp)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def compare(record: dict, ref: dict) -> Dict[str, float]:
    """The worst video's relative L2 distance from the reference, of the
    final latents and of the decoded frames."""
    lat = ref["latents"].numpy()
    vid = ref["video"].numpy()
    return {
        "latent_rel_l2": max(rel_l2(record["latents"][i], lat[i]) for i in range(lat.shape[0])),
        "video_rel_l2": max(rel_l2(record["video"][i], vid[i]) for i in range(vid.shape[0])),
    }


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading, NaN where any is not finite."""
    return {k: max(r[k] for r in rows) if all(np.isfinite(r[k]) for r in rows) else float("nan") for k in rows[0]}


def picks_of(records: List[dict], k: int, seed: int) -> List[int]:
    """The calls the reference recomputes: ``k`` of them, drawn from the seed."""
    return sorted(random.Random(int(seed)).sample(range(len(records)), min(k, len(records))))


def judge(state: dict, records: List[dict], seed: int) -> Dict[str, float]:
    """The compared numbers: the worst over the sampled calls' videos."""
    picks = picks_of(records, state["traffic"]["check_calls"], seed)
    return worst([compare(records[i], reference(state, records[i]["seeds"])) for i in picks])


def control(state: dict, records: List[dict], picks: List[int]) -> Dict[str, float]:
    """The reference in float8 in the program's place, judged as the program
    is."""
    rows = []
    for i in picks:
        low = reference(state, records[i]["seeds"], lowp=True)
        rows.append(compare({k: v.numpy() for k, v in low.items()}, reference(state, records[i]["seeds"])))
    return worst(rows)
