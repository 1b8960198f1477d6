#!/usr/bin/env python3
"""Decode precomputed latents back to video for inspection
(reference: ltx_trainer/scripts/decode_latents.py). On the card unless
``--device cpu``."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Decode latents to mp4")
    parser.add_argument("--latents", required=True, help="latent_*.safetensors file or dir")
    parser.add_argument("--output", required=True)
    parser.add_argument("--model-repo", default="Lightricks/LTX-2")
    parser.add_argument("--fps", type=float, default=24.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from mlx_video_tpu_torch.io import vae_weights
    from mlx_video_tpu_torch.io.media import write_video
    from mlx_video_tpu_torch.io.safetensors import SafetensorsReader
    from mlx_video_tpu_torch.loading import resolve_vae_file
    from mlx_video_tpu_torch.models.ltx.video_vae.decoder import (
        DecoderConfig,
        init_video_decoder,
        video_decoder_apply,
    )
    from mlx_video_tpu_torch.utils.hub import get_model_path

    device = torch.device(args.device)
    model_path = get_model_path(args.model_repo)
    cfg = DecoderConfig()
    decoder = init_video_decoder(torch.Generator(device=device).manual_seed(0), cfg, device=device,
                                 dtype=torch.bfloat16)
    vae_weights.load_video_decoder_weights(resolve_vae_file(model_path), decoder)

    src = Path(args.latents)
    files = [src] if src.is_file() else sorted(src.glob("latent_*.safetensors"))
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in files:
        with SafetensorsReader(f) as r:
            latents = r.get("latents").float().numpy()
        if latents.ndim == 4:
            latents = latents[None]
        with torch.no_grad():
            video = video_decoder_apply(decoder, cfg, torch.from_numpy(latents).to(device, torch.bfloat16))
        out = out_dir / f"{f.stem}.mp4"
        write_video(out, np.asarray(video.float().cpu().numpy(), np.float32), args.fps)
        print(f"Decoded {f.name} -> {out}")


if __name__ == "__main__":
    main()
