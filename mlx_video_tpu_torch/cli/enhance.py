"""``python -m mlx_video_tpu_torch.enhance``: standalone prompt enhancement.

Counterpart of mlx_video_tpu/cli/enhance.py on the same flags, plus
``--device`` (default ``cuda``; the CPU takes ``--device cpu``): the Gemma
text encoder of ``--enhancer-repo`` (else ``--model-repo``) chats with the
bundled T2V or I2V system prompt and prints the enhanced prompt, or with
``--json`` a ``{"prompt", "enhanced"}`` object.
"""

from __future__ import annotations

import argparse
import json


def base_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flag surface (mlx_video_tpu/cli/enhance.py:build_parser)."""
    p = argparse.ArgumentParser(description="Enhance a prompt with the Gemma text encoder")
    p.add_argument("--prompt", "-p", required=True)
    p.add_argument("--model-repo", default="Lightricks/LTX-2",
                   help="Base repo (system prompts + connectors)")
    p.add_argument("--enhancer-repo", default=None,
                   help="Override repo for the Gemma weights")
    p.add_argument("--mode", default="t2v", choices=["t2v", "i2v"])
    p.add_argument("--max-tokens", "--max-new-tokens", type=int, default=512,
                   dest="max_tokens")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="Emit {prompt, enhanced} JSON")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = base_parser()
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; exits when CUDA is absent)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import torch

    from mlx_video_tpu_torch.models.ltx.text_encoder import LTX2TextEncoder
    from mlx_video_tpu_torch.utils.hub import get_model_path

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("enhance: --device cuda but CUDA is not available (pass --device cpu to run on the CPU)")
    model_path = get_model_path(args.model_repo)
    te_path = get_model_path(args.enhancer_repo) if args.enhancer_repo else model_path
    encoder = LTX2TextEncoder.load(model_path, te_path, dtype=torch.bfloat16, device=device)
    kwargs = dict(max_new_tokens=args.max_tokens, temperature=args.temperature)
    enhanced = (
        encoder.enhance_i2v(args.prompt, **kwargs)
        if args.mode == "i2v"
        else encoder.enhance_t2v(args.prompt, **kwargs)
    )
    if args.json:
        print(json.dumps({"prompt": args.prompt, "enhanced": enhanced}))
    else:
        print(enhanced)


if __name__ == "__main__":
    main()
