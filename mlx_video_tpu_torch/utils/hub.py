"""Model repo resolution: aliases, local paths, HF cache, optional download.

The port's own copy of mlx_video_tpu/utils/hub.py (framework-free code, copied whole and
unchanged in behaviour), so that the port imports nothing of the JAX package.

Behavioral spec: reference mlx_video/utils.py:15-375 (alias table, local-path
passthrough, cached-snapshot preference, LTX_HF_REFRESH, selective download
patterns). Downloads are best-effort — in air-gapped TPU pods resolution
relies on pre-populated caches or explicit local paths.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

MODEL_REPO_ALIASES = {
    "ltx2-dev-8bit-mlx": "AITRADER/ltx2-dev-8bit-mlx",
    "ltx2-dev-4bit-mlx": "AITRADER/ltx2-dev-4bit-mlx",
    "ltx2-distilled-8bit-mlx": "AITRADER/ltx2-distilled-8bit-mlx",
    "ltx2-distilled-4bit-mlx": "AITRADER/ltx2-distilled-4bit-mlx",
}

REQUIRED_MODEL_FILES = [
    "vae/diffusion_pytorch_model.safetensors",
    "audio_vae/diffusion_pytorch_model.safetensors",
    "vocoder/diffusion_pytorch_model.safetensors",
    "ltx-2-spatial-upscaler-x2-1.0.safetensors",
]


def has_required_files(path: Path) -> bool:
    """A snapshot is usable with a unified bundle, a single 19B file, or the
    per-subsystem layout (reference: utils.py:34-48)."""
    path = Path(path)
    if (path / "model.safetensors").exists():
        return True
    if any(path.glob("ltx-2-19b-*.safetensors")):
        return True
    return all((path / rel).exists() for rel in REQUIRED_MODEL_FILES)


def _hf_cache_snapshot(repo_id: str) -> Optional[Path]:
    """Newest local snapshot for a repo in the HF cache, if any."""
    cache_root = Path(
        os.environ.get("HF_HUB_CACHE")
        or os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")
    )
    if cache_root.name != "hub":
        cache_root = cache_root / "hub"
    repo_dir = cache_root / f"models--{repo_id.replace('/', '--')}"
    snapshots = repo_dir / "snapshots"
    if not snapshots.exists():
        return None
    candidates = sorted(snapshots.iterdir(), key=lambda p: p.stat().st_mtime)
    return candidates[-1] if candidates else None


def get_model_path(
    model_repo: str,
    require_files: bool = True,
    allow_download: bool = True,
    allow_patterns: Optional[List[str]] = None,
) -> Path:
    """Resolve a repo id / alias / local path to a directory of weights."""
    repo = MODEL_REPO_ALIASES.get(model_repo, model_repo)

    local = Path(repo).expanduser()
    if local.exists():
        return local

    refresh = os.environ.get("LTX_HF_REFRESH") == "1"
    cached = _hf_cache_snapshot(repo)
    if cached is not None and not refresh:
        if not require_files or has_required_files(cached):
            return cached

    if allow_download:
        try:
            from huggingface_hub import snapshot_download

            token = os.environ.get("HF_TOKEN") or os.environ.get("HUGGINGFACE_HUB_TOKEN")
            resolved = snapshot_download(
                repo_id=repo, allow_patterns=allow_patterns, token=token
            )
            return Path(resolved)
        except Exception as exc:
            if cached is not None:
                return cached
            raise FileNotFoundError(
                f"Model '{model_repo}' is not available locally and download failed: {exc}"
            ) from exc

    if cached is not None:
        return cached
    raise FileNotFoundError(f"Model '{model_repo}' not found locally (downloads disabled).")
