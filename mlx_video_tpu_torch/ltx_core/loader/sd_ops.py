"""State-dict ops compat (reference: ltx_core/loader/sd_ops.py, a stub)."""

LTXV_MODEL_COMFY_RENAMING_MAP: dict = {}


class SDOps:
    """Compat marker for state-dict transformation pipelines."""


__all__ = ["LTXV_MODEL_COMFY_RENAMING_MAP", "SDOps"]
