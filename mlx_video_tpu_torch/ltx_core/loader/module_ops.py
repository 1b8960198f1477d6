"""Module-ops compat (reference: ltx_core/loader/module_ops.py, a stub)."""

DEFAULT_MODULE_OPS: dict = {}

__all__ = ["DEFAULT_MODULE_OPS"]
