"""What the metric readers share: the traced slice's quantities per unit of
the cell's traffic, and a kernel's roofline share over the slice."""

from __future__ import annotations

from typing import Optional

from portbench.roofline import PEAKS


def per_unit(ctx: dict, unit: str, value: Optional[float]) -> Optional[float]:
    """``value`` over the slice's units, where the cell's unit is ``unit``
    and the value exists."""
    if ctx.get("unit") != unit or value is None or not ctx.get("units"):
        return None
    return value / ctx["units"]


def class_ms(ctx: dict, unit: str, cls: str) -> Optional[float]:
    """Device milliseconds of a kernel class (portbench/trace.py) per unit."""
    sec = ctx.get("classes", {}).get(cls)
    return per_unit(ctx, unit, None if sec is None else 1e3 * sec)


def kernel_seconds(ctx: dict, pattern: str) -> float:
    return sum(sec for name, (sec, _) in ctx.get("kernels", {}).items() if pattern in name.lower())


def idle_share(ctx: dict, unit: str) -> Optional[float]:
    """Per cent of the traced slice's wall in which no device operation ran."""
    if ctx.get("unit") != unit or not ctx.get("wall_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["wall_s"])


def mfu(ctx: dict, unit: str) -> Optional[float]:
    """Per cent of the card's bf16 peak: the slice's model operations (a
    unit's, times its units) over its wall."""
    if ctx.get("unit") != unit or not ctx.get("wall_s"):
        return None
    return 100.0 * ctx["work"]["flops"] * ctx["units"] / (ctx["wall_s"] * PEAKS["bf16_flops_per_s"])

