"""One file a kernel: the work (operations, bytes) of one call at a shape,
counted from the shape alone (``work``), and the least time of that work on
the card (``bound_s``, from portbench/peaks.json). Frozen copies of
chip_smoke.py:bound and its ``*_work`` functions at commit c91ea08."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float, peak_ops: float = PEAKS["bf16_flops_per_s"]) -> float:
    """The least time for the work: the larger of operations over the peak
    rate and bytes over the peak bandwidth."""
    return max(flops / peak_ops, nbytes / PEAKS["hbm_bytes_per_s"])
