"""The benchmark's general harness: one run of one cell.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that BENCHMARK.json gives it:

- ``configs/<config>.json``: the configuration's sizes, dtype and weights;
- ``traffic/<traffic>.json``: the mix's parameters, with ``driver`` naming
  ``drivers/<driver>.py``, the code that runs that kind of traffic on the
  program (``setup``, ``call``, ``release``, ``work``, ``judge``, ``UNIT``);
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: each a
  ``read(ctx)`` that returns the metric's value, or None where the run has
  nothing for it to read (the metric is then left out of the line);
- ``limits/<cell>.json``: the limit of each number that ``judge`` compares
  with the plain reference;
- ``roofline/<kernel>.py``: a kernel's work at a shape, for the readers.

A driver's ``work`` gives the model work of one unit of its traffic (a
video, a step); the readers scale it by the units of the traced slice.

A run: set-up (weights and inputs from the seed, the program over them, a
warm-up call at the cell's shapes), then either the measured window (closed
loop, calls back to back until ``seconds`` have passed; ``--trace 0``) or a
profiled slice of ``trace_calls`` calls (``--trace 1``), then the import
check, then the program's state freed and the reference run over a sample
of the calls drawn from the seed. The last line of standard output is the
result's JSON; the compared numbers and their limits are also the last
lines of standard error.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench import noimport, trace

PB = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """A Python file as a module, by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location("portbench_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The cell's end-to-end metrics, and its per-layer metrics: those that
    list it, or list no cells and move one of its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def read_metrics(entries: List[dict], folder: Path, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = load_module(folder / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def summed_phases(records: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in records:
        for k, v in r.get("phases", {}).items():
            out[k] = out.get(k, 0.0) + v
    return out


def device_info(device: str, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def finite(x) -> Optional[float]:
    """A number for the JSON line: None where it is missing or not finite."""
    return float(x) if x is not None and math.isfinite(x) else None


def short(name: str, n: int = 100) -> str:
    return name if len(name) <= n else name[:n]


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        root: Optional[Path] = None, start: Optional[float] = None, err=None) -> Tuple[int, Optional[dict]]:
    """One run; returns (exit code, the result's dict or None)."""
    import torch

    err = sys.stderr if err is None else err
    start = time.perf_counter() if start is None else start
    root = PB.parent if root is None else Path(root)
    pb = root / "portbench"
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        print(f"portbench: no cell {cell_name!r} in BENCHMARK.json", file=err)
        return 2, None
    cell = cells[cell_name]
    cfg = load_json(pb / "configs" / f"{cell['config']}.json")
    traffic = load_json(pb / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(pb / "limits" / f"{cell_name}.json")["limits"]
    driver = load_module(pb / "drivers" / f"{traffic['driver']}.py")
    traffic["window_s"] = None if trace_on else seconds  # a driver whose call fills the window reads it
    bad = noimport.reference_violations(pb / "reference")
    if bad:
        print("portbench: the reference imports " + ", ".join(bad), file=err)
        return 3, None
    e2e, layer = cell_metrics(bench, cell_name)
    cuda = device.startswith("cuda")

    state = driver.setup(cfg, traffic, seed, device)
    records: List[dict] = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if trace_on:
        with trace.profiled(cuda) as prof:
            for i in range(traffic["trace_calls"]):
                records.append(driver.call(state, i))
        data = trace.read(prof["prof"], cuda)
        ctx = {"cell": cell_name, "unit": driver.UNIT, "units": sum(r["units"] for r in records),
               "calls": len(records), "wall_s": prof["wall_s"], "phases": summed_phases(records),
               "work": driver.work(cfg, traffic), "cfg": cfg, "traffic": traffic, "records": records, **data}
        metrics = read_metrics(layer, pb / "metrics", ctx)
        window_s = prof["wall_s"]
    else:
        t0 = time.perf_counter()
        setup_s = t0 - start
        i = 0
        while True:
            records.append(driver.call(state, i))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = noimport.loaded()
    if found:
        print("portbench: the run loaded " + ", ".join(found), file=err)
        return 3, None
    units = sum(r["units"] for r in records)
    if not trace_on:
        ctx = {"cell": cell_name, "unit": driver.UNIT, "units": units, "calls": len(records),
               "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak}
        metrics = read_metrics(e2e, pb / "end_to_end", ctx)

    driver.release(state)
    numbers = driver.judge(state, records, seed)
    correct = set(numbers) == set(limits) and all(numbers[k] <= limits[k] for k in limits)
    dev = device_info(device, peak)
    line = {"correct": bool(correct), "attempted": units, "failed": 0 if correct else units,
            "metrics": metrics, "device": dev}
    if trace_on:
        dev.update(busy_s=ctx["busy_s"], window_s=window_s)
        ops = sorted(ctx["kernels"].items(), key=lambda kv: kv[1][0], reverse=True)[:10]
        line["breakdown"] = {"device_ops": [[short(k), v[0]] for k, v in ops],
                             "idle_gaps": [["before " + short(k), s] for s, k in ctx["gaps"]]}
    line["compared"] = {k: {"value": finite(numbers.get(k)), "limit": limits[k]} for k in limits}
    for k in limits:
        print(f"compared {k} {numbers.get(k, math.nan)!r} limit {limits[k]!r}", file=err)
    return 0, line
