"""Device time by kernel and by class from a torch.profiler run.

Frozen copy of chip_smoke.py:device_times and the kernel classes of
chip_smoke.py:profiled (commit c91ea0888aefe4e03977fc75b911977830a78a4c),
so that a later change to the smoke leaves the yardstick as it is.
:func:`profiled` traces the CUDA activity alone (no CPU op events: a
distilled call launches about 61 k kernels), and :func:`read` sums the
Kineto result's device events without building the profiler's Python event
tree.
"""

from __future__ import annotations

import contextlib
import time

# class -> substrings of the kernel's name, matched in this order (a cuDNN
# convolution's name also holds "gemm" or "xmma": convolution comes first)
CLASSES = {
    "k5_rotate": ("rope_rotate",),
    "k4": ("cross_resident", "cross_stream"),
    "k1": ("flash_fwd",),
    "k3": ("flash_bwd",),
    "k2": ("quant_matmul",),
    "k6": ("flash_int8",),
    "convolution": ("conv", "fprop", "implicit"),
    "int8_gemm": ("gemm_s8", "imma", "s8s8", "i8i8"),
    "gemm": ("gemm", "xmma", "nvjet", "cutlass"),
}
OTHER = "other"  # elementwise, norms, softmax, copies, reductions


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, pats in CLASSES.items() if any(p in low for p in pats)), OTHER)


@contextlib.contextmanager
def profiled(cuda: bool = True):
    """torch.profiler over the block, CUDA activity only; yields a dict that
    holds, after the block, ``wall_s`` (ended by a synchronise) and the
    profile ``prof``. ``cuda=False`` (the CPU tests) traces the CPU's ops
    in place of the card's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    out = {}
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        out["wall_s"] = time.perf_counter() - t0
    out["prof"] = prof


def read(prof, cuda: bool = True) -> dict:
    """From a finished profile: ``kernels`` {name: [seconds, launches]},
    ``classes`` {class: seconds}, ``busy_s`` (the sum of device event time,
    the kernels of one stream do not overlap), ``launches`` and ``gaps``
    [(seconds, next kernel's name)], the idle gaps between consecutive device
    events, longest first (at most 10)."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if cuda else DeviceType.CPU
    kernels, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != want or e.is_async() or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        name, sec = e.name(), e.duration_ns() / 1e9
        slot = kernels.setdefault(name, [0.0, 0])
        slot[0] += sec
        slot[1] += 1
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    classes = {}
    for name, (sec, _) in kernels.items():
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + sec
    spans.sort()
    gaps, end = [], None
    for start, stop, name in spans:
        if end is not None and start > end:
            gaps.append(((start - end) / 1e9, name))
        end = stop if end is None else max(end, stop)
    gaps.sort(reverse=True)
    return {"kernels": kernels, "classes": classes, "busy_s": sum(s for s, _ in kernels.values()),
            "launches": sum(n for _, n in kernels.values()), "gaps": gaps[:10]}
