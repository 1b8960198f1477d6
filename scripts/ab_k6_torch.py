"""A/B of design choices in K6, the port's int8 attention kernel
(mlx_video_tpu_torch/csrc/flash_attention_int8.cu), on one NVIDIA GPU.

    python3 scripts/ab_k6_torch.py [--rounds N] [VARIANT ...]

Each variant is the committed kernel source with one textual change
(VARIANTS below). The script copies mlx_video_tpu_torch into a temporary
directory per variant, applies the change (and removes the CUDA sources K6
does not need, so that each copy builds in seconds), then runs the unchanged
copy and the variants in turns, N rounds of base, variants..., each in its own
process, which builds its copy and prints, for bf16 q, k, v at H = 32 and
(B, S, D) = (1, 1280, 128), (2, 5184, 128), (1, 1280, 64): the median time of
K6 alone (20 CUDA-event timings after 3 warm-up calls, on the plain
prologue's operands), the p_q codes that differ from the plain version's and
max |d o| against it. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = "flash_attention_int8.cu"
KEEP = {SOURCE, "flash_attention_fwd.cu", "hopper.cuh"}  # K6, and the error-string entry K1's file holds
SHAPES = [(1, 1280, 128), (2, 5184, 128), (1, 1280, 64)]

# name: (what it tries, [(text in the committed source, its replacement)])
VARIANTS = {
    "expf": ("IEEE expf of the logit's difference to the max instead of ex2.approx", [(
        "    const float p = exp2_approx(__fmul_rn(__fsub_rn(logit, m[(i >> 1) & 1]), LOG2E));",
        "    const float p = expf(__fsub_rn(logit, m[(i >> 1) & 1]));",
    )]),
    "no_turns": ("the two warpgroups issue their products whenever they are ready (no ping-pong)", [
        ("  if (wg == 1) turn_pass(wg);\n  turn_wait(wg);\n", ""),
        ("  wgmma_commit();\n  turn_pass(wg);\n", "  wgmma_commit();\n"),
        ("    turn_wait(wg);\n", ""),
        ("    if (wg == 0 || j + 1 < num_tiles) turn_pass(wg);\n", ""),
    ]),
    "grouped": ("tile j's P V and tile j + 1's Q K^T as one group of products, k-steps interleaved, one wait", [(
        "#pragma unroll\n    for (int kk = 0; kk < BLOCK_N / 32; ++kk) wgmma_s8_rs<D>(acc, pa[kk], desc_v + 2 * kk);\n"
        "    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(acc);\n"
        "    if (wg == 0 || j + 1 < num_tiles) turn_pass(wg);\n    if (j + 1 < num_tiles) {\n"
        "      const int next = (i + 1) % STAGES;\n"
        "      mbar_wait(bar_full + 8 * next, ((i + 1) / STAGES) & 1);\n      wgmma_fence();\n"
        "      qk_products<D>(s, desc_q, make_desc_sw(ring + next * L::STAGE_BYTES, 8 * D, D));\n"
        "      wgmma_commit();\n    }\n",
        "    if (j + 1 < num_tiles) {\n      const int next = (i + 1) % STAGES;\n"
        "      const uint64_t desc_k = make_desc_sw(ring + next * L::STAGE_BYTES, 8 * D, D);\n"
        "      mbar_wait(bar_full + 8 * next, ((i + 1) / STAGES) & 1);\n"
        "#pragma unroll\n      for (int kk = 0; kk < BLOCK_N / 32; ++kk) {\n"
        "        wgmma_s8_rs<D>(acc, pa[kk], desc_v + 2 * kk);\n"
        "        if (kk == 0) wgmma_s8_ss_n128_first(s, desc_q, desc_k);\n"
        "        if (kk > 0 && kk < D / 32) wgmma_s8_ss_n128(s, desc_q + 2 * kk, desc_k + 2 * kk, 1);\n"
        "      }\n    } else {\n#pragma unroll\n"
        "      for (int kk = 0; kk < BLOCK_N / 32; ++kk) wgmma_s8_rs<D>(acc, pa[kk], desc_v + 2 * kk);\n    }\n"
        "    wgmma_commit();\n    if (wg == 0 || j + 1 < num_tiles) turn_pass(wg);\n",
    )]),
    "turn_after_qk": ("the turn passes only once tile j + 1's Q K^T is issued too", [
        ("    wgmma_wait<0>();\n    fence_regs(acc);\n    if (wg == 0 || j + 1 < num_tiles) turn_pass(wg);\n",
         "    wgmma_wait<0>();\n    fence_regs(acc);\n"),
        ("      wgmma_commit();\n    }\n    wgmma_wait<0>();\n    fence_regs(s);\n",
         "      wgmma_commit();\n    }\n    if (wg == 0 || j + 1 < num_tiles) turn_pass(wg);\n"
         "    wgmma_wait<0>();\n    fence_regs(s);\n"),
    ]),
    "pass1_waits": ("pass 1 waits for tile j + 1's Q K^T before it takes tile j's extreme", [(
        "      issue_qk(nxt, j + 1);\n      wgmma_wait<1>();\n",
        "      issue_qk(nxt, j + 1);\n      wgmma_wait<0>();\n",
    )]),
    "stages6": ("a ring of 6 stages instead of 4", [(
        "constexpr int STAGES = 4; ", "constexpr int STAGES = 6; ",
    )]),
    # Not a design: clock64() counters of each warpgroup's first thread, summed
    # over blocks (pass 1; pass 2; pass 2's softmax; pass 2's turn, products
    # and wait), printed per 128-key tile after the timings.
    "profile": ("the committed source with cycle counters per phase", [
        ("#include <limits.h>\n", "#include <limits.h>\n__device__ unsigned long long k6_cycles[6];\n"),
        ("  mbar_wait(bar_q, 0);\n",
         "  mbar_wait(bar_q, 0);\n  long long t_pass = clock64(), t_mark = 0, soft = 0, issue = 0;\n"),
        ("  float m[2];\n", "  const long long pass1 = clock64() - t_pass;\n  t_pass = clock64();\n  float m[2];\n"),
        ("    if (n0 + BLOCK_N > S) {\n      p_codes_tile<true, CODES>",
         "    t_mark = clock64();\n    if (n0 + BLOCK_N > S) {\n      p_codes_tile<true, CODES>"),
        ("    fence_regs(pa);\n    wgmma_fence();\n",
         "    fence_regs(pa);\n    soft += clock64() - t_mark;\n    t_mark = clock64();\n    wgmma_fence();\n"),
        ("    wgmma_wait<0>();\n    fence_regs(s);\n    if (releases)",
         "    wgmma_wait<0>();\n    fence_regs(s);\n    issue += clock64() - t_mark;\n    if (releases)"),
        ("  // Normalise by the codes' own sum",
         "  if (tid % 128 == 0) {\n"
         "    const long long v[6] = {pass1, clock64() - t_pass, soft, issue, num_tiles, 1};\n"
         "    for (int x = 0; x < 6; ++x) atomicAdd(&k6_cycles[x], static_cast<unsigned long long>(v[x]));\n"
         "  }\n  // Normalise by the codes' own sum"),
        ("extern \"C\" int mvt_flash_attention_int8(",
         "extern \"C\" int mvt_k6_cycles(unsigned long long* out) {\n"
         "  cudaError_t err = cudaMemcpyFromSymbol(out, k6_cycles, sizeof(k6_cycles));\n"
         "  const unsigned long long zero[6] = {};\n"
         "  return static_cast<int>(err != cudaSuccess ? err : cudaMemcpyToSymbol(k6_cycles, zero, sizeof(zero)));\n"
         "}\n\nextern \"C\" int mvt_flash_attention_int8("),
    ]),
}


def make_copy(workdir: Path, name: str) -> Path:
    """mlx_video_tpu_torch with the variant's change, under workdir/name."""
    dst = workdir / name
    shutil.copytree(ROOT / "mlx_video_tpu_torch", dst / "mlx_video_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = dst / "mlx_video_tpu_torch" / "csrc"
    for path in csrc.iterdir():
        if path.name not in KEEP:
            path.unlink()
    src = (csrc / SOURCE).read_text()
    for old, new in VARIANTS[name][1] if name != "base" else []:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to change is not once in {SOURCE}: {old!r}")
        src = src.replace(old, new)
    (csrc / SOURCE).write_text(src)
    return dst


def measure() -> None:
    """In a copy's directory: build, then time and check K6 at SHAPES (and,
    where the library counts cycles, print them per tile)."""
    import ctypes

    import torch

    sys.path.insert(0, os.getcwd())
    from mlx_video_tpu_torch.ops import _build
    from mlx_video_tpu_torch.ops import flash_attention as fa

    lib = _build.load_library()
    kernel = "?"
    for line in _build.build_log_path().read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = entry.group(1)
        if "flash_int8_kernelILi128E13__nv_bfloat16Lb0E" in kernel and ("registers" in line or "spill" in line):
            print(f"    ptxas (D=128, bf16): {line.split(':', 1)[-1].strip()}", flush=True)

    def median_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    g = torch.Generator(device="cuda").manual_seed(19)
    for b, s, d in SHAPES:
        q, k, v = (torch.randn(b, s, 32, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        ops = fa.int8_attention_operands(q, k, v, d**-0.5)
        out, codes = fa.int8_attention_kernel(ops, b, 32, return_codes=True)
        ref, ref_codes = fa.flash_attention_int8_reference(q, k, v, return_codes=True)
        flips, n = (codes != ref_codes).sum().item(), codes.numel()
        err = (out.float() - ref.float()).abs().max().item()
        del codes, ref_codes, out, ref
        ms = median_ms(lambda: fa.int8_attention_kernel(ops, b, 32))
        print(f"    B={b} S={s} D={d}: K6 {ms:.4f} ms  p_q codes that differ {flips} of {n}  max|d o| {err:.3e}",
              flush=True)
        if hasattr(lib, "mvt_k6_cycles"):
            cycles = (ctypes.c_ulonglong * 6)()
            lib.mvt_k6_cycles(cycles)
            fa.int8_attention_kernel(ops, b, 32)
            torch.cuda.synchronize()
            lib.mvt_k6_cycles(cycles)
            per_tile = [c / cycles[4] for c in cycles[:4]]
            print("      cycles a 128-key tile, per warpgroup: pass 1 {:.0f}; pass 2 {:.0f}, of which the softmax "
                  "{:.0f} and the turn, products and wait {:.0f}".format(*per_tile), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"of {', '.join(VARIANTS)}")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure:
        measure()
        return 0
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="ab_k6_") as tmp:
        copies = {name: make_copy(Path(tmp), name) for name in ["base", *args.variants]}
        for rnd in range(args.rounds):
            for name, path in copies.items():
                what = VARIANTS[name][0] if name != "base" else "the committed source"
                print(f"round {rnd + 1}, {name}: {what}", flush=True)
                proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure"], cwd=path)
                if proc.returncode != 0:
                    return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
