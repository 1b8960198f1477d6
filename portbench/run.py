"""The port's benchmark: one run of one cell on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json, portbench/ and
the program (mlx_video_tpu_torch/). Exits non-zero with no result when CUDA
is missing or has fewer devices than the cell asks for, when the run has
loaded jax, jaxlib, flax or mlx_video_tpu, or when the program is missing.
Every build and kernel cache stays inside the checkout: the program's
kernels build into mlx_video_tpu_torch/_build/, and the caches PyTorch,
Triton and CUDA would write go under .portbench_cache/.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((c["chips"] for c in bench["workloads"] if c["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    import importlib.util

    if importlib.util.find_spec("mlx_video_tpu_torch") is None:
        print("portbench: the program (mlx_video_tpu_torch) is not in the checkout", file=sys.stderr)
        return 2
    from portbench import harness

    rc, line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", start=START)
    if line is not None:
        sys.stderr.flush()
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
