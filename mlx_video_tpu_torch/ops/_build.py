"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``mlx_video_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and the objects are linked into one shared library with a plain C
interface, which the kernel wrappers load with ``ctypes``. The library lands
in ``mlx_video_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
earlier build. A failed build raises.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_library: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of mlx_video_tpu_torch are compiled at first use"
    )


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmvt_kernels_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def load_library() -> ctypes.CDLL:
    """Build the kernels if this source tree has no library yet; load it."""
    global _library
    if _library is not None:
        return _library
    so = library_path()
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        nvcc = find_nvcc()
        sources = [s for s in _sources() if s.suffix == ".cu"]
        objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objects)]
        link = [nvcc, "-shared", "-o", f"{tmp}.so", *(str(o) for o in objects)]
        log = []
        try:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for c in compiles]
            for cmd, proc in zip(compiles, procs):
                log.append(" ".join(cmd) + "\n" + proc.communicate()[0])
            failed = [p.returncode for p in procs if p.returncode != 0]
            if not failed:
                proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                log.append(" ".join(link) + "\n" + proc.stdout)
                failed = [proc.returncode] if proc.returncode != 0 else []
            build_log_path().write_text("\n".join(log))
            if failed:
                raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n" + "\n".join(log))
            os.replace(f"{tmp}.so", so)
        finally:
            for path in (*objects, Path(f"{tmp}.so")):
                path.unlink(missing_ok=True)
    _library = ctypes.CDLL(str(so))
    return _library
