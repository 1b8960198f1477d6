"""Threaded file prefetching: ctypes bindings for the native C++ pool.

Counterpart of mlx_video_tpu/io/prefetch.py. The pool
(mlx_video_tpu_torch/native/prefetch.cpp) preads whole files on background
threads, so the next batch's disk IO overlaps the current training step on
the card; ``advise_willneed`` hints the page cache to read a weight file
ahead of the reader's mmap stream.

The library is built with ``g++`` at first use (a module import builds
nothing) into ``mlx_video_tpu_torch/_build/``, under a name that carries a
hash of the source and flags, so an unchanged tree reuses the earlier build.
A failed build raises. ``MLX_VIDEO_TPU_NO_NATIVE=1`` (the JAX package's
opt-out) asks for no native code: the prefetcher then reads on a
``ThreadPoolExecutor`` and ``advise_willneed`` does nothing. (The JAX module
also takes that path, quietly, when its build fails; the port does not.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

from mlx_video_tpu_torch.ops._build import BUILD_DIR, PACKAGE_DIR

NATIVE_SRC = PACKAGE_DIR / "native" / "prefetch.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libmvt_prefetch_{digest.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile prefetch.cpp into its shared library unless this source
    already has one; returns the library's path. Raises when the compiler
    is missing or fails."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(NATIVE_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed with exit code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load_lib() -> Optional[ctypes.CDLL]:
    """The native library (built at first use), or None under the opt-out."""
    global _LIB
    if os.environ.get("MLX_VIDEO_TPU_NO_NATIVE") == "1":
        return None
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_native()))
    lib.pf_create.restype = ctypes.c_void_p
    lib.pf_create.argtypes = [ctypes.c_int]
    lib.pf_submit.restype = ctypes.c_int64
    lib.pf_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pf_wait.restype = ctypes.c_int
    lib.pf_wait.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.pf_release.restype = None
    lib.pf_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pf_destroy.restype = None
    lib.pf_destroy.argtypes = [ctypes.c_void_p]
    lib.pf_advise.restype = ctypes.c_int
    lib.pf_advise.argtypes = [ctypes.c_char_p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the native pool is in use: true unless
    ``MLX_VIDEO_TPU_NO_NATIVE=1`` (a failed build raises)."""
    return _load_lib() is not None


def advise_willneed(path) -> None:
    """Hint the page cache to read ahead a file about to be mmap-streamed
    (the safetensors reader calls it)."""
    lib = _load_lib()
    if lib is not None:
        lib.pf_advise(str(path).encode())


class FilePrefetcher:
    """Submit file paths for background reads; ``get`` returns the bytes.

    The native pool, or under ``MLX_VIDEO_TPU_NO_NATIVE=1`` a
    ``ThreadPoolExecutor``. One outstanding read per distinct path; ``get``
    blocks, is single-use (the buffer is released after return), reads a
    path it was not given first, and raises ``OSError`` for a file it
    cannot read.
    """

    def __init__(self, num_threads: int = 4) -> None:
        self._lib = _load_lib()
        self._tickets: Dict[str, int] = {}
        self._futures: Optional[dict] = None
        self._pool = None
        if self._lib is not None:
            self._pool = self._lib.pf_create(num_threads)
        else:
            self._executor = ThreadPoolExecutor(max_workers=num_threads)
            self._futures = {}

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def submit(self, path) -> None:
        key = str(path)
        if self._lib is not None:
            if key not in self._tickets:
                self._tickets[key] = self._lib.pf_submit(self._pool, key.encode())
        elif key not in self._futures:
            self._futures[key] = self._executor.submit(Path(key).read_bytes)

    def get(self, path) -> bytes:
        key = str(path)
        if self._lib is not None:
            ticket = self._tickets.pop(key, None)
            if ticket is None:
                ticket = self._lib.pf_submit(self._pool, key.encode())
            data = ctypes.POINTER(ctypes.c_uint8)()
            size = ctypes.c_uint64()
            err = self._lib.pf_wait(self._pool, ticket, ctypes.byref(data), ctypes.byref(size))
            if err != 0:
                raise OSError(-err, os.strerror(-err), key)
            try:
                return ctypes.string_at(data, size.value)
            finally:
                self._lib.pf_release(self._pool, ticket)
        fut = self._futures.pop(key, None)
        return Path(key).read_bytes() if fut is None else fut.result()

    def close(self) -> None:
        if self._lib is not None and self._pool is not None:
            self._lib.pf_destroy(self._pool)
            self._pool = None
        elif self._futures is not None:
            self._executor.shutdown(wait=False)

    def __enter__(self) -> "FilePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - a safety net at collection
        try:
            self.close()
        except Exception:  # noqa: BLE001 — the interpreter may be shutting down
            pass
