"""Streaming safetensors reader and writer over torch tensors.

Counterpart of mlx_video_tpu/io/safetensors.py, without numpy's ml_dtypes:
bf16 and fp8 are native torch dtypes. The file layout and the writer's bytes
are the JAX package's (same header order and padding), so files read both
ways.

- BF16 reads as ``torch.bfloat16`` (its 16-bit words, viewed), F8_E4M3 and
  F8_E5M2 as ``torch.float8_e4m3fn`` / ``torch.float8_e5m2``.
- U32 reads as the ``torch.int32`` tensor with the same bits (the port's
  packed quantized words, ops/quant.py); :meth:`SafetensorsReader.dtype_name`
  still says "U32". Pass ``t.view(torch.uint32)`` to the writer to store U32.

The reader maps the file once and copies one tensor at a time out of the map,
straight to its target device, so a multi-GB checkpoint is never held twice
in host memory.
"""

from __future__ import annotations

import json
import mmap
import struct
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.int32,  # same bits; the writer takes torch.uint32 for U32
    "U64": torch.uint64,
    "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items() if k != "U32"}
_DTYPE_NAMES[torch.uint32] = "U32"


def _read_header(f) -> Tuple[dict, int]:
    header_len = struct.unpack("<Q", f.read(8))[0]
    return json.loads(f.read(header_len)), 8 + header_len


def _from_bytes(buf, meta: dict, offset: int = 0) -> torch.Tensor:
    """A tensor viewing ``buf`` (no copy) at one header entry."""
    start, end = meta["data_offsets"]
    if end == start:
        return torch.empty(meta["shape"], dtype=_DTYPES[meta["dtype"]])
    raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - start, offset=offset + start)
    return raw.view(_DTYPES[meta["dtype"]]).reshape(meta["shape"])


class SafetensorsReader:
    """Lazy mmap-backed reader for one .safetensors file."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            header, self._data_base = _read_header(f)
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._entries: Dict[str, dict] = header
        self._file = open(self.path, "rb")
        # a private (copy-on-write) map is writable, so torch can view it
        # without a warning; nothing writes to it, so no page is copied
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self) -> List[str]:
        return list(self._entries.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self._entries[key]["shape"])

    def dtype(self, key: str) -> torch.dtype:
        """The torch dtype :meth:`get` returns (int32 for U32)."""
        return _DTYPES[self._entries[key]["dtype"]]

    def dtype_name(self, key: str) -> str:
        """The dtype as the file names it ("BF16", "U32", ...)."""
        return self._entries[key]["dtype"]

    def get(self, key: str, device=None) -> torch.Tensor:
        """Materialize one tensor on ``device`` (default CPU), copied once out
        of the map."""
        view = _from_bytes(self._mm, self._entries[key], self._data_base)
        if device is None or torch.device(device).type == "cpu":
            return view.clone()
        return view.to(device)

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_safetensors_bytes(data) -> Dict[str, torch.Tensor]:
    """Parse a whole safetensors payload already in memory into name ->
    tensor. Tensors are views into ``data`` (read-only when ``data`` is
    ``bytes``): copy them if the buffer's lifetime is shorter."""
    header_len = struct.unpack("<Q", bytes(data[:8]))[0]
    header = json.loads(bytes(data[8 : 8 + header_len]))
    header.pop("__metadata__", None)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return {key: _from_bytes(data, meta, 8 + header_len) for key, meta in header.items()}


def scan_keys(paths: Sequence[Union[str, Path]]) -> set:
    """Union of tensor keys across files, read from the headers alone;
    unreadable files are skipped."""
    keys: set = set()
    for p in paths:
        try:
            with open(p, "rb") as f:
                header, _ = _read_header(f)
            keys.update(k for k in header if k != "__metadata__")
        except Exception:
            continue
    return keys


def read_metadata(path: Union[str, Path]) -> Dict[str, str]:
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return header.get("__metadata__", {}) or {}


def save_safetensors(
    path: Union[str, Path],
    tensors: Dict[str, torch.Tensor],
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write a .safetensors file, byte for byte as the JAX package's writer
    does. Tensors may live on any device; each is copied to the host alone."""
    entries = {}
    offset = 0
    for k, t in tensors.items():
        dt_name = _DTYPE_NAMES.get(t.dtype)
        if dt_name is None:
            raise ValueError(f"Unsupported dtype for safetensors: {t.dtype} ({k})")
        nbytes = t.numel() * t.element_size()
        entries[k] = {"dtype": dt_name, "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header: dict = dict(entries)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    header_bytes = json.dumps(header).encode("utf-8")
    header_bytes += b" " * ((8 - len(header_bytes) % 8) % 8)  # 8-byte alignment
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
