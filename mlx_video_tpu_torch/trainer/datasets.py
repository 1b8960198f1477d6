"""Training datasets over precomputed latents.

Counterpart of mlx_video_tpu/trainer/datasets.py: the directory layout
{latents, conditions, audio_latents, reference_latents} of per-clip
.safetensors / .npz files (under ``.precomputed`` when the root has one),
legacy ``latent_*`` / ``condition_*`` naming, patchified-latent layout
normalization, same-shape batching and the shuffled batch iterator, with the
same batch order for the same seed. Samples are host numpy arrays; the
strategies move them to the device. Safetensors files are read through the
port's reader, or, while ``iter_batches`` prefetches, parsed from the bytes
that io/prefetch.py's pool read ahead on its threads.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, parse_safetensors_bytes

PRECOMPUTED_DIR_NAME = ".precomputed"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _load_any(path: Path, raw: Optional[bytes] = None) -> Dict[str, Any]:
    """One sample file's arrays, from the file or from ``raw``, its bytes
    already read."""
    if path.suffix == ".npz":
        with np.load(path if raw is None else io.BytesIO(raw)) as data:  # arrays only: no pickled objects
            return {k: data[k] for k in data.files}
    if path.suffix == ".safetensors":
        if raw is not None:  # copies: the arrays must not view the fetched buffer
            return {k: np.array(_to_numpy(t)) for k, t in parse_safetensors_bytes(raw).items()}
        with SafetensorsReader(path) as r:
            return {k: _to_numpy(r.get(k)) for k in r.keys()}
    raise ValueError(f"Unsupported file type: {path}")


@dataclass
class Batch:
    latents: Dict[str, Any]
    conditions: Dict[str, Any]
    audio_latents: Optional[Dict[str, Any]] = None
    ref_latents: Optional[Dict[str, Any]] = None


class DummyDataset:
    """Random latents/embeddings with correct shapes, sample ``i`` drawn
    from numpy seed ``i`` (the JAX package's samples, value for value)."""

    def __init__(
        self,
        width: int = 832,
        height: int = 480,
        num_frames: int = 33,
        fps: int = 24,
        dataset_length: int = 200,
        latent_dim: int = 128,
        latent_spatial_compression_ratio: int = 32,
        latent_temporal_compression_ratio: int = 8,
        prompt_embed_dim: int = 3840,
        prompt_sequence_length: int = 1024,
        with_audio: bool = False,
        audio_channels: int = 8,
        audio_bins: int = 16,
        audio_frames: int = 69,
        with_reference: bool = False,
        seed: int = 0,
    ) -> None:
        if width % 32 != 0 or height % 32 != 0:
            raise ValueError("Width/height must be divisible by 32")
        if num_frames % 8 != 1:
            raise ValueError("num_frames must be 1 + 8*k")
        self.dataset_length = dataset_length
        self.latent_dim = latent_dim
        self.num_latent_frames = (num_frames - 1) // latent_temporal_compression_ratio + 1
        self.latent_height = height // latent_spatial_compression_ratio
        self.latent_width = width // latent_spatial_compression_ratio
        self.prompt_embed_dim = prompt_embed_dim
        self.prompt_sequence_length = prompt_sequence_length
        self.with_audio = with_audio
        self.audio_channels = audio_channels
        self.audio_bins = audio_bins
        self.audio_frames = audio_frames
        self.with_reference = with_reference
        self.fps = fps

    def __len__(self) -> int:
        return self.dataset_length

    def __getitem__(self, idx: int) -> Batch:
        rng = np.random.default_rng(idx)
        latents = {
            "latents": rng.standard_normal(
                (self.latent_dim, self.num_latent_frames, self.latent_height, self.latent_width)
            ).astype(np.float32),
            "num_frames": np.array([self.num_latent_frames], dtype=np.int32),
            "height": np.array([self.latent_height], dtype=np.int32),
            "width": np.array([self.latent_width], dtype=np.int32),
            "fps": np.array([self.fps], dtype=np.float32),
        }
        conditions = {
            "video_prompt_embeds": rng.standard_normal(
                (self.prompt_sequence_length, self.prompt_embed_dim)
            ).astype(np.float32),
            "audio_prompt_embeds": rng.standard_normal(
                (self.prompt_sequence_length, self.prompt_embed_dim)
            ).astype(np.float32),
            "prompt_attention_mask": np.ones(self.prompt_sequence_length, dtype=bool),
        }
        audio_latents = None
        if self.with_audio:
            audio_latents = {
                "latents": rng.standard_normal(
                    (self.audio_channels, self.audio_frames, self.audio_bins)
                ).astype(np.float32),
                "num_time_steps": np.array([self.audio_frames], dtype=np.int32),
                "frequency_bins": np.array([self.audio_bins], dtype=np.int32),
            }
        ref_latents = None
        if self.with_reference:
            ref_latents = dict(latents)
            ref_latents["latents"] = rng.standard_normal(latents["latents"].shape).astype(np.float32)
        return Batch(
            latents=latents, conditions=conditions, audio_latents=audio_latents, ref_latents=ref_latents
        )


class PrecomputedDataset:
    """Per-clip precomputed tensors in parallel source dirs."""

    def __init__(
        self,
        data_root: Union[str, Path],
        data_sources: Union[Dict[str, str], List[str], None] = None,
    ) -> None:
        root = Path(data_root).expanduser().resolve()
        if not root.exists():
            raise FileNotFoundError(f"Data root does not exist: {root}")
        if (root / PRECOMPUTED_DIR_NAME).exists():
            root = root / PRECOMPUTED_DIR_NAME
        self.data_root = root

        if data_sources is None:
            data_sources = {"latents": "latents", "conditions": "conditions"}
        elif isinstance(data_sources, list):
            data_sources = {name: name for name in data_sources}
        self.data_sources: Dict[str, str] = dict(data_sources)

        self.source_paths = {}
        for dir_name in self.data_sources:
            p = self.data_root / dir_name
            if not p.exists():
                raise FileNotFoundError(f"Missing data source dir: {p}")
            self.source_paths[dir_name] = p

        self.sample_files = self._discover_samples()
        if not self.sample_files or not next(iter(self.sample_files.values())):
            raise ValueError("No valid samples found")
        counts = {k: len(v) for k, v in self.sample_files.items()}
        if len(set(counts.values())) > 1:
            raise ValueError(f"Mismatched sample counts: {counts}")
        self._shape_cache: Dict[int, Tuple[int, ...]] = {}

    def _data_key(self) -> str:
        return "latents" if "latents" in self.data_sources else next(iter(self.data_sources))

    def _expected_path(self, dir_name: str, data_file: Path, rel: Path) -> Path:
        source = self.source_paths[dir_name]
        # legacy naming: latent_XXX.safetensors <-> condition_XXX.safetensors
        if dir_name == "conditions" and data_file.name.startswith("latent_"):
            return source / f"condition_{data_file.stem[7:]}{data_file.suffix}"
        return source / rel

    def _discover_samples(self) -> Dict[str, List[Path]]:
        data_path = self.source_paths[self._data_key()]
        data_files = sorted(p for p in data_path.glob("**/*") if p.suffix in (".npz", ".safetensors"))
        sample_files: Dict[str, List[Path]] = {v: [] for v in self.data_sources.values()}
        for data_file in data_files:
            rel = data_file.relative_to(data_path)
            if all(self._expected_path(d, data_file, rel).exists() for d in self.data_sources):
                for dir_name, out_key in self.data_sources.items():
                    expected = self._expected_path(dir_name, data_file, rel)
                    sample_files[out_key].append(expected.relative_to(self.source_paths[dir_name]))
        return sample_files

    def __len__(self) -> int:
        return len(next(iter(self.sample_files.values())))

    # the background reader (io/prefetch.py:FilePrefetcher) while iter_batches prefetches
    _fetcher = None

    def sample_paths(self, index: int) -> List[Path]:
        """The files of one sample, one a data source."""
        return [self.source_paths[dir_name] / self.sample_files[out_key][index]
                for dir_name, out_key in self.data_sources.items()]

    def latent_shape(self, index: int) -> Tuple[int, ...]:
        """The (C, F, H, W) latent shape of one sample, from the safetensors
        header where it can; cached (batching asks for every sample's)."""
        if index not in self._shape_cache:
            self._shape_cache[index] = self._latent_shape_uncached(index)
        return self._shape_cache[index]

    def _latent_shape_uncached(self, index: int) -> Tuple[int, ...]:
        data_key = self._data_key()
        path = self.source_paths[data_key] / self.sample_files[self.data_sources[data_key]][index]
        if path.suffix == ".safetensors":
            with SafetensorsReader(path) as r:
                key = "latents" if "latents" in r else r.keys()[0]
                shape = r.shape(key)
                if len(shape) != 2:
                    return shape
                # legacy patchified (S, C): the normalized (C, F, H, W)
                s_len, c = shape
                f, h, w = (int(_to_numpy(r.get(k)).reshape(-1)[0]) for k in ("num_frames", "height", "width"))
                return (c, f, h, w)
        data = _load_any(path)
        latents = np.asarray(data.get("latents", next(iter(data.values()))))
        if latents.ndim == 2 and "num_frames" in data:
            return tuple(np.asarray(normalize_video_latents(dict(data))["latents"]).shape)
        return tuple(latents.shape)

    def __getitem__(self, index: int) -> Batch:
        result: Dict[str, Dict[str, Any]] = {}
        for dir_name, out_key in self.data_sources.items():
            path = self.source_paths[dir_name] / self.sample_files[out_key][index]
            result[out_key] = _load_any(path, raw=None if self._fetcher is None else self._fetcher.get(path))
        latents = result.get("latents")
        if latents is not None:
            latents = normalize_video_latents(latents)
        return Batch(
            latents=latents,
            conditions=result.get("conditions") or result.get("text_conditions") or {},
            audio_latents=result.get("audio_latents"),
            ref_latents=result.get("ref_latents") or result.get("reference_latents"),
        )


def normalize_video_latents(data: Dict[str, Any]) -> Dict[str, Any]:
    """Legacy patchified [S, C] layout -> [C, F, H, W]."""
    latents = np.asarray(data.get("latents"))
    if latents.ndim == 2:
        f = int(np.asarray(data["num_frames"]).reshape(-1)[0])
        h = int(np.asarray(data["height"]).reshape(-1)[0])
        w = int(np.asarray(data["width"]).reshape(-1)[0])
        latents = latents.reshape(f, h, w, latents.shape[-1])
        data = dict(data)
        data["latents"] = np.transpose(latents, (3, 0, 1, 2))
    return data


def collate_batches(batches: List[Batch]) -> Batch:
    def stack(dicts: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = {}
        for k in dicts[0]:
            vals = [d[k] for d in dicts]
            out[k] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) else np.array(vals)
        return out

    return Batch(
        latents=stack([b.latents for b in batches]),
        conditions=stack([b.conditions for b in batches]),
        audio_latents=stack([b.audio_latents for b in batches]) if batches[0].audio_latents is not None else None,
        ref_latents=stack([b.ref_latents for b in batches]) if batches[0].ref_latents is not None else None,
    )


def _batch_index_groups(dataset, batch_size: int, shuffle: bool, seed: int) -> List[List[int]]:
    """Deterministic per-epoch batch index groups (the JAX package's order):
    same-shape buckets when the dataset exposes ``latent_shape``, each
    bucket's tail batch padded by wrapping its own members."""
    idxs = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idxs)
    if batch_size > 1 and hasattr(dataset, "latent_shape"):
        buckets: dict = {}
        for i in idxs:
            buckets.setdefault(dataset.latent_shape(int(i)), []).append(int(i))
        batches = [
            [members[(j + k) % len(members)] for k in range(batch_size)]
            for members in buckets.values()
            for j in range(0, len(members), batch_size)
        ]
        if shuffle:
            np.random.default_rng(seed + 1).shuffle(batches)
    else:
        n = len(dataset)
        batches = [[int(idxs[(i + k) % n]) for k in range(batch_size)] for i in range(0, n, batch_size)]
    return batches


def num_batches_per_epoch(dataset, batch_size: int) -> int:
    """Batches one epoch yields; the same in every epoch."""
    return len(_batch_index_groups(dataset, batch_size, shuffle=False, seed=0))


def iter_batches(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
    prefetch_threads: int = 4,
    skip: int = 0,
    part: Tuple[int, int] = (0, 1),
) -> Iterator[Batch]:
    """One epoch of collated batches; ``skip`` drops the first batches by
    index alone (no file reads), for an exact resume. On a dataset with
    ``sample_paths`` (PrecomputedDataset) the files of the current batch and
    the next ``prefetch`` ones are read on ``prefetch_threads`` background
    threads (io/prefetch.py), so the reads overlap the training step; the
    batches are the same bytes either way. ``part`` = (i, n): each batch's
    i-th of n equal parts alone (a data rank's share of a sharded step;
    ``batch_size`` must divide by n), read and prefetched by this process."""
    i, n = part
    if batch_size % n:
        raise ValueError(f"batch_size={batch_size} does not divide into {n} parts")
    per = batch_size // n
    batches = [chunk[i * per:(i + 1) * per]
               for chunk in _batch_index_groups(dataset, batch_size, shuffle, seed)[skip:]]
    if prefetch > 0 and hasattr(dataset, "sample_paths"):
        from mlx_video_tpu_torch.io.prefetch import FilePrefetcher

        with FilePrefetcher(prefetch_threads) as fetcher:
            dataset._fetcher = fetcher
            try:
                for bi, chunk in enumerate(batches):
                    for ahead in batches[bi : bi + 1 + prefetch]:
                        for idx in ahead:
                            for path in dataset.sample_paths(idx):
                                fetcher.submit(path)
                    yield collate_batches([dataset[j] for j in chunk])
            finally:
                dataset._fetcher = None
        return
    for chunk in batches:
        yield collate_batches([dataset[j] for j in chunk])
