"""Shim onto the port's trainer (reference: ltx_trainer/datasets.py)."""

from mlx_video_tpu_torch.trainer.datasets import Batch, DummyDataset, PrecomputedDataset, collate_batches, iter_batches  # noqa: F401
