"""The device fence of the single-device memory plan.

Counterpart of mlx_video_tpu/utils/device.py:drain_device_queue. PyTorch on
CUDA enqueues work on a stream and the caching allocator reuses a freed
block only once the work that used it has been ordered before the reuse, so
the hazard the JAX function guards against (frees that retire late on a
remote accelerator) does not arise here; the fence is kept so that the
memory a request leaves behind has settled before the next one starts, and
so that host clocks read after it include the device's work.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def drain_device_queue(device: Optional[Union[str, torch.device]] = None) -> None:
    """Wait until every stream of ``device`` (default: the current CUDA
    device) has finished its work: ``torch.cuda.synchronize``. A no-op on
    the CPU, where every operation has finished when it returns."""
    if device is None:
        if not torch.cuda.is_available():
            return
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
