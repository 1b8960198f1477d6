"""GELU(tanh) helper (reference: ltx_core/model/transformer/gelu_approx.py,
a compatibility stub; the engine FFN uses the tanh approximation)."""

import torch.nn.functional as F


def gelu_approx(x):
    return F.gelu(x, approximate="tanh")


__all__ = ["gelu_approx"]
