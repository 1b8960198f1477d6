"""The memory plan's codec and copies on the card (io/staging.py).

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_staging_card.py

Bars, each with its reason:
- the codes and scales a tensor on the card gets equal the CPU's: the same
  fp32 operations (a correctly rounded quotient by a tensor 127, round half
  to even);
- an unpark whose copies run on the side stream while a long matmul holds
  the current stream gives the tensors of a synchronous unpark, bit for bit:
  the current stream waits on the copies' event before it dequantizes, and
  the copies are recorded as used by it;
- a module parked on the host leaves no byte of its tensors allocated on the
  card, and its host payloads are pinned (the copies back are asynchronous).
"""

import gc

import pytest
import torch

from mlx_video_tpu_torch.io import staging
from mlx_video_tpu_torch.models.ltx.video_vae.decoder import DecoderConfig, init_video_decoder

CONFIG = DecoderConfig(in_channels=128, base_channels=128, num_layers_per_block=2)  # 3x3x3x128x128 convs: quantized


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's codes and the side-stream copies")
    return torch.device("cuda", torch.cuda.current_device())


def _decoder(device, dtype=torch.bfloat16):
    return init_video_decoder(torch.Generator().manual_seed(3), CONFIG, device="cpu").to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("park_on", ["cpu", "cuda"])
def test_card_codes_equal_cpu_codes(card, park_on):
    """Quantized on the card (its codes then on the host, or left on the
    card) against quantized on the CPU."""
    on_cpu = staging.park_int8(_decoder("cpu"), "cpu")
    on_card = staging.park_int8(_decoder(card), park_on)
    assert staging.is_parked(on_card) and on_card.devices() == {card if park_on == "cuda" else torch.device("cpu")}
    a, b = on_cpu._payload_tensors(), on_card._payload_tensors()
    assert len(a) == len(b) and all(torch.equal(x, y.cpu()) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
def test_overlapped_unpark_equals_a_synchronous_one(card, int8):
    parked = staging.park(_decoder(card), "cpu", quantize=int8)
    ref = staging.unpark_int8(parked, card)
    torch.cuda.synchronize()
    x = torch.randn(8192, 8192, device=card, dtype=torch.bfloat16)
    for _ in range(20):  # the current stream is busy for a while
        x = (x @ x).clamp_(-1, 1)
    module = staging.unpark_finish(staging.unpark_begin(parked, card))
    for _ in range(5):
        x = (x @ x).clamp_(-1, 1)
    got, want = module.state_dict(), ref.state_dict()
    torch.cuda.synchronize()
    assert set(got) == set(want)
    assert all(got[k].device == card and got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in got)


@pytest.mark.cuda
def test_a_parked_module_leaves_nothing_on_the_card(card):
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    decoder = _decoder(card)
    held = torch.cuda.memory_allocated(card) - before
    parked = staging.park_int8(decoder, "cpu")
    del decoder
    gc.collect()
    torch.cuda.synchronize()
    assert held > 0 and torch.cuda.memory_allocated(card) == before
    assert parked.devices() == {torch.device("cpu")}
    assert all(t.is_pinned() for t in parked._payload_tensors())
    assert parked.nbytes() < held  # int8 codes and fp32 scales against bf16
