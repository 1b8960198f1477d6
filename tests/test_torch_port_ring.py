"""The port's ring attention (``parallel/ring_attention.py``) against JAX's
``ring_attention`` on its virtual 8-device mesh.

One spawn of 8 gloo ranks runs the rings of n = 2, 4 and 8 ranks: a
(8/n, n, 1) mesh, each ``fsdp`` line a ring of n over the token axis. JAX's
bars (atol 2e-5, rtol 1e-4, fp32). The virtual form of the collective layer
(one process, a thread a rank: what the card's smoke runs) gives the same
blocks, and the plain statistics and merge equal JAX's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.parallel import ring_attention as jra
from mlx_video_tpu_torch.parallel import collectives as tcol
from mlx_video_tpu_torch.parallel import ring_attention as tra
from test_torch_port_parallel import AXES, jax_mesh, run_ranks

B, S, H, D = 2, 64, 2, 16
RINGS = (2, 4, 8)

_RINGS = r'''
from mlx_video_tpu_torch.parallel import collectives, mesh as tmesh
from mlx_video_tpu_torch.parallel.ring_attention import ring_attention
q, k, v = (torch.from_numpy(inputs[name]) for name in "qkv")
for n in (2, 4, 8):
    mg = collectives.mesh_groups(tmesh.create_mesh((8 // n, n, 1), "cpu"))
    ring = mg.group("fsdp")
    i, step = ring.rank, q.shape[1] // n
    blk = lambda t: t[:, i * step:(i + 1) * step].contiguous()
    out[n] = (i, ring_attention(blk(q), blk(k), blk(v), ring, seq_len=q.shape[1]).numpy())
'''


def _qkv(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=(B, S, H, D)).astype(np.float32) for name in "qkv"}


@pytest.fixture(scope="module")
def qkv():
    return _qkv()


@pytest.fixture(scope="module")
def gloo_rings(qkv, tmp_path_factory):
    return run_ranks(_RINGS, 8, tmp_path_factory.mktemp("rings"), qkv)


def _jax_ring(qkv, n: int) -> np.ndarray:
    mesh = jax_mesh((1, n, 1))
    with mesh:
        return np.asarray(jra.ring_attention(*(jnp.asarray(qkv[c]) for c in "qkv"), mesh, axis="fsdp"))


@pytest.mark.parametrize("n", RINGS)
def test_ring_over_gloo_matches_jax(qkv, gloo_rings, n):
    """Every rank's block of the ring's output is JAX's ring output's block,
    on all 8/n rings of the mesh."""
    ref = _jax_ring(qkv, n)
    step = S // n
    seen = set()
    for out in gloo_rings:
        i, block = out[n]
        seen.add(i)
        np.testing.assert_allclose(block, ref[:, i * step:(i + 1) * step], atol=2e-5, rtol=1e-4)
    assert seen == set(range(n))


@pytest.mark.parametrize("n", RINGS)
def test_virtual_ring_gives_the_gloo_ring(qkv, gloo_rings, n):
    """The collective layer's in-process form (threads taking turns) runs
    the same ring: each block equals the gloo rank's."""
    q, k, v = (torch.from_numpy(qkv[c]) for c in "qkv")
    step = S // n

    def body(mg):
        i = mg.index("fsdp")
        blk = lambda t: t[:, i * step:(i + 1) * step].contiguous()  # noqa: E731
        return i, tra.ring_attention(blk(q), blk(k), blk(v), mg.group("fsdp"), seq_len=S)

    virtual = dict(tcol.run_virtual(tcol.virtual_meshes((1, n, 1), AXES, "cpu"), body))
    for out in gloo_rings:
        i, block = out[n]
        np.testing.assert_array_equal(virtual[i].numpy(), block)


def test_indivisible_sequence_raises(qkv):
    g = tcol.virtual_meshes((1, 8, 1), AXES, "cpu")[0].group("fsdp")
    q = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="Sequence length 12 not divisible by mesh axis fsdp=8"):
        tra.ring_attention(q, q, q, g, seq_len=12)
    mesh = jax_mesh((1, 8, 1))
    with pytest.raises(ValueError, match="Sequence length 12 not divisible by mesh axis fsdp=8"):
        with mesh:
            jra.ring_attention(*(jnp.zeros((1, 12, 2, 16)),) * 3, mesh, axis="fsdp")


def test_plain_statistics_and_merge_match_jax(qkv):
    """The local step's (acc, m, l) and the online-softmax merge equal JAX's
    functions (fp32)."""
    q, k, v = (qkv[c][:, :16] for c in "qkv")
    k2, v2 = (qkv[c][:, 16:32] for c in "kv")
    scale = D ** -0.5
    got_a = tra._local_attention_stats(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    got_b = tra._local_attention_stats(*(torch.from_numpy(t) for t in (q, k2, v2)), scale)
    ref_a = jra._local_attention_stats(*(jnp.asarray(t) for t in (q, k, v)), scale)
    ref_b = jra._local_attention_stats(*(jnp.asarray(t) for t in (q, k2, v2)), scale)
    for g, r in zip(got_a, ref_a):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)
    got = tra._combine(got_a[1], got_a[2], got_a[0], got_b[1], got_b[2], got_b[0])
    ref = jra._combine(ref_a[1], ref_a[2], ref_a[0], ref_b[1], ref_b[2], ref_b[0])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)


def test_flash_partials_merge_as_the_plain_statistics(qkv):
    """K1's (normalized output, lse, 1) form of the partials, taken on CPU
    tensors through the kernel's plain version, gives the plain ring's
    result: the card's local step is exchangeable with the CPU's."""
    q, k, v = (torch.from_numpy(qkv[c]) for c in "qkv")
    n, step = 4, S // 4

    def ring(stats):
        def body(mg):
            i = mg.index("fsdp")
            blk = lambda t: t[:, i * step:(i + 1) * step].contiguous()  # noqa: E731
            return tra.ring_attention(blk(q), blk(k), blk(v), mg.group("fsdp"), local_stats=stats)

        return tcol.run_virtual(tcol.virtual_meshes((1, n, 1), AXES, "cpu"), body)

    plain, flash = ring(None), ring(tra._local_stats_flash)
    for a, b in zip(plain, flash):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5, rtol=1e-4)
