"""The port's ring attention (``ops/ring_attention.py``) and VGGT's ring hook
against the JAX package's 8-device ring.

Eight gloo ranks, each a process of its own that imports no JAX
(``tests/torch_ring_ranks.py``, a file store in a temporary directory, no
address), run the port; the JAX side runs ``ring_attention_sharded`` over
the 8 forced host devices of ``tests/conftest.py`` with its Pallas flash
kernel in interpret mode. Both get the same numpy-seeded float32 inputs and
the same weights (``utils.from_jax``). Tolerances:

- the ring forward at ``[1, 32·64, 4/2, 32]``: within 2e-5 (absolute and
  relative) of JAX's ring, and of the port's direct flash forward;
- the gradients dq/dk/dv of ``sum(tanh(o)·w)`` at ``[1, 8·16, 2, 16]``, each
  rank's shards concatenated: atol 3e-5, rtol 1e-4 against ``jax.grad``
  through JAX's ring (and against the port's direct flash backward);
- the aggregator with ``ring_group`` (8 views of 28², 64 global tokens over
  the 8 ranks) against JAX's ``aggregator(ring_mesh=...)`` and the port's
  aggregator without a ring: within 3e-5;
- a 1-rank group (in this process, gloo on an in-process store): the ring
  equals the direct flash forward bit for bit;
- ``return_all_layers``: every pair's output within 3e-5 of JAX's;
- ``vlm.encode_images`` with a 1-rank ``ring_group`` equals it without, bit
  for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.models import vggt as jvggt
from vggt_qwen3_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.models import vggt as pvggt
from vggt_qwen3_tpu_torch.ops import flash_attention as pflash
from vggt_qwen3_tpu_torch.ops import ring_attention as pring
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

REPO = Path(__file__).resolve().parents[1]
RANKS = 8
AGG_CFG = dict(img_size=28, patch_size=14, embed_dim=32, num_layers=2, num_heads=2, num_register_tokens=3,
               patch_depth=1, dtype="float32")


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:RANKS]), ("sp",))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 8 ranks once on the inputs of every check → (inputs, [each rank's results])."""
    d = tmp_path_factory.mktemp("ring")
    fwd = dict(q=rand((1, 32 * 64, 4, 32), 10), k=rand((1, 32 * 64, 2, 32), 11), v=rand((1, 32 * 64, 2, 32), 12))
    grad = dict(q=rand((1, 8 * 16, 2, 16), 20), k=rand((1, 8 * 16, 2, 16), 21), v=rand((1, 8 * 16, 2, 16), 22),
                w=rand((1, 8 * 16, 2, 16), 23))
    jcfg = jconfig.VGGTConfig(**AGG_CFG)
    jp = jvggt.init_params(jax.random.PRNGKey(0), jcfg, dtype="float32")
    images = rand((1, 8, 3, 28, 28), 30) * 0.1 + 0.5
    inputs = dict(fwd=fwd, grad=grad, jp=jp, jcfg=jcfg, images=images)
    torch.save(dict(**{n: _t(x) for n, x in fwd.items()}, grad={n: _t(x) for n, x in grad.items()},
                    agg_cfg=AGG_CFG, agg_params=params_from_jax(jax.tree.map(np.asarray, jp)), images=_t(images)),
               d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")  # the ranks talk over loopback only
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_ring_ranks.py"), str(r), str(RANKS),
                               str(d)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    return inputs, [torch.load(d / f"rank{r}.pt") for r in range(RANKS)]


def test_ring_forward_matches_jax_ring_and_the_direct_forward(ranks):
    inputs, res = ranks
    f = inputs["fwd"]
    ref = np.asarray(jax_ring(*(jnp.asarray(f[n]) for n in "qkv"), _mesh(), axis_name="sp", interpret=True))
    direct = pflash.flash_attention(*(_t(f[n]) for n in "qkv")).numpy()
    for r in res:  # every rank holds the gathered output
        np.testing.assert_allclose(r["ring"].numpy(), ref, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(r["ring"].numpy(), direct, atol=2e-5, rtol=2e-5)


def test_ring_gradients_match_jax_grad_through_its_ring(ranks):
    inputs, res = ranks
    g = inputs["grad"]
    mesh = _mesh()
    w = jnp.asarray(g["w"])

    def loss(q, k, v):
        return jnp.sum(jnp.tanh(jax_ring(q, k, v, mesh, axis_name="sp", interpret=True)) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(g[n]) for n in "qkv"))
    q, k, v = (_t(g[n]).requires_grad_(True) for n in "qkv")
    (torch.tanh(pflash.flash_attention(q, k, v)) * _t(g["w"])).sum().backward()
    for name, jr, direct in zip(("dq", "dk", "dv"), ref, (q.grad, k.grad, v.grad)):
        got = torch.cat([r[name] for r in res], dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(jr), atol=3e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got, direct.numpy(), atol=3e-5, rtol=1e-4, err_msg=name)


def test_ring_aggregator_matches_jax_ring_aggregator_and_the_plain_one(ranks):
    inputs, res = ranks
    jp, jcfg, images = inputs["jp"], inputs["jcfg"], inputs["images"]
    ref, psi = jvggt.aggregator(jp, jcfg, jnp.asarray(images), ring_mesh=_mesh(), ring_axis="sp")
    plain, ppsi = pvggt.aggregator(params_from_jax(jax.tree.map(np.asarray, jp)), pconfig.VGGTConfig(**AGG_CFG),
                                   _t(images))
    assert psi == ppsi == jcfg.patch_start_idx
    for r in res:
        np.testing.assert_allclose(r["agg"].numpy(), np.asarray(ref[-1]), atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(r["agg"].numpy(), plain[-1].numpy(), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_ring_is_the_direct_forward_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g).to(dtype)
    k = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
    with pring.single_rank_group("cpu") as group:
        ring = pring.ring_attention(q, k, v, group=group)
        sharded = pring.ring_attention_sharded(q, k, v, group=group)
    direct = pflash.flash_attention(q, k, v)
    assert torch.equal(ring, direct) and torch.equal(sharded, direct)
    assert not torch.distributed.is_initialized()  # the group made for the call is gone


def test_ring_sharded_refuses_gradients_and_ragged_lengths(monkeypatch):
    """Gradients now flow through ``ring_attention_sharded`` (the several-rank
    case is held to JAX in ``tests/test_torch_parallel.py``): over one rank,
    with and without ``rows_sharded``, they are the direct flash backward's
    bit for bit. Ragged lengths are still refused before any communication."""
    g = torch.Generator().manual_seed(1)
    q, k, v, w = (torch.randn(2, 6, 2, 16, generator=g) for _ in range(4))
    direct = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (pflash.flash_attention(*direct) * w).sum().backward()
    with pring.single_rank_group("cpu") as group:
        for rows_sharded in (False, True):
            ring = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (pring.ring_attention_sharded(*ring, group=group, rows_sharded=rows_sharded) * w).sum().backward()
            assert all(torch.equal(a.grad, b.grad) for a, b in zip(ring, direct))
        monkeypatch.setattr(pring.dist, "get_world_size", lambda group=None: 4)
        with pytest.raises(ValueError, match="must divide"):
            pring.ring_attention_sharded(q, q, q, group=group)


def test_aggregator_return_all_layers_matches_jax():
    jcfg = jconfig.VGGTConfig(**AGG_CFG)
    jp = jvggt.init_params(jax.random.PRNGKey(3), jcfg, dtype="float32")
    images = rand((2, 3, 3, 28, 28), 31) * 0.2 + 0.4
    ref, psi = jvggt.aggregator(jp, jcfg, jnp.asarray(images), return_all_layers=True)
    got, ppsi = pvggt.aggregator(params_from_jax(jax.tree.map(np.asarray, jp)), pconfig.VGGTConfig(**AGG_CFG),
                                 _t(images), return_all_layers=True)
    last, _ = pvggt.aggregator(params_from_jax(jax.tree.map(np.asarray, jp)), pconfig.VGGTConfig(**AGG_CFG),
                               _t(images))
    assert psi == ppsi and len(got) == len(ref) == jcfg.num_layers and len(last) == 1
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, rtol=3e-5)
    assert torch.equal(last[-1], got[-1])


def test_encode_images_with_a_one_rank_ring_group_equals_without():
    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.models import vlm as pvlm

    args = bench.parse_args(["--mode", "e2e", "--tiny", "--device", "cpu"])
    cfg = bench.vlm_config(args)
    params = bench.vlm_params(args, cfg)
    images = _t(rand((2, 3, 3, 56, 56), 32) * 0.2 + 0.4)
    plain = pvlm.encode_images(params, cfg, images)
    with pring.single_rank_group("cpu") as group:
        ring = pvlm.encode_images(params, cfg, images, ring_group=group)
    assert plain.shape == (2, cfg.num_vis_tokens, cfg.text.hidden_size) and torch.equal(ring, plain)
