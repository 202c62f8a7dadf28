"""The port's block-wise 8-bit AdamW (``train/adam8bit.py``) against the JAX
package's, on the CPU.

The JAX side is jitted, as the trainer runs it: compiled XLA multiplies by
f32(1/127) and f32(1/255) where the source divides, folds the step's two
divisions into one and fuses ``c + a·b`` into a multiply-add; the port writes
those forms. Held bit for bit: the updates, the int8 codes and the f32 scales
over 5 steps on a 700×700 and a 700 leaf (neither a multiple of the 256-element
block), unchunked and forced through chunks of 7 blocks; the port's chunked
update equals its one pass. The trainer's ``optimizer: adamw8bit`` is held to
JAX's ``build_optimizer`` under MultiSteps (grad_accum 2) on the tiny stage's
tree with the same gradients: the int8 codes equal but for a few off by one,
the parameters to 1e-6 relative and 1e-6 of a learning-rate step (the clip's
global norm sums in another order). A
checkpoint of the 8-bit state resumes exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.train import adam8bit as jadam
from vggt_qwen3_tpu.train import trainer as jtrainer
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.train import adam8bit as padam
from vggt_qwen3_tpu_torch.train import checkpoint as ckpt
from vggt_qwen3_tpu_torch.train import trainer as ptrainer
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((700, 700)) * 0.02).astype(np.float32),
            "c": (rng.standard_normal(700) * 0.02).astype(np.float32)}


def _grads(rng, like, scale):
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in like.items()}


@pytest.mark.parametrize("chunk_blocks", [padam.CHUNK_BLOCKS, 7])
def test_adamw8bit_bit_identical_to_jitted_jax(chunk_blocks):
    params = _leaves()
    jtx = jadam.adamw8bit(1e-2, weight_decay=1e-4, chunk_blocks=chunk_blocks)
    ptx = padam.adamw8bit(1e-2, weight_decay=1e-4, chunk_blocks=chunk_blocks)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    update = jax.jit(jtx.update)
    rng = np.random.default_rng(1)
    for step in range(5):
        g = _grads(rng, params, 10.0 ** -step)  # moments of mixed scales across the steps
        ju, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        pu = ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        jstate = js[0]
        assert ps["count"] == int(jstate.count) == step + 1
        for k in params:
            np.testing.assert_array_equal(pu[k].numpy(), np.asarray(ju[k]), err_msg=f"update {k}, step {step}")
            for ours, theirs in ((ps["mu"][k], jstate.mu_q[k]), (ps["nu"][k], jstate.nu_q[k])):
                assert ours["q"].dtype == torch.int8 and ours["s"].dtype == torch.float32
                np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(theirs["q"]), err_msg=k)
                np.testing.assert_array_equal(ours["s"].numpy(), np.asarray(theirs["s"]), err_msg=k)
        jp = optax.apply_updates(jp, ju)
        pp = {k: pp[k] + pu[k] for k in pp}


def test_chunked_update_equals_one_pass_bit_for_bit():
    params = _leaves(2)
    txs = {c: padam.scale_by_adam8bit(chunk_blocks=c) for c in (1 << 30, 64, 7)}
    states = {c: tx.init({k: torch.from_numpy(v) for k, v in params.items()}) for c, tx in txs.items()}
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = {k: torch.from_numpy(v) for k, v in _grads(rng, params, 1.0).items()}
        outs = {c: tx.update(g, states[c]) for c, tx in txs.items()}
        for c in (64, 7):
            for k in params:
                assert torch.equal(outs[c][k], outs[1 << 30][k]), (c, k)
                for m in ("mu", "nu"):
                    for part in ("q", "s"):
                        assert torch.equal(states[c][m][k][part], states[1 << 30][m][k][part]), (c, k, m)


def test_quantizers_bit_identical_to_jitted_jax_and_pads_dequantize_to_zero():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 301)) * 1e-3).astype(np.float32)  # 903 = 3 blocks + 135
    for jq, pq, jdq, pdq, val in (
            (jadam._quantize_signed, padam.quantize_signed, jadam._dequantize_signed, padam.dequantize_signed, x),
            (jadam._quantize_unsigned, padam.quantize_unsigned, jadam._dequantize_unsigned,
             padam.dequantize_unsigned, x * x)):
        ref = jax.jit(jq)(jnp.asarray(val))
        got = pq(torch.from_numpy(val))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
        np.testing.assert_array_equal(pdq(got, val.shape).numpy(),
                                      np.asarray(jax.jit(jdq, static_argnums=1)(ref, val.shape)))
        flat = torch.cat([pdq(got, (got["q"].numel(),))])
        assert not flat[val.size:].any()  # the pad elements of the last block
    zeros = padam.zeros(torch.zeros(903), False)
    assert (zeros["q"] == -128).all() and not padam.dequantize_unsigned(zeros, (903,)).any()


def _tiny_stages():
    model = jconfig.VLMConfig(
        text=dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"), vision=jconfig.VGGT_TINY,
        projector=jconfig.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128,
                                          dropout=0.0),
        num_vis_tokens=16, geom_tokens=2, freeze_vision=True, dtype="float32")
    jstage = jconfig.StageConfig(
        model=model, data=jconfig.DataConfig(num_views=2, image_size=56, max_length=64),
        train=jconfig.TrainConfig(optimizer="adamw8bit", lr=2e-3, proj_lr=1e-2, weight_decay=0.1, warmup_ratio=0.25,
                                  max_steps=8, grad_accum=2, gradient_clip=0.5, batch_size_per_device=2, seed=3),
        lora=jconfig.LoRAConfig(enable=True, rank=4, alpha=8), freeze_text_layers=(0,))

    def port(obj):
        if dataclasses.is_dataclass(obj):
            return getattr(pconfig, type(obj).__name__)(**{f.name: port(getattr(obj, f.name))
                                                         for f in dataclasses.fields(obj)})
        return obj

    return jstage, port(jstage)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, last = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def test_trainer_adamw8bit_matches_jax_build_optimizer_under_multisteps():
    jstage, pstage = _tiny_stages()
    jstate, jtx = jtrainer.init_train_state(jax.random.PRNGKey(0), jstage, dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    ptx = ptrainer.make_tx(pstage, params)
    pstate = ptx.init(params)
    init = {n: t.clone() for n, t in ptrainer.named_leaves(params)}
    jparams, jopt = jstate.params, jstate.opt_state
    update = jax.jit(jtx.update)
    rng = np.random.default_rng(5)
    flat_j = _flat(jax.tree.map(np.asarray, jparams))
    for step in range(4):  # two updates at grad_accum 2
        g = {n: (rng.standard_normal(v.shape) * 0.05).astype(np.float32) for n, v in flat_j.items()}
        u, jopt = update(jax.tree.map(jnp.asarray, _unflat(g)), jopt, jparams)
        jparams = optax.apply_updates(jparams, u)
        emitted = ptx.update({n: torch.from_numpy(v) for n, v in g.items()}, pstate, params)
        assert emitted == (step % 2 == 1)
    assert pstate["gradient_step"] == 2
    got, ref = dict(ptrainer.named_leaves(params)), _flat(jax.tree.map(np.asarray, jparams))
    moved = 0
    for name, p in got.items():
        if ptx.labels[name] == "frozen":
            assert torch.equal(p, init[name]) and np.array_equal(ref[name], init[name].numpy()), name
            continue
        lr = pstage.train.proj_lr if ptx.labels[name] == "proj" else pstage.train.lr
        np.testing.assert_allclose(p.numpy(), ref[name], rtol=1e-6, atol=1e-6 * lr, err_msg=name)
        moved += not torch.equal(p, init[name])
    assert moved > 10
    # the 8-bit moments: JAX's MultiSteps inner state, per group, of the trainable leaves
    inner = jopt.inner_opt_state[1].inner_states
    codes = n_codes = 0
    for group in ("base", "proj"):
        adam = inner[group].inner_state[0]
        for name, m in _flat(adam.mu_q).items():
            if name.endswith("/q") and not isinstance(m, optax.MaskedNode):
                leaf = name[:-2]
                for ours, theirs in ((pstate["mu"][leaf], m), (pstate["nu"][leaf], _flat(adam.nu_q)[name])):
                    diff = np.abs(ours["q"].numpy().astype(np.int32) - np.asarray(theirs).astype(np.int32))
                    assert diff.max() <= 1, leaf
                    codes += int((diff != 0).sum())
                    n_codes += diff.size
    assert n_codes > 0 and codes <= 1e-3 * n_codes, (codes, n_codes)


def test_adamw8bit_checkpoint_round_trip_resumes_exactly(tmp_path):
    _, pstage = _tiny_stages()
    state, tx = ptrainer.init_train_state(torch.Generator().manual_seed(0), pstage, dtype="float32")
    rng = np.random.default_rng(6)
    names = [n for n, _ in ptrainer.named_leaves(state.params)]
    grads = [{n: torch.from_numpy((rng.standard_normal(p.shape) * 0.05).astype(np.float32))
              for n, p in ptrainer.named_leaves(state.params)} for _ in range(5)]
    for g in grads[:3]:  # one update and a half-accumulated micro step
        tx.update(g, state.opt_state, state.params)
        state.step += 1
    ckpt.save(state, tmp_path / "step_3")
    restored = ckpt.restore(ckpt.latest_step_dir(tmp_path), "cpu")
    for key in ("mu", "nu"):
        for n, m in state.opt_state[key].items():
            assert restored.opt_state[key][n]["q"].dtype == torch.int8
            assert all(torch.equal(m[part], restored.opt_state[key][n][part]) for part in ("q", "s")), (key, n)
    assert all(torch.equal(state.opt_state["acc"][n], restored.opt_state["acc"][n]) for n in state.opt_state["acc"])
    assert (restored.step, restored.opt_state["gradient_step"], restored.opt_state["mini_step"]) == (3, 1, 1)
    rtx = ptrainer.make_tx(pstage, restored.params)
    for g in grads[3:]:
        tx.update(g, state.opt_state, state.params)
        rtx.update(g, restored.opt_state, restored.params)
    live, again = dict(ptrainer.named_leaves(state.params)), dict(ptrainer.named_leaves(restored.params))
    assert all(torch.equal(live[n], again[n]) for n in names)
    assert all(torch.equal(state.opt_state["mu"][n]["q"], restored.opt_state["mu"][n]["q"])
               for n in state.opt_state["mu"])


def test_unknown_optimizer_raises():
    _, pstage = _tiny_stages()
    with pytest.raises(ValueError, match="unknown train.optimizer 'sgd'"):
        ptrainer.Optimizer(dataclasses.replace(pstage.train, optimizer="sgd"), {})
