"""Text-only generation with prompt penalisation in the port
(``engine.generate_text``, ``penalize_prompt`` in ``generate``,
``generate_early_exit`` and ``generate_speculative``).

The oracle independent of JAX is HF's ``generate`` on a randomly initialised
``Qwen3ForCausalLM`` built from a local config (no download), converted by
the port's ``convert_qwen3.convert_state_dict``: with the prompt penalised
(repetition penalty over the prompt and the generated ids, no-repeat-n-gram
over both) the tokens are HF's, float32 throughout. HF pads nothing here:
with a left-padded batch HF would penalise the pads too, and the JAX module
does something else again, which the port copies (its penalty set is
``ids[:, :valid count]``: the pads and a prefix of the prompt, with the
generated tokens written over the prompt's tail): that case is held to JAX's
``generate_text``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import Qwen3Config as HFQwen3Config
from transformers.models.qwen3.modeling_qwen3 import Qwen3ForCausalLM

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu_torch.inference import engine as pengine
from vggt_qwen3_tpu_torch.inference import speculative as pspec
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.models.convert_qwen3 import config_from_hf, convert_state_dict
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

from tests.test_torch_models import jax_flash_prefill, port_cfg, to_np  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def hf_pair():
    hf_cfg = HFQwen3Config(
        vocab_size=256, hidden_size=96, num_hidden_layers=3, num_attention_heads=6, num_key_value_heads=3,
        head_dim=16, intermediate_size=192, rope_theta=10_000.0, tie_word_embeddings=False,
        max_position_embeddings=2048, attn_implementation="eager",
    )
    torch.manual_seed(12)
    hf_model = Qwen3ForCausalLM(hf_cfg).eval().to(torch.float32)
    cfg = config_from_hf(hf_cfg)
    return hf_model, cfg, convert_state_dict(hf_model.state_dict(), cfg, dtype="float32", device="cpu")


def _hf_generate(hf_model, ids: np.ndarray, *, max_new: int, rep: float, ngram: int = 0) -> np.ndarray:
    kw = dict(max_new_tokens=max_new, do_sample=False, num_beams=1, pad_token_id=0, repetition_penalty=rep,
              eos_token_id=-1)
    if ngram:
        kw["no_repeat_ngram_size"] = ngram
    with torch.no_grad():
        out = hf_model.generate(input_ids=torch.from_numpy(ids), attention_mask=torch.ones_like(
            torch.from_numpy(ids)), **kw)
    return out.numpy()[:, ids.shape[1]:]


@pytest.mark.parametrize("rep,ngram", [(1.1, 0), (1.3, 3)])
def test_generate_text_penalised_matches_hf(hf_pair, rep, ngram):
    """Penalty (and n-gram ban) over the prompt's ids and the generated
    ones: HF's tokens on every row."""
    hf_model, cfg, params = hf_pair
    head = np.random.default_rng(20 + ngram).integers(1, cfg.vocab_size, (3, 5))
    # the prompt ends with the model's own unpenalised continuation, so the
    # penalty set holds the tokens it would pick
    ids = np.concatenate([head, _hf_generate(hf_model, head, max_new=5, rep=1.0)], axis=1)
    ref = _hf_generate(hf_model, ids, max_new=14, rep=rep, ngram=ngram)
    gen_cfg = pengine.GenerationConfig(max_new_tokens=14, repetition_penalty=rep, no_repeat_ngram=ngram,
                                       penalize_prompt=True, pad_token_id=0)
    got, lengths = pengine.generate_text(params, cfg, gen_cfg, input_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(got, ref)
    assert (lengths == 14).all()
    # the prompt really is in the set: without it another token comes out
    plain, _ = pengine.generate_text(params, cfg, dataclasses.replace(gen_cfg, penalize_prompt=False),
                                     input_ids=torch.from_numpy(ids))
    assert (plain != ref).any()


def test_generate_text_left_padded_matches_jax(jax_flash_prefill):
    """A left-padded batch with the prompt penalised: JAX's tokens and
    lengths (EOS included), the pad/prefix penalty set and the overwritten
    prompt tail as the JAX module has them."""
    cfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32")
    jp = jqwen3.init_params(jax.random.PRNGKey(21), cfg, dtype="float32")
    pp = params_from_jax(to_np(jp))
    rng = np.random.default_rng(21)
    ids = rng.integers(1, cfg.vocab_size, (4, 11)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, pads in ((1, 4), (2, 1), (3, 7)):
        ids[row, :pads] = 0
        mask[row, :pads] = 0
    kw = dict(max_new_tokens=12, pad_token_id=0, eos_token_id=9, repetition_penalty=1.5, no_repeat_ngram=2,
              penalize_prompt=True)
    ref, ref_len = jengine.generate_text(jp, cfg, jengine.GenerationConfig(**kw), input_ids=jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask))
    got, got_len = pengine.generate_text(pp, port_cfg(cfg), pengine.GenerationConfig(**kw),
                                         input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got_len, np.asarray(ref_len))
    # the inherited buffer: a padded row's set starts with its pads
    seen, seen_len = pengine.seen_buffer(pengine.GenerationConfig(**kw), torch.from_numpy(mask),
                                         torch.from_numpy(ids), "cpu")
    assert seen.shape == (4, 11 + 12) and seen_len.tolist() == [11, 7, 10, 4]
    np.testing.assert_array_equal(seen[3, :4].numpy(), np.zeros(4, np.int32))


def test_early_exit_and_speculative_penalised_equal_generate():
    """``generate_early_exit`` and ``generate_speculative`` with the prompt
    penalised give ``generate``'s tokens and lengths (left-padded rows, EOS,
    an n-gram ban); early exit stops once every row is done."""
    cfg = port_cfg(dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"))
    params = pqwen3.init_params(torch.Generator().manual_seed(22), cfg, dtype="float32")
    rng = np.random.default_rng(22)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 9)).astype(np.int32))
    ids[:, 4:8] = ids[:, :4].clone()  # a repeat in the prompt, so drafts find matches
    mask = torch.ones_like(ids)
    ids[2, :3] = 0
    mask[2, :3] = 0
    emb = pqwen3.embed_tokens(params, ids)
    free, _ = pengine.generate_text(params, cfg, pengine.GenerationConfig(max_new_tokens=8), input_ids=ids,
                                    attention_mask=mask)
    gen_cfg = pengine.GenerationConfig(max_new_tokens=16, pad_token_id=0, eos_token_id=int(free[1, 5]),
                                       repetition_penalty=1.2, no_repeat_ngram=3, penalize_prompt=True)
    ref, ref_len = pengine.generate(params, cfg, gen_cfg, inputs_embeds=emb, attention_mask=mask, prompt_ids=ids)
    ee, ee_len, steps = pengine.generate_early_exit(params, cfg, gen_cfg, inputs_embeds=emb, attention_mask=mask,
                                                    prompt_ids=ids)
    np.testing.assert_array_equal(ee, ref)
    np.testing.assert_array_equal(ee_len, ref_len)
    assert steps == min(16, int(ref_len.max()))
    sp, sp_len, iters = pspec.generate_speculative(params, cfg, gen_cfg, inputs_embeds=emb, attention_mask=mask,
                                                   prompt_ids=ids, draft_k=3)
    np.testing.assert_array_equal(sp, ref)
    np.testing.assert_array_equal(sp_len, ref_len)
    assert 0 < iters <= 16
    # penalising the prompt changes these tokens (the flag reached every path)
    plain, _ = pengine.generate(params, cfg, dataclasses.replace(gen_cfg, penalize_prompt=False),
                                inputs_embeds=emb, attention_mask=mask)
    assert (plain != ref).any()


def test_generate_text_needs_a_card_unless_told_cpu(monkeypatch):
    """The helpers that allocate default to the card and raise without one:
    the cache, the view preprocessing and a checkpoint's load."""
    from vggt_qwen3_tpu_torch.inference import batching
    from vggt_qwen3_tpu_torch.ops import preprocess
    from vggt_qwen3_tpu_torch.train import checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(jconfig.QWEN3_TINY)
    img = np.zeros((8, 8, 3), np.uint8)
    for call in (lambda: pqwen3.init_cache(cfg, 1, 4),
                 lambda: preprocess.resize_center_crop(img, 4),
                 lambda: preprocess.preprocess_views([img], 4),
                 lambda: batching.stack_views([{"images": [img]}], 4),
                 lambda: checkpoint.load_params("no_such_dir"),
                 lambda: checkpoint.restore("no_such_dir")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert pqwen3.init_cache(cfg, 1, 4, device="cpu")["k"].device.type == "cpu"
    assert preprocess.resize_center_crop(img, 4, "cpu").shape == (3, 4, 4)
