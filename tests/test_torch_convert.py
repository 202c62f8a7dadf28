"""The port's weight converters against the JAX package's, bit for bit.

- ``models/convert_qwen3.py``: a randomly initialised transformers
  ``Qwen3ForCausalLM`` (local config, no download), saved with
  ``save_pretrained`` and read back through ``load_safetensors_dir``;
  ``convert_state_dict``, ``config_from_hf`` and ``load_qwen3`` give JAX's
  config and JAX's leaves (bf16 and float32, tied and untied heads).
- ``vggt`` / ``perceiver`` / ``geom.convert_torch_state_dict`` on the
  state dicts of the in-test torch oracles (``tests/test_vggt_oracle.py``,
  ``tests/test_perceiver_parity.py``) and of a torch geometry head.
- The manifests of ``tools/audit_checkpoint.py`` are exactly the keys the
  port's converters read, and the converted trees have the shapes of the
  port's ``init_params``.
- ``python -m vggt_qwen3_tpu_torch.tools.convert_reference_ckpt`` on a
  synthetic reference checkpoint (every component's keys, prefixed as the
  reference names its modules): its leaves equal the repository's JAX tool's,
  and ``qa.load_model`` restores the ``step_<n>`` checkpoint it writes.

Bit for bit: float32 leaves equal exactly, bf16 leaves as 16-bit patterns.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch import nn

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import audit_checkpoint as audit  # noqa: E402
import convert_reference_ckpt as jtool  # noqa: E402
from test_perceiver_parity import TorchPerceiverOracle  # noqa: E402
from test_vggt_oracle import CFG as VGGT_ORACLE_CFG  # noqa: E402
from test_vggt_oracle import Aggregator  # noqa: E402

from vggt_qwen3_tpu import config as jconfig  # noqa: E402
from vggt_qwen3_tpu.models import convert_qwen3 as jconvert  # noqa: E402
from vggt_qwen3_tpu.models import geom as jgeom  # noqa: E402
from vggt_qwen3_tpu.models import perceiver as jperceiver  # noqa: E402
from vggt_qwen3_tpu.models import vggt as jvggt  # noqa: E402
from vggt_qwen3_tpu_torch import config as pconfig  # noqa: E402
from vggt_qwen3_tpu_torch.inference import qa as pqa  # noqa: E402
from vggt_qwen3_tpu_torch.models import convert_qwen3 as pconvert  # noqa: E402
from vggt_qwen3_tpu_torch.models import geom as pgeom  # noqa: E402
from vggt_qwen3_tpu_torch.models import perceiver as pperceiver  # noqa: E402
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3  # noqa: E402
from vggt_qwen3_tpu_torch.models import vggt as pvggt  # noqa: E402
from vggt_qwen3_tpu_torch.models import vlm as pvlm  # noqa: E402
from vggt_qwen3_tpu_torch.tools import convert_reference_ckpt as ptool  # noqa: E402


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_bits_equal(ptree, jtree):
    """Same keys, shapes and dtypes; the same bits in every leaf."""
    p, j = _flat(ptree), _flat(jax.tree.map(np.asarray, jtree))
    assert p.keys() == j.keys()
    for k, ref in j.items():
        got = p[k]
        assert got.device.type == "cpu" and tuple(got.shape) == ref.shape, k
        if ref.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16), err_msg=k)
        else:
            assert str(got.dtype).removeprefix("torch.") == ref.dtype.name, k
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=k)


def _hf_qwen3(tie: bool, seed: int = 0):
    from transformers import Qwen3Config as HFQwen3Config
    from transformers import Qwen3ForCausalLM

    hf_cfg = HFQwen3Config(vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=16, intermediate_size=128, rope_theta=10_000.0,
                           tie_word_embeddings=tie, max_position_embeddings=2048)
    torch.manual_seed(seed)
    return hf_cfg, Qwen3ForCausalLM(hf_cfg).eval().to(torch.float32)


@pytest.mark.parametrize("tie", [True, False])
def test_qwen3_from_safetensors_matches_jax(tmp_path, tie):
    """save_pretrained → load_safetensors_dir → convert_state_dict, and
    load_qwen3 from the directory: JAX's config and leaves, bf16 and f32."""
    hf_cfg, hf_model = _hf_qwen3(tie, seed=int(tie))
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    psd, jsd = pconvert.load_safetensors_dir(tmp_path), jconvert.load_safetensors_dir(tmp_path)
    assert psd.keys() == jsd.keys() and ("lm_head.weight" in psd) == (not tie)
    pcfg, jcfg = pconvert.config_from_hf(hf_cfg), jconvert.config_from_hf(hf_cfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    for dtype in ("bfloat16", "float32"):
        assert_bits_equal(pconvert.convert_state_dict(psd, pcfg, dtype=dtype, device="cpu"),
                          jconvert.convert_state_dict(jsd, jcfg, dtype=dtype))
        (pc, pp), (jc, jp) = (pconvert.load_qwen3(tmp_path, dtype=dtype, device="cpu"),
                              jconvert.load_qwen3(tmp_path, dtype=dtype))
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        assert_bits_equal(pp, jp)
    # the converted model computes HF's logits (float32)
    ids = np.random.default_rng(0).integers(0, 160, (2, 9))
    with torch.no_grad():
        ref = hf_model(input_ids=torch.from_numpy(ids)).logits.numpy()
    params = pconvert.convert_state_dict(hf_model.state_dict(), pcfg, dtype="float32", device="cpu")
    got, _ = pqwen3.forward(params, pcfg, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vggt_converter_matches_jax(dtype):
    torch.manual_seed(7)
    sd = Aggregator().eval().float().state_dict()
    assert_bits_equal(pvggt.convert_torch_state_dict(sd, VGGT_ORACLE_CFG, dtype=dtype, device="cpu"),
                      jvggt.convert_torch_state_dict(sd, VGGT_ORACLE_CFG, dtype=dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_perceiver_converter_matches_jax(dtype):
    cfg = jconfig.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=3, ffn_dim=128,
                                  dropout=0.0)
    torch.manual_seed(0)
    sd = TorchPerceiverOracle(cfg, in_dim=48, out_dim=32).eval().state_dict()
    assert_bits_equal(pperceiver.convert_torch_state_dict(sd, cfg, dtype=dtype, device="cpu"),
                      jperceiver.convert_torch_state_dict(sd, cfg, dtype=dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_geom_converter_matches_jax(dtype):
    torch.manual_seed(2)
    sd = nn.Sequential(nn.Linear(37, 40), nn.SiLU(), nn.Linear(40, 40)).eval().state_dict()
    assert_bits_equal(pgeom.convert_torch_state_dict(sd, dtype=dtype, device="cpu"),
                      jgeom.convert_torch_state_dict(sd, dtype=dtype))


class TrackingDict(dict):
    """A state dict that records every key a converter reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _synth(manifest, seed=0):
    rng = np.random.default_rng(seed)
    return TrackingDict({k: rng.standard_normal(shape).astype(np.float32) for k, shape in manifest.items()})


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


PERCEIVER_TINY = pconfig.PerceiverConfig(latent_dim=16, num_latents=4, num_heads=2, num_layers=2, ffn_dim=32)


@pytest.mark.parametrize("component", ["qwen3_tied", "qwen3_untied", "vggt", "perceiver", "geom"])
def test_audit_manifests_match_the_port_converters(component):
    """Each manifest is exactly what the port's converter reads, and the
    converted tree has the shapes of the port's init_params."""
    gen = torch.Generator().manual_seed(0)
    hidden = pconfig.QWEN3_TINY.hidden_size
    in_dim = 2 * pconfig.VGGT_TINY.embed_dim
    if component.startswith("qwen3"):
        cfg = dataclasses.replace(pconfig.QWEN3_TINY, tie_word_embeddings=component == "qwen3_tied")
        manifest = audit.expected_qwen3_keys(cfg)
        convert = lambda sd: pconvert.convert_state_dict(sd, cfg, dtype="float32", device="cpu")  # noqa: E731
        ref = pqwen3.init_params(gen, cfg, dtype="float32")
    elif component == "vggt":
        cfg = pconfig.VGGT_TINY
        manifest = audit.expected_vggt_keys(cfg)
        convert = lambda sd: pvggt.convert_torch_state_dict(sd, cfg, dtype="float32", device="cpu")  # noqa: E731
        ref = pvggt.init_params(gen, cfg, dtype="float32")
    elif component == "perceiver":
        manifest = audit.expected_perceiver_keys(PERCEIVER_TINY, in_dim, hidden)
        convert = lambda sd: pperceiver.convert_torch_state_dict(  # noqa: E731
            sd, PERCEIVER_TINY, dtype="float32", device="cpu")
        ref = pperceiver.init_params(gen, PERCEIVER_TINY, in_dim, hidden, dtype="float32")
    else:
        manifest = audit.expected_geom_keys(hidden)
        convert = lambda sd: pgeom.convert_torch_state_dict(sd, dtype="float32", device="cpu")  # noqa: E731
        ref = pgeom.init_params(gen, hidden, dtype="float32")
    sd = _synth(manifest)
    params = convert(sd)
    assert sd.read == set(manifest), f"unread {set(manifest) - sd.read}, extra {sd.read - set(manifest)}"
    assert _shapes(params) == _shapes(ref)


def test_convert_reference_ckpt_matches_jax_tool_and_restores(tmp_path):
    """A synthetic reference checkpoint (the four components' manifests,
    prefixed ``text_model.`` / ``projector.`` / ``geom_head.`` /
    ``vision_model.aggregator.``; ``module.`` on some keys) in one file:
    the port's tool gives the JAX tool's leaves, its CLI writes
    the ``step_3`` checkpoint and ``qa.load_model`` restores it."""
    stage_yaml = tmp_path / "stage.yaml"
    stage_yaml.write_text((REPO / "configs" / "toy.yaml").read_text().replace(
        "projector: null",
        "projector: {latent_dim: 16, num_latents: 4, num_heads: 2, num_layers: 2, ffn_dim: 32, dropout: 0.0}"))
    tiny = dict(text_config=pconfig.QWEN3_TINY, vision_config=pconfig.VGGT_TINY)
    pstage = pconfig.load_stage_config(stage_yaml, **tiny)
    jstage = jconfig.load_stage_config(stage_yaml, text_config=jconfig.QWEN3_TINY, vision_config=jconfig.VGGT_TINY)
    m = pstage.model
    rng = np.random.default_rng(1)
    sd = {}
    for prefix, manifest in (
        ("text_model.", audit.expected_qwen3_keys(m.text)),
        ("module.projector.", audit.expected_perceiver_keys(m.projector, m.vision_out_dim, m.text.hidden_size)),
        ("geom_head.", audit.expected_geom_keys(m.text.hidden_size)),
        ("vision_model.aggregator.", audit.expected_vggt_keys(m.vision)),
    ):
        for k, shape in manifest.items():
            sd[prefix + k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    src = tmp_path / "reference.pt"
    torch.save(sd, src)

    got = ptool.convert(src, pstage, "float32", device="cpu")
    ref = jtool.convert(src, jstage, "float32")
    assert_bits_equal(got, ref)

    ptool.main(["--src", str(src), "--dest", str(tmp_path / "out"), "--config", str(stage_yaml), "--tiny",
                "--step", "3", "--device", "cpu"])
    assert (tmp_path / "out" / "step_3" / ".metadata").exists()
    restored = pqa.load_model(pstage, str(tmp_path / "out"), device="cpu")
    assert_bits_equal(restored, jtool.convert(src, jstage, "bfloat16"))
    # the restored tree serves: the tiny VLM encodes two views
    vis = pvlm.encode_images(restored, pstage.model, torch.rand(1, 2, 3, 56, 56).to(torch.bfloat16))
    assert vis.shape == (1, pstage.model.projector.num_latents, pstage.model.text.hidden_size)
    assert torch.isfinite(vis.float()).all()
