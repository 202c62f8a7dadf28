"""The port's SFT CLI on the CPU: resume reproduces an uninterrupted run bit for
bit, a saved checkpoint serves QA inference as the in-memory params do, and
the Perceiver's training dropout behaves as dropout.

The runs use ``configs/stage1_3d.yaml`` with ``--tiny --device cpu`` (the
shipped placeholder ScanQA/SQA3D records and images, view dropout 0.3,
Perceiver dropout 0.1, LoRA), batch 2 and ``grad_accum`` 2 so updates land
inside 4 micro steps.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.models import perceiver as jperceiver
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
from vggt_qwen3_tpu_torch.inference import qa
from vggt_qwen3_tpu_torch.models import perceiver as pperceiver
from vggt_qwen3_tpu_torch.train import checkpoint as ckpt
from vggt_qwen3_tpu_torch.train import sft, trainer
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

REPO = Path(__file__).resolve().parents[1]


def _config(tmp_path: Path) -> Path:
    text = (REPO / "configs/stage1_3d.yaml").read_text()
    text = text.replace("grad_accum: 32", "grad_accum: 2").replace("batch_size_per_gpu: 6", "batch_size_per_gpu: 2")
    text = text.replace("configs/perceiver_small.yaml", str(REPO / "configs/perceiver_small.yaml"))
    path = tmp_path / "stage1_small_batch.yaml"
    path.write_text(text)
    return path


def _run(cfg: Path, out: Path, *extra: str):
    sft.main(["--config", str(cfg), "--output_dir", str(out), "--tiny", "--device", "cpu",
              "--data_root", str(REPO), "--max_steps", "4", "--log_every_steps", "1",
              "--save_every_steps", "100", *extra])


def test_resume_reproduces_an_uninterrupted_run(tmp_path):
    cfg = _config(tmp_path)
    _run(cfg, tmp_path / "a")
    _run(cfg, tmp_path / "b", "--stop_at_step", "2")
    assert ckpt.latest_step_dir(tmp_path / "b").name == "step_2"
    _run(cfg, tmp_path / "b", "--resume")
    a, b = (ckpt.restore(tmp_path / d / "step_4", "cpu") for d in ("a", "b"))
    assert a.step == b.step == 4 and a.opt_state["gradient_step"] == b.opt_state["gradient_step"] == 2
    for (na, ta), (nb, tb) in zip(trainer.named_leaves(a.params), trainer.named_leaves(b.params)):
        assert na == nb and torch.equal(ta, tb), na
    for key in ("acc", "mu", "nu"):
        assert a.opt_state[key].keys() == b.opt_state[key].keys()
        assert all(torch.equal(a.opt_state[key][n], b.opt_state[key][n]) for n in a.opt_state[key]), key
    lines = {p: [json.loads(x) for x in (tmp_path / p / "metrics.jsonl").read_text().splitlines()] for p in "ab"}
    assert [r["loss"] for r in lines["a"]] == [r["loss"] for r in lines["b"]]
    init = trainer.init_train_state(torch.Generator().manual_seed(42), sft.build_stage(sft.parse_args(
        ["--config", str(cfg), "--output_dir", str(tmp_path), "--tiny"])), dtype="float32")[0]
    moved = [n for n, t in trainer.named_leaves(a.params) if not torch.equal(t, dict(
        trainer.named_leaves(init.params))[n])]
    # the recipe freezes text layers 0-3 (all of the tiny model's) and the tower
    assert any(n.startswith("projector/") for n in moved) and any(n.startswith("geom/") for n in moved)
    assert not any(n.startswith(("text/", "vision/")) for n in moved)


def test_a_run_into_an_output_dir_with_checkpoints_needs_resume(tmp_path):
    """Without ``--resume`` a run into a directory that holds ``step_<n>/``
    stops before training: its saves would land on existing steps."""
    (tmp_path / "out" / "step_2").mkdir(parents=True)
    with pytest.raises(FileExistsError, match="--resume"):
        _run(_config(tmp_path), tmp_path / "out")


def test_qa_load_model_serves_a_checkpoint_as_the_in_memory_params(tmp_path):
    cfg = _config(tmp_path)
    args = sft.parse_args(["--config", str(cfg), "--output_dir", str(tmp_path), "--tiny", "--device", "cpu"])
    stage = sft.build_stage(args)
    stage = dataclasses.replace(stage, freeze_text_layers=(),
                                train=dataclasses.replace(stage.train, grad_accum=1, lr=5e-2, proj_lr=5e-2))
    state, tx = trainer.init_train_state(torch.Generator().manual_seed(0), stage, dtype="float32")
    tok = load_tokenizer(None)
    loader = sft.build_data(stage, tok, data_root=str(REPO))
    step = trainer.make_train_step(stage, tx, tok.convert_tokens_to_ids("<image>"), has_geom=True)
    for s in range(2):
        state, _ = step(state, sft.to_device(next(loader), "cpu"), trainer.step_generator(1, s, "cpu"))
    assert state.params["text"]["layers"]["lora"]["wq"]["B"].abs().max() > 0  # the adapters act
    ckpt.save(state, tmp_path / "out" / "step_2")
    restored = qa.load_model(stage, str(tmp_path / "out"), device="cpu")
    for (n, a), (_, b) in zip(trainer.named_leaves(state.params), trainer.named_leaves(restored)):
        assert torch.equal(a, b), n
    rng = np.random.default_rng(0)
    samples = [{"question": q, "images": [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2)]}
               for q in ("what is on the table?", "how many chairs?", "where is the sofa?")]
    run = lambda p: qa.run_inference(p, stage, tok, samples, max_new_tokens=6, batch_size=2,  # noqa: E731
                                     verbose=False, device="cpu")
    with torch.no_grad():
        assert run(restored) == run(state.params)


def test_perceiver_dropout_keeps_about_ninety_percent_and_scales_them():
    x = torch.ones(400, 500)
    y = pperceiver.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    # 200,000 Bernoulli(0.9) draws: the kept share is within 5 standard deviations of 0.9
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(pperceiver.dropout(x, 0.1, None), x) and torch.equal(
        y, pperceiver.dropout(x, 0.1, torch.Generator().manual_seed(0)))


def test_perceiver_without_a_generator_is_jax_eval():
    jcfg = jconfig.PerceiverConfig(latent_dim=32, num_latents=8, num_heads=4, num_layers=2, ffn_dim=64, dropout=0.1)
    pcfg = pconfig.PerceiverConfig(**dataclasses.asdict(jcfg))
    jp = jperceiver.init_params(jax.random.PRNGKey(0), jcfg, in_dim=24, out_dim=16)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(1).standard_normal((2, 11, 24)).astype(np.float32)
    ref = np.asarray(jperceiver.apply(jp, jcfg, jax.numpy.asarray(tokens)))
    got = pperceiver.apply(pp, pcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    train = pperceiver.apply(pp, pcfg, torch.from_numpy(tokens), generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(train, got)


def test_parallel_flags_and_adamw8bit_raise_naming_the_roadmap(tmp_path):
    """The JAX CLI's mesh and launch flags parse (parallelism is ported: see
    ROADMAP, parallelism) and raise where JAX raises: a mesh the world does
    not fit, a ring over an axis of one rank. adamw8bit builds; an unknown
    optimizer raises."""
    args = sft.parse_args(["--config", "c.yaml", "--output_dir", str(tmp_path), "--dp", "2", "--fsdp", "2", "--tp",
                           "2", "--pp", "2", "--pp_microbatches", "4", "--ring", "--multihost",
                           "--coordinator_address", "127.0.0.1:1234", "--num_processes", "16", "--process_id", "3"])
    assert (args.dp, args.fsdp, args.tp, args.pp, args.pp_microbatches, args.ring, args.multihost,
            args.coordinator_address, args.num_processes, args.process_id) == (
        2, 2, 2, 2, 4, "fsdp", True, "127.0.0.1:1234", 16, 3)
    assert sft.parse_args(["--config", "c.yaml", "--output_dir", "o", "--ring", "tp"]).ring == "tp"
    toy = ["--config", str(REPO / "configs/toy.yaml"), "--tiny", "--mock_vision", "--device", "cpu",
           "--data_root", str(REPO), "--max_steps", "2"]
    stage = sft.build_stage(sft.parse_args([*toy, "--output_dir", "o", "--fsdp", "8", "--pp_microbatches", "6"]), 1)
    assert stage.mesh.shape == (1, 8, 1, 1) and stage.train.pp_microbatches == 6
    with pytest.raises(ValueError, match=r"mesh \(1, 8, 1, 1\) needs 8 devices, have 1"):
        sft.main([*toy, "--output_dir", str(tmp_path / "a"), "--fsdp", "8"])
    with pytest.raises(ValueError, match="ring axis 'fsdp' has extent < 2"):
        sft.main([*toy, "--output_dir", str(tmp_path / "b"), "--ring"])
    assert not torch.distributed.is_initialized()  # the world made for each run is gone
    stage = sft.build_stage(sft.parse_args(["--config", str(REPO / "configs/stage1_3d.yaml"),
                                            "--output_dir", str(tmp_path), "--tiny"]))
    # adamw8bit is ported (train/adam8bit.py): it builds; an unknown optimizer raises
    assert trainer.Optimizer(dataclasses.replace(stage.train, optimizer="adamw8bit"), {}).cfg.optimizer == "adamw8bit"
    with pytest.raises(ValueError, match="unknown train.optimizer"):
        trainer.Optimizer(dataclasses.replace(stage.train, optimizer="lion"), {})
