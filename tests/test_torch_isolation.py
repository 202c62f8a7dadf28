"""What keeps the port a port: it never imports JAX or the JAX package, its
entry points run on the card or raise, and ``chip_smoke.py`` drives the
stage that ``configs/stage1_3d.yaml`` describes."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vggt_qwen3_tpu")


def _port_files():
    return sorted((REPO / "vggt_qwen3_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference import qa
    from vggt_qwen3_tpu_torch.train import sft

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stage = qa.build_stage(_tiny_args())
    params = qa.load_model(stage, device="cpu")
    sample = {"question": "what?", "images": [torch.zeros(8, 8, 3, dtype=torch.uint8).numpy()]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qa.run_inference(params, stage, load_tokenizer(None), [sample], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qa.load_model(stage)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sft.main(["--config", str(REPO / "configs/stage1_3d.yaml"), "--output_dir", str(tmp_path), "--tiny"])
    assert not any(tmp_path.iterdir())


def _tiny_args():
    import argparse

    return argparse.Namespace(config=str(REPO / "configs/stage1_3d.yaml"), tiny=True, mock_vision=True,
                              checkpoint_dir=None)


def test_chip_smoke_stage_is_stage1_3d():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from vggt_qwen3_tpu_torch.config import load_stage_config

    built = chip_smoke.full_stage()
    loaded = load_stage_config(REPO / "configs/stage1_3d.yaml")
    # the QA path reads the model and data blocks; geom is not on it
    assert dataclasses.replace(built.model, geom_tokens=0) == dataclasses.replace(loaded.model, geom_tokens=0)
    assert built.data == loaded.data


def test_chip_smoke_train_stage_is_stage1_3d_with_its_reductions():
    """The training phase's stage is the recipe's, but for the three listed
    reductions: batch 2 (6), grad_accum 2 (32), a 4-step schedule (30,000)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from vggt_qwen3_tpu_torch.config import load_stage_config

    built = chip_smoke.train_stage()
    loaded = load_stage_config(REPO / "configs/stage1_3d.yaml")
    assert (built.model, built.data, built.lora, built.freeze_text_layers) == \
        (loaded.model, loaded.data, loaded.lora, loaded.freeze_text_layers)
    assert dataclasses.replace(built.train, batch_size_per_device=6, grad_accum=32, max_steps=30_000) == loaded.train


def test_chip_smoke_arkit_stage_is_stage2_arkit():
    """The ARKit phase's stage and samples are those of the CLI (built and
    made without a YAML reader or an image decoder; the views are seeded)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from vggt_qwen3_tpu_torch.config import load_stage_config
    from vggt_qwen3_tpu_torch.inference.arkit import load_arkit_samples

    built = chip_smoke.arkit_stage()
    loaded = load_stage_config(REPO / "configs/stage2_arkit.yaml")
    assert built.model == loaded.model and built.data == loaded.data
    ours = chip_smoke.load_arkit_samples(0)
    cli = load_arkit_samples("data/processed/arkit_synth/test.json", 9, 10, 448, root=str(REPO))
    keys = ("question", "answer", "scene_id", "task", "geom_token")
    assert [{k: s[k] for k in keys} for s in ours] == [{k: s[k] for k in keys} for s in cli]
    assert all(len(s["images"]) == 10 and s["images"][0].shape == c["images"][0].shape for s, c in zip(ours, cli))


def test_chip_smoke_fails_without_a_card(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
                              timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
