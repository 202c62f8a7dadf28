"""The port's data readers against the JAX package's, on the CPU: the lazy
JSONL index (``data/jsonl_index.py``, native and Python backends), the
thread-pooled image decoder (``data/image_decode.py``) and the dataset's lazy
slots over them.

Held: every record of a JSONL file with CRLF endings, blank and
whitespace-only lines and a last line without a newline equal to an eager
parse and to JAX's ``JsonlIndex``; PNGs (RGB, gray, RGBA, palette) bit for bit
against PIL's ``convert("RGB")`` and JAX's decoder; the placeholder JPEGs
within ±1 of PIL and equal to JAX's decoder (the same libjpeg); a missing
file raising ``FileNotFoundError``; the ScanQA split read through lazy slots
with the records and views JAX's dataset gives.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vggt_qwen3_tpu.data import dataset as jdataset
from vggt_qwen3_tpu.data import image_decode as jdecode
from vggt_qwen3_tpu.data import jsonl_index as jjsonl
from vggt_qwen3_tpu_torch.data import dataset as pdataset
from vggt_qwen3_tpu_torch.data import image_decode as pdecode
from vggt_qwen3_tpu_torch.data import jsonl_index as pjsonl
from vggt_qwen3_tpu_torch.data import native

REPO = Path(__file__).resolve().parents[1]
JPEGS = sorted((REPO / "data/processed/placeholder_images").glob("ph_arkit_train_00[01]_v*.jpg"))


@pytest.fixture
def jsonl_file(tmp_path):
    recs = [{"i": i, "q": f"question {i}", "images": [f"v{i}.jpg"]} for i in range(7)]
    lines = [json.dumps(r) for r in recs]
    body = (lines[0] + "\r\n" + "\n" + lines[1] + "\n   \t\n" + "\r\n".join(lines[2:5]) + "\r\n\n"
            + "\n".join(lines[5:]))  # the last line has no newline
    path = tmp_path / "split.jsonl"
    path.write_bytes(body.encode())
    return path, recs


@pytest.mark.parametrize("backend", ["native", "python"])
def test_jsonl_index_matches_an_eager_parse_and_jax(jsonl_file, backend):
    path, recs = jsonl_file
    index = pjsonl.JsonlIndex(path, native=backend == "native")
    assert index.backend == backend and len(index) == len(recs)
    eager = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    ref = jjsonl.JsonlIndex(path)
    assert len(ref) == len(index)
    for i in range(len(recs)):
        assert index[i] == eager[i] == recs[i] == ref[i]
        assert index.raw(i) == ref.raw(i)
    with pytest.raises(IndexError):
        index.raw(len(recs))
    index.close()


def test_native_libraries_build_into_the_package_build_dir():
    assert pjsonl.native_available() and pdecode.native_available()
    for name in ("jsonl_index", "image_decode"):
        built = list((native.BUILD).glob(f"lib{name}-*.so"))
        assert built and native.why_not(name) is None, name


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    out = {}
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(rng.integers(0, 256, (21, 33)).astype(np.uint8), "L").save(d / "gray.png")
    Image.fromarray(rng.integers(0, 256, (18, 25, 4)).astype(np.uint8), "RGBA").save(d / "rgba.png")
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(d / "pal.png")
    for name in ("rgb", "gray", "rgba", "pal"):
        out[name] = str(d / f"{name}.png")
    return out


@pytest.mark.parametrize("name", ["rgb", "gray", "rgba", "pal"])
def test_png_bit_exact_against_pil_and_jax(pngs, name):
    path = pngs[name]
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    before = dict(pdecode.decoded)
    got = pdecode.decode_rgb(path)
    assert pdecode.decoded["native"] == before["native"] + 1
    assert got.dtype == np.uint8 and got.shape == pil.shape
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jdecode.decode_rgb(path, native=True))
    np.testing.assert_array_equal(pdecode.decode_rgb(path, native=False), pil)


def test_placeholder_jpegs_within_one_of_pil_and_equal_to_jax():
    assert len(JPEGS) == 20
    paths = [str(p) for p in JPEGS]
    batch = pdecode.decode_batch_rgb(paths, nthreads=4)
    ref = jdecode.decode_batch_rgb(paths, native=True)
    for p, got, theirs in zip(paths, batch, ref):
        with Image.open(p) as im:
            pil = np.asarray(im.convert("RGB"))
        assert got.shape == pil.shape and got.dtype == np.uint8
        assert np.abs(got.astype(np.int16) - pil.astype(np.int16)).max() <= 1, p
        np.testing.assert_array_equal(got, theirs)
        np.testing.assert_array_equal(got, pdecode.decode_rgb(p))
        np.testing.assert_array_equal(pdecode.decode_rgb(p, native=False), pil)


@pytest.mark.parametrize("native_flag", [None, False])
def test_missing_file_raises(tmp_path, native_flag):
    missing = str(tmp_path / "nope.jpg")
    with pytest.raises(FileNotFoundError):
        pdecode.decode_rgb(missing, native=native_flag)
    with pytest.raises(FileNotFoundError):
        pdecode.decode_batch_rgb([str(JPEGS[0]), missing], native=native_flag)


def test_dataset_reads_jsonl_through_lazy_slots_as_jax_does():
    cfg = dict(path_glob="data/processed/scanqa/train_split.jsonl", num_views=8, image_size=448, task="scanqa",
               root=str(REPO))
    ours = pdataset.MultiViewJsonDataset(pdataset.DatasetConfig(**cfg))
    theirs = jdataset.MultiViewJsonDataset(jdataset.DatasetConfig(**cfg))
    assert len(ours) == len(theirs) == 32
    assert all(isinstance(s, tuple) and isinstance(s[0], pjsonl.JsonlIndex) for s in ours._slots)
    assert ours._slots[0][0].backend == "native"
    for i in (0, 5, 31):
        assert ours.meta(i) == theirs.meta(i)
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in ("question", "answer", "task", "scene_id"):
            assert a[key] == b[key], key
        assert (a["geom_token"] is None) == (b["geom_token"] is None)
        for key in (a["geom_token"] or {}):
            np.testing.assert_array_equal(a["geom_token"][key], b["geom_token"][key])
        assert len(a["images"]) == 8
        for x, y in zip(a["images"], b["images"]):
            np.testing.assert_array_equal(x, y)
    arkit = pdataset.MultiViewJsonDataset(pdataset.DatasetConfig(
        path_glob="data/processed/arkit_synth/*.json", num_views=10, image_size=448, task="arkit", root=str(REPO)))
    assert len(arkit) == 12 and all(isinstance(s, dict) for s in arkit._slots)
