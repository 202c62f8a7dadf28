"""The port's two attention kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain version (the kernel's numerics);
the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_flash_attention.py`` and ``tests/test_decode_attention.py`` do.
Inputs come from a numpy seed and go to both sides. Tolerances: float32
1e-5 (reassociation only), bf16 2e-2 (one bf16 rounding of P or of the
output). Dead query rows are compared separately: the port gives exactly 0.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu.ops.decode_attention import gqa_decode_attention as jax_decode
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch.ops import decode_attention as pdecode
from vggt_qwen3_tpu_torch.ops import flash_attention as pflash
from vggt_qwen3_tpu_torch.utils.agreement import agreement
from vggt_qwen3_tpu_torch.utils.from_jax import array_to_torch

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    a = a.astype(NP_DT[dtype])
    return jnp.asarray(a), array_to_torch(a)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # VGGT-like: non-causal, D=64, no padding, ragged tile edges
    "noncausal_d64": dict(B=2, S=37, T=53, NH=4, NKV=4, D=64, causal=False, starts=None),
    # Qwen3-prefill-like: causal, left-padded, GQA, D=128
    "causal_leftpad_gqa_d128": dict(B=2, S=40, T=40, NH=4, NKV=2, D=128, causal=True, starts=[5, 0]),
    # the CUDA kernel's tile edges: past 128 (and 192) query rows and keys,
    # frontiers that end before T, a GQA group of 2 (JAX in 64-blocks)
    "edge_noncausal_frontier_d64": dict(B=2, S=193, T=129, NH=4, NKV=2, D=64, causal=False, starts=[0, 40],
                                        ends=[129, 100], block=64),
    "edge_causal_frontier_d128": dict(B=2, S=129, T=193, NH=4, NKV=2, D=128, causal=True, starts=[3, 70],
                                      ends=[150, 193], block=64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(case, dtype):
    c = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    B, S, T, NH, NKV, D = (c[k] for k in ("B", "S", "T", "NH", "NKV", "D"))
    qj, qt = _pair(rng.standard_normal((B, S, NH, D)), dtype)
    kj, kt = _pair(rng.standard_normal((B, T, NKV, D)), dtype)
    vj, vt = _pair(rng.standard_normal((B, T, NKV, D)), dtype)
    kw_j, kw_t = {}, {}
    for key, name in (("starts", "kv_start"), ("ends", "kv_end")):
        if c.get(key) is not None:
            bounds = np.asarray(c[key], np.int32)
            kw_j[name] = jnp.asarray(bounds)
            kw_t[name] = torch.from_numpy(bounds)
    blk = c.get("block", 16)
    ref = _f32(jax_flash(qj, kj, vj, causal=c["causal"], block_q=blk, block_kv=blk, interpret=True, **kw_j))
    got = _f32(pflash.flash_attention(qt, kt, vt, causal=c["causal"], **kw_t))
    assert got.shape == (B, S, NH, D)
    for b in range(B):  # valid rows only: with causal, rows left of the start see no key
        s0 = 0 if c["starts"] is None or not c["causal"] else c["starts"][b]
        np.testing.assert_allclose(got[b, s0:], ref[b, s0:], atol=TOL[dtype], rtol=TOL[dtype])
        assert not got[b, :s0].any(), "dead rows must be exactly 0"


def test_flash_plain_frontier_end_and_dead_rows():
    """kv_end below T and a row whose frontier is empty."""
    rng = np.random.default_rng(1)
    B, S, T, NH, D = 3, 9, 21, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, NH, D), (B, T, NH, D), (B, T, NH, D)))
    start = torch.tensor([0, 4, 7], dtype=torch.int32)
    end = torch.tensor([21, 10, 7], dtype=torch.int32)
    got = pflash.flash_attention(q, k, v, kv_start=start, kv_end=end)
    ref = _f32(jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                         kv_start=jnp.asarray(start.numpy()), kv_end=jnp.asarray(end.numpy()),
                         block_q=8, block_kv=8, interpret=True))
    np.testing.assert_allclose(got[:2].numpy(), ref[:2], atol=1e-5, rtol=1e-5)
    assert not got[2].any()


# ---------------------------------------------------------------------------
# GQA decode attention
# ---------------------------------------------------------------------------

L, B, NH, NKV, T, D = 3, 4, 8, 2, 64, 128


def _decode_inputs(rng, quantized: bool, dtype: str):
    start = rng.integers(0, 8, (B,)).astype(np.int32)
    end = rng.integers(16, T + 1, (B,)).astype(np.int32)
    q = rng.standard_normal((B, NH, D))
    if quantized:
        k = rng.integers(-127, 128, (L, B, NKV, T, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, B, NKV, T, D)).astype(np.int8)
        ks = (rng.uniform(0.5, 2.0, (L, B, NKV, T)) * 0.01).astype(ml_dtypes.bfloat16)
        vs = (rng.uniform(0.5, 2.0, (L, B, NKV, T)) * 0.01).astype(ml_dtypes.bfloat16)
        arrays = [q.astype(NP_DT[dtype]), k, v, ks, vs]
    else:
        k = rng.standard_normal((L, B, NKV, T, D)).astype(NP_DT[dtype])
        v = rng.standard_normal((L, B, NKV, T, D)).astype(NP_DT[dtype])
        arrays = [q.astype(NP_DT[dtype]), k, v, None, None]
    return arrays, start, end


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache", ["model_dtype", "int8"])
def test_decode_plain_matches_pallas(cache, dtype):
    rng = np.random.default_rng(2)
    (q, k, v, ks, vs), start, end = _decode_inputs(rng, cache == "int8", dtype)
    li = 1
    ref = _f32(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), li, jnp.asarray(start), jnp.asarray(end),
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        interpret=True, block_b=2,
    ))
    t = lambda a: None if a is None else array_to_torch(a)  # noqa: E731
    got = pdecode.gqa_decode_attention(
        t(q), t(k), t(v), li, torch.from_numpy(start), torch.from_numpy(end), t(ks), t(vs)
    )
    assert got.dtype == t(q).dtype and got.shape == (B, NH, D)
    np.testing.assert_allclose(_f32(got), ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_wrappers_never_count_plain_runs():
    before = (pflash.launches, pdecode.launches)
    x = torch.zeros(1, 4, 2, 64)
    pflash.flash_attention(x, x, x)
    cache = torch.zeros(1, 1, 2, 4, 64)
    pdecode.gqa_decode_attention(x[:, 0], cache, cache, 0, torch.tensor([0]), torch.tensor([1]))
    assert (pflash.launches, pdecode.launches) == before


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pflash.flash_attention(x, x, x)
    cache = torch.zeros(1, 1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pdecode.gqa_decode_attention(x[:, 0], cache, cache, 0, torch.tensor([0]), torch.tensor([1]))


# ---------------------------------------------------------------------------
# the rule that holds a kernel to its plain version on the card
# ---------------------------------------------------------------------------


def _tiled_flash(q, k, v, *, tile=64, drop=None, scale_mul=1.0, l_misses=None):
    """The kernel's algorithm in PyTorch, one head: 64-key tiles, online
    softmax in f32, the unnormalised P rounded to bf16 before PV; with one
    of the faults a kernel could have."""
    s = (q.float() @ k.float().T) * (q.shape[-1] ** -0.5 * scale_mul)
    m = torch.full((s.shape[0],), -float("inf"))
    l = torch.zeros(s.shape[0])
    acc = torch.zeros(s.shape[0], v.shape[-1])
    for j in range(0, s.shape[1], tile):
        if j // tile == drop:
            continue
        st = s[:, j:j + tile]
        m_new = torch.maximum(m, st.amax(-1))
        a, p = torch.exp(m - m_new), torch.exp(st - m_new[:, None])
        l = l * a + (0.0 if j // tile == l_misses else p.sum(-1))
        acc = acc * a[:, None] + p.bfloat16().float() @ v[j:j + tile].float()
        m = m_new
    return (acc / l[:, None]).bfloat16()


@pytest.mark.parametrize("fault,ok", [
    (None, True),
    (dict(drop=30), False),         # one K/V tile left out
    (dict(drop=63), False),         # the last tile left out
    (dict(scale_mul=1.01), False),  # softmax scale 1 % off
    (dict(l_misses=30), False),     # one tile missing from the softmax sum
])
def test_agreement_catches_faults_an_absolute_tolerance_misses(fault, ok):
    """At a long key axis the outputs are ~0.02, so atol = 2e-2 would pass
    every fault here; the scaled limits pass only the right kernel."""
    rng = np.random.default_rng(3)
    S, T, D = 128, 4096, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((S, D), (T, D), (T, D)))
    ref = pflash.flash_attention_plain(q[None, :, None], k[None, :, None], v[None, :, None])[0, :, 0]
    got = _tiled_flash(q, k, v, **(fault or {}))
    assert torch.allclose(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert agreement(got, ref)["ok"] is ok


# ---------------------------------------------------------------------------
# the build (no compiler here: what surrounds it)
# ---------------------------------------------------------------------------


@pytest.fixture
def build_dirs(tmp_path, monkeypatch):
    from vggt_qwen3_tpu_torch.ops import kernel_build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(kernel_build, "CSRC", csrc)
    monkeypatch.setattr(kernel_build, "BUILD", tmp_path / "build")
    return kernel_build, tmp_path


def test_kernel_build_target_follows_the_source(build_dirs):
    kernel_build, tmp = build_dirs
    first = kernel_build._target("a")
    assert first.parent == tmp / "build" and first.name.startswith("liba-")
    (tmp / "csrc" / "a.cu").write_text("// a, edited\n")
    assert kernel_build._target("a") != first


def test_kernel_build_raises_without_nvcc(build_dirs, monkeypatch):
    kernel_build, tmp = build_dirs
    monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp / "no_toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_build.build(["a"])


def test_kernel_build_reports_compiler_errors_after_every_compiler_ends(build_dirs, monkeypatch):
    import subprocess

    kernel_build, tmp = build_dirs
    fake = tmp / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no compiler here'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: str(fake))
    started = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        started.append(real_popen(*a, **kw))
        return started[-1]

    monkeypatch.setattr(kernel_build.subprocess, "Popen", popen)
    with pytest.raises(RuntimeError, match="nvcc failed for a.cu") as err:
        kernel_build.build(["a", "b"])
    assert "error: no compiler here" in str(err.value)
    assert len(started) == 2 and all(p.returncode == 2 for p in started)
    assert not any((tmp / "build").glob("*.so"))


def test_kernel_build_keeps_the_ptxas_report_for_a_later_load(build_dirs, monkeypatch):
    """A library loaded from an earlier build (no compiler run) still shows
    what ptxas said when it was built: the spill checks read it."""
    kernel_build, tmp = build_dirs
    fake = tmp / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\ntouch \"$2\"\n"
                    "echo 'ptxas info    : 8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(kernel_build, "_LIBS", {})
    first = kernel_build.build(["a"])[0]
    kernel_build._LIBS.clear()
    again = kernel_build.build(["a"])[0]
    assert "8 bytes spill stores" in first.ptxas_log
    assert again.ptxas_log == first.ptxas_log and again.build_seconds == 0.0
