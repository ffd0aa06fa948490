"""PyTorch port: parameter conversion, device rule and import rule."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, numpy_params, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_convert_round_trip_is_bitwise():
    from distributed_tensorflow_tpu_torch.convert import (
        gpt_params_from_numpy,
        gpt_params_to_numpy,
    )

    jp = jax_model().init(seed=1)  # the JAX NamedTuple goes in as it is
    tp = gpt_params_from_numpy(jp, device="cpu")
    back = gpt_params_to_numpy(tp)
    ref = jp._asdict()
    for k in ("embed", "pos", "lnf_scale", "lnf_bias"):
        a, b = np.asarray(ref[k]), back[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for k, a in jp.blocks._asdict().items():
        a = np.asarray(a)
        assert a.dtype == back["blocks"][k].dtype, k
        assert a.tobytes() == back["blocks"][k].tobytes(), k


def test_convert_dtype_and_dict_input():
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy

    tree = numpy_params(jax_model(), seed=3)
    tp = gpt_params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert tp.blocks.wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp.embed.float().numpy(),
        torch.from_numpy(tree["embed"]).bfloat16().float().numpy(),
    )


@pytest.mark.parametrize(
    "make",
    ["init", "empty_slot_cache", "convert", "server"],
)
def test_entry_points_refuse_cpu_without_asking(make, monkeypatch):
    """Without CUDA and without device="cpu", every entry point raises —
    nothing falls back to the CPU silently."""
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy
    from distributed_tensorflow_tpu_torch.serve import TextServer

    model = torch_model()
    params = model.init(seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init": lambda: model.init(seed=0),
        "empty_slot_cache": lambda: model.empty_slot_cache(2),
        "convert": lambda: gpt_params_from_numpy(
            numpy_params(jax_model(), 0)
        ),
        "server": lambda: TextServer(model, params, slots=2),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[make]()


def _port_files():
    pkg = os.path.join(REPO, "distributed_tensorflow_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 67
    # The observability slice's modules are among the files walked.
    rel = {os.path.relpath(f, os.path.join(REPO, "distributed_tensorflow_tpu_torch"))
           for f in files}
    assert {f"observability/{m}.py" for m in ("__init__", "tracing", "journal", "metrics",
                                               "spans", "format", "exporter", "aggregate")} <= rel
    assert {"train/failpoints.py", "utils/summary.py", "utils/profiler.py",
            "utils/sync.py", "utils/logging.py"} <= rel
    # The checkpoint slice's modules too; none imports orbax either.
    assert {"train/resilience.py", "train/supervisor.py", "runtime/__init__.py",
            "runtime/native.py", "examples/resilient.py", "examples/legacy_dist.py"} <= rel
    for path in files:
        with open(path) as f:
            source = f.read()
        tree = ast.parse(source, path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "distributed_tensorflow_tpu", "orbax"), (
                    f"{os.path.relpath(path, REPO)} imports {name}"
                )
        # Nothing loads the JAX package's native runtime.
        assert "libdtf_runtime" not in source, os.path.relpath(path, REPO)


def test_crc_library_builds_from_the_port_source_into_ops_build(tmp_path, monkeypatch):
    """The host CRC32C library builds from ``runtime/csrc/dtf_crc32c.cc``
    (the host C++ compiler, no nvcc) into ``ops/build/``, named by the
    source's hash, and serves the CRCs here: ``backend()`` is
    ``"native"``. A fresh build into an empty directory gives the same
    library file name, and the bodies agree on a known value."""
    import ctypes

    from distributed_tensorflow_tpu_torch.runtime import native

    assert native.backend() == "native"
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "distributed_tensorflow_tpu_torch", "ops",
                                                 "build")
    assert os.path.basename(path).startswith("libdtf_crc32c-") and os.path.isfile(path)
    assert native.SOURCE == os.path.join(REPO, "distributed_tensorflow_tpu_torch", "runtime",
                                         "csrc", "dtf_crc32c.cc")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    fresh = native.library_path()
    native._build(fresh)
    assert os.path.basename(fresh) == os.path.basename(path)
    lib = ctypes.CDLL(fresh)
    native._bind(lib)
    assert lib.dtf_crc32c(b"123456789", 9) == 0xE3069283
    assert native.crc32c(b"123456789") == 0xE3069283
    assert set(native.crc32c_bodies(b"123456789").values()) == {0xE3069283}


def test_kernel_wrappers_have_no_fallback():
    """A CUDA tensor launches the kernel or raises: no ``try`` in the
    kernel modules could drop it to the plain version."""
    ops = os.path.join(REPO, "distributed_tensorflow_tpu_torch", "ops")
    for fn in ("_build.py", "flash_attention.py", "fused_decode.py", "fused_mlp.py"):
        with open(os.path.join(ops, fn)) as f:
            tree = ast.parse(f.read(), fn)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from distributed_tensorflow_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert "flash_fwd" not in _build._LIBS
    assert not (tmp_path / "build").exists()
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "flash_fwd")


def test_byte_tokenizer_matches_reference():
    from distributed_tensorflow_tpu.data.text import ByteTokenizer as JTok
    from distributed_tensorflow_tpu_torch.data.text import ByteTokenizer

    tok, ref = ByteTokenizer(), JTok()
    for text in ("hello", "ünïcode ✓", ""):
        np.testing.assert_array_equal(tok.encode(text, eos=True), ref.encode(text, eos=True))
        assert tok.decode(tok.encode(text)) == text
    ids = np.array([104, 105, 256, 300, -1], np.int32)
    assert tok.decode(ids) == ref.decode(ids) == "hi"
    assert (tok.eos_id, tok.vocab_size) == (ref.eos_id, ref.vocab_size)
