"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a
shared library with a plain C interface (``extern "C"`` launchers that
return ``cudaGetLastError()``), loaded through ``ctypes``. No PyTorch
headers are included, so a build takes seconds. Libraries land in
``ops/build/`` (ignored by git), named by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("flash_fwd", "fused_decode", "fused_mlp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# Launch counts per kernel wrapper: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels it went
# through (chip_smoke.py zeroes them before driving each path).
LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "decode_block_slab": 0, "decode_token_slab": 0,
    "fused_mlp_step": 0, "fused_mlp_epoch": 0,
}
# ptxas's register/shared-memory report of each build, for the smoke log.
BUILD_LOGS: dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels of "
            "distributed_tensorflow_tpu_torch are built from source at first use"
        )
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cuh", ".h")) or fn == f"{name}.cu":
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, cmd


def _finish(name: str, started) -> None:
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def build_all(names=SOURCES) -> None:
    """Compile every named source that has no current library, one
    ``nvcc`` process each, all started before any is waited on."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")
