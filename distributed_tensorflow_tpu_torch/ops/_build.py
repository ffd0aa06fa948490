"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` (and each build of ``VARIANTS``: a source with
flags of its own) is compiled on first use by ``nvcc`` into a
shared library with a plain C interface (``extern "C"`` launchers that
return ``cudaGetLastError()``), loaded through ``ctypes``. No PyTorch
headers are included, so a build takes seconds. Libraries land in
``ops/build/`` (ignored by git), named by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them (each in a thread of its own, so each build's end is timed);
a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("flash_fwd", "flash_bwd", "fused_decode", "fused_decode_f32", "fused_mlp")
# Libraries built from another source with flags of their own: module name
# -> (source, extra nvcc flags). The cooperative decode kernels in f32
# compute are a library of their own, so the two compute dtypes' builds
# run side by side.
VARIANTS = {"fused_decode_f32": ("fused_decode", ("-DDECODE_F32",))}
# Probe builds: module name -> (source, extra nvcc flags). Only
# chip_smoke.py builds them (the MLP and cooperative decode kernels' phase
# stamps, the decode kernels' barrier probe); no code of the package loads
# one unless asked to (``fused_decode.LIBRARIES``).
PROBES = {
    "fused_mlp_probe": ("fused_mlp", ("-DMLP_PROBE",)),
    "fused_mlp_v1_probe": ("fused_mlp_v1", ("-DMLP_PROBE",)),
    "fused_decode_probe": ("fused_decode", ("-DDECODE_PROBE",)),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# Launch counts per kernel wrapper: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels it went
# through (chip_smoke.py zeroes them before driving each path). The flash
# wrappers also count their launches with a ring offset under
# "<kernel>[offset]" (those launches are in the kernel's own count too).
LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_fwd[offset]": 0, "flash_bwd_fused[offset]": 0, "flash_bwd_dq[offset]": 0,
    "flash_bwd_dkv[offset]": 0,
    "decode_block_slab": 0, "decode_token_slab": 0,
    "decode_block_paged": 0, "decode_token_paged": 0, "verify_tokens_paged": 0,
    "fused_mlp_step": 0, "fused_mlp_epoch": 0, "fused_mlp_epoch_dp": 0,
}
# ptxas's register/shared-memory report of each build (kept beside the
# library as ``<lib>.log``, so a reused library still has one).
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


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    return PROBES.get(name) or VARIANTS.get(name, (name, ()))


def _lib_path(name: str) -> str:
    src, flags = _source(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cuh", ".h")) or fn == f"{src}.cu":
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        if os.path.exists(f"{out}.log"):  # the report of the build that made it
            with open(f"{out}.log") as f:
                BUILD_LOGS.setdefault(name, f.read())
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    src, flags = _source(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, os.path.join(CSRC, f"{src}.cu")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, cmd


def _finish(name: str, started, log: str) -> None:
    proc, tmp, out, cmd = started
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no current library, one
    ``nvcc`` process each, all started before any is waited on (a thread
    each drains its output). Returns the seconds from the start to each
    build's end (the builds that ran)."""
    t0 = time.perf_counter()
    started = {n: s for n in names if (s := _start(n)) is not None}
    logs: dict[str, str] = {}
    ends: dict[str, float] = {}

    def wait(n, proc):
        logs[n] = proc.communicate()[0]
        ends[n] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(n, s[0])) for n, s in started.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n, s in started.items():
        _finish(n, s, logs[n])
    return ends


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
