"""ctypes bindings of the port's host runtime (``csrc/dtf_crc32c.cc``).

Counterpart of the CRC half of ``distributed_tensorflow_tpu/runtime/
native.py`` (``crc32c`` :422, ``crc32c_buffer`` :426, ``crc32c_masked``
:438). The library is the port's own: built at first use by the host C++
compiler (``c++ -O3 -shared -fPIC``, no CUDA) into ``ops/build/``, named by
a hash of the source and the flags as ``ops/_build.py`` names the kernels,
so an edited source is rebuilt and an unchanged one reused. It is loaded
from there and from nowhere else.

When the library cannot be built or loaded (no compiler, or
``DTF_NO_NATIVE`` set), :func:`load_library` raises ``ImportError`` and the
callers take the pure-Python table of ``utils/summary.py``, as the JAX
package's do (``resilience.py:69-107``); both give the same value.
:func:`backend` says which one serves. The heartbeat and the BPE fast
path of the JAX runtime are not here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(CSRC, "dtf_crc32c.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "ops", "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed: str | None = None


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdtf_crc32c-{h.hexdigest()[:16]}.so")


def _compiler() -> str | None:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def _build(out: str) -> None:
    cxx = _compiler()
    if cxx is None:
        raise ImportError("no host C++ compiler (c++, g++ or clang++) to build the CRC library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0:
        raise ImportError(f"building {os.path.basename(out)} failed "
                          f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("dtf_crc32c", "dtf_crc32c_masked", "dtf_crc32c_bytewise",
                 "dtf_crc32c_slice8", "dtf_crc32c_hw"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        fn.restype = ctypes.c_uint32
    lib.dtf_crc32c_hw_available.argtypes = []
    lib.dtf_crc32c_hw_available.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """The loaded library, built first when it is missing. Raises
    ``ImportError`` when it is disabled (``DTF_NO_NATIVE``), cannot be
    built or cannot be loaded; a failure is remembered, so the build is
    tried once a process."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("DTF_NO_NATIVE"):
            raise ImportError("the native runtime is disabled by DTF_NO_NATIVE")
        if _failed is not None:
            raise ImportError(_failed)
        try:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            _bind(lib)
        except (ImportError, OSError, AttributeError, subprocess.SubprocessError) as exc:
            _failed = f"the CRC library is unavailable: {exc}"
            raise ImportError(_failed) from exc
        _lib = lib
        return lib


def backend() -> str:
    """``"native"`` when the library serves the CRCs, else ``"python"``
    (the pure table)."""
    try:
        load_library()
    except ImportError:
        return "python"
    return "native"


def _view(data) -> tuple[ctypes.c_void_p | bytes, int, object]:
    """(pointer, length, keep-alive) of a bytes-like object or a contiguous
    numpy array / CPU tensor, read in place."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data) if not isinstance(data, bytes) else data
        return ctypes.c_char_p(buf), len(buf), buf
    if hasattr(data, "data_ptr"):  # a CPU tensor
        if data.device.type != "cpu" or not data.is_contiguous():
            raise ValueError("crc32c_buffer needs a contiguous CPU tensor")
        return ctypes.c_void_p(data.data_ptr()), data.numel() * data.element_size(), data
    a = np.asarray(data)
    if not a.flags.c_contiguous:
        raise ValueError("crc32c_buffer needs a C-contiguous array (no copy is made)")
    return ctypes.c_void_p(a.ctypes.data), a.nbytes, a


def crc32c(data: bytes) -> int:
    """CRC32C of a byte string."""
    ptr, n, _keep = _view(data)
    return int(load_library().dtf_crc32c(ptr, n))


def crc32c_buffer(a) -> int:
    """CRC32C over the buffer of a C-contiguous numpy array or CPU tensor,
    read in place (no ``tobytes`` copy). Equals ``crc32c(a.tobytes())``."""
    ptr, n, _keep = _view(a)
    return int(load_library().dtf_crc32c(ptr, n))


def crc32c_masked(data: bytes) -> int:
    """TFRecord-masked CRC32C (rotate right 15, plus a constant)."""
    ptr, n, _keep = _view(data)
    return int(load_library().dtf_crc32c_masked(ptr, n))


def crc32c_bodies(data) -> dict:
    """The library's bodies on ``data`` by name (the byte table, slicing-
    by-8 and, where the CPU has it, the crc32 instruction), for tests that
    hold them equal."""
    lib = load_library()
    ptr, n, _keep = _view(data)
    out = {"bytewise": int(lib.dtf_crc32c_bytewise(ptr, n)),
           "slice8": int(lib.dtf_crc32c_slice8(ptr, n))}
    if lib.dtf_crc32c_hw_available():
        out["hw"] = int(lib.dtf_crc32c_hw(ptr, n))
    return out
