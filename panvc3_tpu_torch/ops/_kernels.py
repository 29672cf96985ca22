"""Build and bind the hand-written CUDA kernels of ``ops/csrc``.

Each ``.cu`` file exposes a plain C function.  It is compiled by ``nvcc``
for ``sm_90a`` into ``build/panvc3_tpu_torch/kernels/`` at first use and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
A missing ``nvcc`` or a failed build raises: nothing is replaced by the
plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import threading

from .._build import build_once, digest, run_compiler

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills, shared memory) of each kernel built in
#: this process, by source name
BUILD_LOG: dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> (source, argtypes)
_SIGNATURES = {
    "realign_fused_int": (
        "realign_fused.cu",
        [_P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    ),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _load_source(source: str) -> ctypes.CDLL:
    src = CSRC / source
    nvcc = nvcc_path()
    key = digest([src], NVCC_FLAGS)
    stem = source.rsplit(".", 1)[0]

    def build(out: pathlib.Path, work: pathlib.Path) -> None:
        log = run_compiler(
            [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)], f"CUDA kernel {source}"
        )
        (work / "ptxas.txt").write_text(log)

    so = build_once("kernels", key, f"lib{stem}.so", build)
    log = so.parent / "ptxas.txt"
    BUILD_LOG[source] = log.read_text() if log.exists() else ""
    return ctypes.CDLL(str(so))


def kernel(name: str):
    """The bound C entry point ``name`` (its source built on first use)."""
    with _lock:
        source, argtypes = _SIGNATURES[name]
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = _load_source(source)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
