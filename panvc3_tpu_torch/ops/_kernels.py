"""Build, bind and launch the hand-written CUDA kernels of ``ops/csrc``.

Each ``.cu`` file exposes plain C entry points.  A file is compiled by
``nvcc`` for ``sm_90a`` into ``build_root()/kernels/`` at first use (the
checkout's ``build/``, or the user's cache in an install) and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds);
``build_all`` compiles every file at once, one ``nvcc`` each.
A missing ``nvcc``, a failed build or a refused launch raises: nothing is
replaced by the plain PyTorch version.

``launch`` is the one place a kernel is started: it calls the entry,
raises on its error code and adds one to ``LAUNCHES[name]``, the main
path's evidence that it went through that kernel.
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
_source_locks: dict[str, threading.Lock] = {}
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
        [_P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P],
    ),
    "realign_fused_qual": (
        "realign_fused.cu",
        [_P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P],
    ),
    "realign_fused_sub": (
        "realign_fused.cu",
        [_P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P],
    ),
    "realign_fill_sub": (
        "realign_fill.cu",
        [_P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P],
    ),
    "realign_traceback": (
        "realign_traceback.cu",
        [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    ),
}

#: launches of each C entry since the last ``reset_launches``
LAUNCHES = dict.fromkeys(_SIGNATURES, 0)

# C helpers that launch nothing (not counted): name -> (source, argtypes)
_HELPERS = {
    "realign_fused_scratch": ("realign_fused.cu", [_I, _I, _I]),
    "realign_fill_scratch": ("realign_fill.cu", [_I]),
    "realign_traceback_plan": ("realign_traceback.cu", [_I, _I, _I, _P]),
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


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        src_lock = _source_locks.setdefault(source, threading.Lock())
    with src_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = _load_source(source)
        return lib


def kernel(name: str):
    """The bound C entry point ``name`` (its source built on first use)."""
    source, argtypes = _SIGNATURES[name] if name in _SIGNATURES else _HELPERS[name]
    fn = getattr(_library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> None:
    """Build every source at once, one ``nvcc`` process each."""
    from concurrent.futures import ThreadPoolExecutor

    sources = sorted({src for src, _ in _SIGNATURES.values()})
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(_library, sources))


def launch(name: str, *args) -> None:
    """Call the C entry ``name`` (its last argument the stream), raise on a
    non-zero cudaError_t, and count the launch."""
    rc = kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
