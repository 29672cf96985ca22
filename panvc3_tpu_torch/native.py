"""The C host extension (``native/*.c``), built at first use.

The port runs the same C parse/stage/finalize/splice code as
``panvc3_tpu``'s fast lane.  It compiles ``native/*.c`` with the flags of
``native/setup.py`` (``-ffp-contract=off`` included) and the interpreter's
own compiler settings, into ``build_root()/native/``, and loads the
library by file location.  In a checkout the sources are the shared
``native/``; an installed package compiles the copy that its wheel
carries in ``_native_src/`` (staged by ``setup.py``'s ``build_py`` step
through ``stage_sources``), on the machine that runs it.  It never
writes ``panvc3_tpu/native_build/`` (where ``panvc3_tpu``'s loader
looks), adds nothing to ``sys.path`` and leaves no ``_panvc3_native``
entry in ``sys.modules``.  A failed build raises.
"""

from __future__ import annotations

import importlib.util
import pathlib
import platform
import shlex
import shutil
import sys
import sysconfig
import threading
from concurrent.futures import ThreadPoolExecutor

from . import PACKAGE_DIR, checkout_root
from ._build import build_once, digest, run_compiler

SOURCES = ("panvc3_native.c", "fastpath.c", "bgzf.c", "csr.c", "als.c")
HEADERS = ("panvc3_common.h",)
#: where an installed package keeps its copy of the sources
STAGED_DIR = PACKAGE_DIR / "_native_src"
_CHECKOUT = checkout_root()
NATIVE_DIR = STAGED_DIR if _CHECKOUT is None else _CHECKOUT / "native"
# native/setup.py: extra_compile_args, extra_link_args, libraries
EXTRA_COMPILE_ARGS = ("-O3", "-march=native", "-pthread", "-ffp-contract=off")
EXTRA_LINK_ARGS = ("-pthread",)
LIBRARIES = ("z",)
MODULE_NAME = "_panvc3_native"

_lock = threading.Lock()
_native = None


def stage_sources(src: pathlib.Path, dst: pathlib.Path) -> None:
    """Copy the C sources and headers from ``src`` (a checkout's
    ``native/``) to ``dst`` (``_native_src`` inside a built package)."""
    dst.mkdir(parents=True, exist_ok=True)
    for name in SOURCES + HEADERS:
        shutil.copyfile(src / name, dst / name)


def _commands(out: pathlib.Path, work: pathlib.Path):
    cv = sysconfig.get_config_var
    cc = shlex.split(cv("CC") or "cc")
    cflags = shlex.split(cv("CFLAGS") or "") + shlex.split(cv("CCSHARED") or "")
    include = sysconfig.get_paths()["include"]
    compiles = []
    objs = []
    for src in SOURCES:
        obj = work / (src[:-2] + ".o")
        objs.append(str(obj))
        compiles.append(
            cc + cflags + [f"-I{include}", *EXTRA_COMPILE_ARGS,
                           "-c", str(NATIVE_DIR / src), "-o", str(obj)]
        )
    ldshared = shlex.split(cv("LDSHARED") or "cc -shared")
    link = (
        ldshared + shlex.split(cv("LDFLAGS") or "") + objs
        + [f"-l{lib}" for lib in LIBRARIES] + list(EXTRA_LINK_ARGS)
        + ["-o", str(out)]
    )
    return compiles, link


def _build(out: pathlib.Path, work: pathlib.Path) -> None:
    compiles, link = _commands(out, work)
    with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
        for fut in [
            pool.submit(run_compiler, cmd, "the native extension")
            for cmd in compiles
        ]:
            fut.result()
    run_compiler(link, "the native extension")


def cpu_id() -> str:
    """The host CPU's model and feature flags (Linux), else its machine
    type."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine()
    keep = [ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))) or platform.machine()


def library_path() -> pathlib.Path:
    """Path of the built extension, building it first if needed."""
    missing = [s for s in SOURCES + HEADERS if not (NATIVE_DIR / s).exists()]
    if missing:
        raise RuntimeError(f"native sources missing under {NATIVE_DIR}: {missing}")
    probe_cmds, probe_link = _commands(pathlib.Path("x"), pathlib.Path("w"))
    # -march=native: a build is only valid on the CPU it was made for
    key = digest(
        [NATIVE_DIR / s for s in SOURCES + HEADERS],
        probe_cmds[0] + probe_link[:1] + [cpu_id()],
    )
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return build_once("native", key, MODULE_NAME + suffix, _build)


def get_native():
    """The loaded C extension module (built on first call)."""
    global _native
    with _lock:
        if _native is None:
            path = library_path()
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
            # a single-phase-init extension registers itself in sys.modules
            # while it loads; put back whatever was there before (possibly
            # panvc3_tpu's own build of the same module)
            prior = sys.modules.get(MODULE_NAME)
            try:
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            finally:
                if prior is None:
                    sys.modules.pop(MODULE_NAME, None)
                else:
                    sys.modules[MODULE_NAME] = prior
            _native = mod
        return _native
