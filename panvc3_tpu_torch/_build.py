"""Build-once helper shared by the native extension and the CUDA kernels.

Each artefact is built into ``build_root()/<kind>/<digest>/``, where the
digest covers its sources and flags, so an edited source rebuilds and an
unchanged one is reused.  The build runs in a temporary directory that is
renamed into place, under an exclusive file lock: concurrent test workers
build once and never see a half-written library.  A failed build raises.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Callable, Iterable

from . import build_root


def digest(paths: Iterable[pathlib.Path], flags: Iterable[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def build_once(
    kind: str,
    key: str,
    filename: str,
    build: Callable[[pathlib.Path, pathlib.Path], None],
) -> pathlib.Path:
    """Path of ``filename`` built by ``build(out_path, work_dir)``."""
    base = build_root() / kind
    final = base / key / filename
    if final.exists():
        return final
    base.mkdir(parents=True, exist_ok=True)
    with open(base / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if final.exists():  # another process built it while we waited
            return final
        work = pathlib.Path(tempfile.mkdtemp(prefix=".tmp-", dir=base))
        try:
            build(work / filename, work)
            os.replace(work, base / key)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return final


def run_compiler(cmd: list[str], what: str) -> str:
    """Run one compiler command; its combined output on success, a
    RuntimeError carrying that output on failure."""
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, check=False
        )
    except FileNotFoundError as exc:
        raise RuntimeError(f"building {what}: {exc}") from exc
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {what} failed (exit {proc.returncode}):\n"
            + " ".join(cmd) + "\n" + out
        )
    return out
