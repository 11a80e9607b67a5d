"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o lib<stem>-<digest>.so csrc/<stem>.cu

The libraries go to ``src/repro_torch/kernels/_build/`` (listed in
``.gitignore``) at first use.  One ``nvcc`` runs per source, all started
together.  ``<digest>`` hashes the flags and every file under ``csrc/``,
so an edited source is rebuilt and an unchanged one is reused.  The
compiler's output (``-Xptxas=-v``: registers, shared memory, spills) is
kept beside each library as ``<stem>-<digest>.log``.

If ``nvcc`` is missing or fails, :func:`library` raises: there is no
fallback.  The wrappers pass every pointer and the stream as
``c_void_p``, and each entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(stem: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel.

    Returns ``{stem: compiler output}`` for all sources (read from the
    kept logs for those already built).  Raises ``RuntimeError`` with
    the compiler's output when a build fails.
    """
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [s for s in stems if not _target(s, digest).exists()]
    procs = {}
    if todo:
        nvcc = _nvcc()
        for stem in todo:
            tmp = BUILD_DIR / f".tmp-{os.getpid()}-lib{stem}-{digest}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
    failed = []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{stem}-{digest}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"== nvcc {stem}.cu (exit {proc.returncode}) ==\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(stem, digest))  # atomic against other builders
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    logs = {}
    for stem in stems:
        log = BUILD_DIR / f"{stem}-{digest}.log"
        logs[stem] = log.read_text() if log.exists() else ""
    return logs


def library(stem: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use.

    ``signatures`` maps each C entry point to its ``argtypes``; every
    entry point returns an ``int`` CUDA error code.
    """
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(stem, _digest())))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sojourn_error_string.argtypes = [ctypes.c_int]
            lib.sojourn_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.sojourn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
