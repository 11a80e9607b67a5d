"""Build the CUDA sources of every kernel package with ``nvcc`` and load
them with ``ctypes``.

Each package under ``repro_torch/kernels/`` that has kernels keeps them in
its own ``csrc/`` (listed in :data:`PACKAGES`).  Every ``csrc/*.cu``
becomes its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o lib<stem>-<digest>.so <package>/csrc/<stem>.cu

Headers that several packages include (the Hopper pieces,
``hopper.cuh``) live in ``repro_torch/kernels/csrc/`` (:data:`SHARED`),
and a source includes them by a relative path (``../../csrc/hopper.cuh``).

The libraries go to ``src/repro_torch/kernels/_build/`` (listed in
``.gitignore``) at first use.  One ``nvcc`` runs per source, all started
together, across packages.  ``<digest>`` hashes the flags, every file of
the package's ``csrc/`` and every file of the shared ``csrc/``, so an
edited source or shared header is rebuilt and an unchanged one is
reused.  The compiler's output (``-Xptxas=-v``:
registers, shared memory, spills) is kept beside each library as
``<stem>-<digest>.log``.  Stems are unique across packages.

If ``nvcc`` is missing or fails, :func:`library` raises: there is no
fallback.  The wrappers pass every pointer and the stream as
``c_void_p``; each entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception through the library's
``kernel_error_string``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "PACKAGES", "SHARED", "build_all", "library", "check"]

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS / "_build"
#: Kernel packages whose ``csrc/*.cu`` are built.
PACKAGES = ("sojourn_eval", "flash_attention", "ssd_scan", "moe_gemm")
#: Headers shared by the packages' sources, relative to the kernels directory.
SHARED = "csrc"
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


def _csrc(package: str, root: Path = KERNELS) -> Path:
    return root / package / "csrc"


def _digest(package: str, root: Path = KERNELS) -> str:
    """The flags, and every file of the package's ``csrc/`` and of the
    shared one, under the kernels directory ``root``."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for prefix, directory in (("", _csrc(package, root)), ("shared/", root / SHARED)):
        for path in sorted(directory.iterdir()):
            h.update(f"{prefix}{path.name}".encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _sources() -> dict[str, tuple[Path, str]]:
    """``{stem: (source, digest)}`` for every ``.cu`` of every package."""
    out = {}
    for package in PACKAGES:
        digest = _digest(package)
        for src in sorted(_csrc(package).glob("*.cu")):
            if src.stem in out:
                raise RuntimeError(f"two kernel sources are named {src.stem}.cu")
            out[src.stem] = (src, digest)
    return out


def _target(stem: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` of every package that is not built yet,
    in parallel.

    Returns ``{stem: compiler output}`` for all sources (read from the
    kept logs for those already built).  Raises ``RuntimeError`` with
    the compiler's output when a build fails.
    """
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s, (_, d) in sources.items() if not _target(s, d).exists()]
    procs = {}
    if todo:
        nvcc = _nvcc()
        for stem in todo:
            src, digest = sources[stem]
            tmp = BUILD_DIR / f".tmp-{os.getpid()}-lib{stem}-{digest}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
    failed = []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        digest = sources[stem][1]
        (BUILD_DIR / f"{stem}-{digest}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"== nvcc {stem}.cu (exit {proc.returncode}) ==\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(stem, digest))  # atomic against other builders
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    logs = {}
    for stem, (_, digest) in sources.items():
        log = BUILD_DIR / f"{stem}-{digest}.log"
        logs[stem] = log.read_text() if log.exists() else ""
    return logs


def library(stem: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``<package>/csrc/<stem>.cu``, built on first use.

    ``signatures`` maps each C entry point to its ``argtypes``; every
    entry point returns an ``int`` CUDA error code.
    """
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            sources = _sources()
            if stem not in sources:
                raise ValueError(f"no kernel source {stem}.cu in {PACKAGES}")
            lib = ctypes.CDLL(str(_target(stem, sources[stem][1])))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
