"""Build and load the Hopper kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
cached in ``build/`` beside this file under a hash of the sources and flags,
so a checkout builds once.  Each C entry returns ``cudaGetLastError()``;
:func:`check` raises when it is not 0 (a refused launch never runs, and a
later synchronise would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if path is None and (home / "bin" / "nvcc").exists():
        path = str(home / "bin" / "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the Hopper kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(so: Path) -> None:
    """Build ``so``; nvcc's and ptxas's report goes beside it (``.log``)."""
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = work / so.name
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *[str(o) for _, o, _ in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)                 # atomic: a reader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    (BUILD_DIR / (so.stem + ".log")).write_text("\n".join(log))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
            if not so.exists():
                _compile(so)
            _lib = ctypes.CDLL(str(so))
            _lib.repro_error_string.argtypes = [ctypes.c_int]
            _lib.repro_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry ``name`` with its ctypes signature: ``c_void_p`` for every
    pointer and the stream, so no pointer is cut to 32 bits."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
