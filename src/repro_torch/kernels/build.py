"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  Every
source compiles to an object file in its own ``nvcc`` process, all started
together, then one link makes the library.  The build runs at first use in
a process, never at import, and goes into ``build/`` at the repository
root, named by a hash of the sources and flags so that a finished build is
reused and a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_log", "check",
           "count", "library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_void_p, _c_int, _c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_c_float = ctypes.c_float

# C entry points: name -> argtypes (every one returns cudaGetLastError(),
# but the sizes in _SIZES, which return an int64)
_SIGNATURES = {
    "quipt_bloom_probe": [_c_void_p, _c_void_p, _c_void_p, _c_int64,
                          _c_int, _c_int, _c_void_p],
    "quipt_bloom_probe_keys": [_c_void_p, _c_void_p, _c_void_p, _c_int64,
                               _c_int, _c_int, _c_void_p],
    "quipt_masked_distance": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                              _c_void_p, _c_int, _c_int, _c_int, _c_void_p],
    "quipt_masked_knn": [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
                         _c_int, _c_int, _c_int, _c_int, _c_void_p, _c_void_p,
                         _c_void_p, _c_void_p],
    "quipt_join_insert": [_c_void_p, _c_int64, _c_int, _c_void_p, _c_void_p,
                          _c_void_p, _c_void_p, _c_void_p],
    "quipt_join_place": [_c_void_p, _c_void_p, _c_void_p, _c_int64,
                         _c_void_p, _c_void_p, _c_void_p, _c_int64,
                         _c_void_p],
    "quipt_join_probe_words": [_c_int64],
    "quipt_join_emit_tile": [],
    "quipt_join_probe": [_c_void_p, _c_int64, _c_void_p, _c_void_p,
                         _c_void_p, _c_int64, _c_int, _c_void_p, _c_int64,
                         _c_void_p],
    "quipt_join_emit": [_c_void_p, _c_int64, _c_void_p, _c_int64,
                        _c_void_p, _c_void_p, _c_void_p],
    "quipt_neighbor_mean": [_c_void_p, _c_void_p, _c_int64, _c_int,
                            _c_void_p, _c_void_p],
    "quipt_neighbor_mode": [_c_void_p, _c_void_p, _c_int64, _c_int,
                            _c_void_p, _c_void_p],
    "quipt_noop": [_c_void_p],
    "quipt_segment_count": [_c_void_p, _c_int64, _c_int64, _c_int64,
                            _c_void_p, _c_void_p, _c_void_p, _c_void_p],
    "quipt_segment_scan": [_c_void_p, _c_int64, _c_int64, _c_void_p,
                           _c_void_p],
    "quipt_segment_place": [_c_void_p, _c_int64, _c_int64, _c_int64,
                            _c_void_p, _c_void_p, _c_void_p, _c_int64,
                            _c_int64, _c_void_p],
    "quipt_segment_reduce": [_c_void_p, _c_int, _c_int, _c_void_p, _c_void_p,
                             _c_void_p, _c_int64, _c_int64, _c_int64,
                             _c_void_p, _c_void_p, _c_void_p, _c_void_p],
    "quipt_flash_attention": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                              _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                              _c_int, _c_int, _c_float, _c_void_p],
    "quipt_flash_attention_tc": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                                 _c_int, _c_int, _c_int, _c_int, _c_int,
                                 _c_int, _c_int, _c_float, _c_void_p],
}
_SIZES = {"quipt_join_probe_words"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log: List[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed"
    )


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _compile(target: Path, sources: List[Path]) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            (src, _run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]))
            for src, obj in zip(sources, objs)
        ]
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            _log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(_log)
            )
        staged = Path(tmp) / target.name
        link = _run([nvcc, "-shared", *NVCC_FLAGS[:2],
                     *(str(o) for o in objs), "-o", str(staged)])
        out, _ = link.communicate()
        _log.append(f"== link (rc {link.returncode})\n{out}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + out)
        os.replace(staged, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        target = BUILD_DIR / f"libquipt_kernels-{_digest(sources)}.so"
        if not target.exists():
            t0 = time.perf_counter()
            _compile(target, sources)
            _log.append(f"built {target.name} from "
                        f"{[s.name for s in sources]} in "
                        f"{time.perf_counter() - t0:.2f}s")
        else:
            _log.append(f"reused {target.name}")
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _c_int64 if name in _SIZES else _c_int
        _lib = lib
        return lib


def build_log() -> str:
    """Compiler output of this process's build (register and shared-memory
    use per kernel from ``-Xptxas -v``)."""
    return "\n".join(_log)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a non-zero ``cudaGetLastError``."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


_count_lock = threading.Lock()


def count(counters: dict, name: str) -> None:
    """Add one to the launch counter ``counters[name]`` (a wrapper's module
    ``globals()`` or a dict of routes) under one lock: the service's worker
    threads launch at once, and a bare ``+= 1`` is not atomic."""
    with _count_lock:
        counters[name] += 1
