"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ctypes. Builds
happen at first use, never at import, into ``build/kernels/`` beside the
package (listed in ``.gitignore``); a library's file name carries a hash
of its source, so an edited source is rebuilt. ``build_all`` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "build_all", "error_string", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> {function: (argtypes, restype)}
SOURCES = {
    "beam_update": {
        "tpuvec_beam_update": ([_P] * 10 + [_I] * 4 + [_P], _I),
        "tpuvec_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def _open(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every kernel source not yet built (one nvcc each, in
    parallel) and load them all. Raises with nvcc's output on failure."""
    with _lock:
        _BUILD.mkdir(parents=True, exist_ok=True)
        todo = {n: _target(n) for n in SOURCES if n not in _libs}
        procs = {}
        for name, path in todo.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
            )
        errors = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
            else:
                os.replace(tmp, todo[name])
        if errors:
            raise RuntimeError("\n".join(errors))
        for name, path in todo.items():
            _libs[name] = _open(name, path)
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return f"CUDA error {code}: {lib.tpuvec_cuda_error_string(code).decode()}"
