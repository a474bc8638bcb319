"""Bindings to the native snapshot engine ``csrc/tvstore.cpp``, loaded
with ctypes: the port's own copy of the JAX package's ``native``
bindings, with the same API and the same files.

tvstore writes single-file columnar snapshots of named n-d arrays
atomically (a ``.tmp`` file, fsync, rename) and reads them back through
mmap with a CRC32 per section. The library is compiled from the repo's
``csrc/tvstore.cpp`` with ``g++`` at first use, never at import, into
``build/native/libtvstore-<source hash>.so`` beside the package (listed in
``.gitignore``), with the flags of ``csrc/Makefile``. Each build writes a
temporary name and then renames it, so processes that build at the same
moment each end with a whole library. Every caller handles
``available() == False``; ``store.snapshot`` then writes npz.

Where the port differs: ``TvsReader.read_all`` copies each section once,
straight into a writable numpy array (the JAX package copies twice, into
``bytes`` and then a read-only array), and a section whose dtype code or
byte length disagrees with its directory entry raises ``OSError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "TvsWriter", "TvsReader"]

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tvstore.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "native"
# csrc/Makefile's CXXFLAGS
_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]

_lock = threading.Lock()
_lib = None
_tried = False

# dtype codes shared with the C++ side, in the JAX package's order: the
# code is what the file stores
_DTYPES = [
    np.dtype("float32"),
    np.dtype("float64"),
    np.dtype("int8"),
    np.dtype("int16"),
    np.dtype("int32"),
    np.dtype("int64"),
    np.dtype("uint8"),
    np.dtype("uint16"),
    np.dtype("uint32"),
    np.dtype("uint64"),
    np.dtype("bool"),
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

_P, _U8, _U64 = ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint64
# C signatures: function -> (argtypes, restype)
_SIGNATURES = {
    "tvs_last_error": ([], ctypes.c_char_p),
    "tvs_writer_open": ([ctypes.c_char_p], _P),
    "tvs_writer_add": (
        [_P, ctypes.c_char_p, _U8, _U8, ctypes.POINTER(_U64), _P, _U64], ctypes.c_int
    ),
    "tvs_writer_finish": ([_P], ctypes.c_int),
    "tvs_writer_abort": ([_P], None),
    "tvs_reader_open": ([ctypes.c_char_p], _P),
    "tvs_reader_count": ([_P], _U64),
    "tvs_reader_info": (
        [_P, _U64, ctypes.c_char_p, _U64, ctypes.POINTER(_U8), ctypes.POINTER(_U8),
         ctypes.POINTER(_U64), ctypes.POINTER(_U64)],
        ctypes.c_int,
    ),
    "tvs_reader_data": ([_P, _U64, ctypes.c_int], _P),
    "tvs_reader_close": ([_P], None),
}


def _target() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    return _BUILD / f"libtvstore-{digest}.so"


def _build(target: Path) -> bool:
    """Compile the library into ``target``; False when g++ or the source
    is missing or the compile fails."""
    cxx = shutil.which("g++")
    if cxx is None or not _SOURCE.exists():
        return False
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(
            [cxx, *_CXX_FLAGS, "-shared", "-o", str(tmp), str(_SOURCE)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SOURCE.exists():
            return None
        target = _target()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        for fn, (argtypes, restype) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it on first call)."""
    return _load() is not None


def _error(lib) -> OSError:
    return OSError(lib.tvs_last_error().decode())


class TvsWriter:
    """Write named numpy arrays to a tvstore snapshot (atomic on finish)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tvstore library unavailable")
        self._lib = lib
        self._h = lib.tvs_writer_open(path.encode())
        if not self._h:
            raise _error(lib)

    def add(self, name: str, arr: np.ndarray) -> None:
        orig_shape = np.asarray(arr).shape  # ascontiguousarray promotes 0-d to 1-d
        arr = np.ascontiguousarray(arr)
        code = _DTYPE_CODE.get(arr.dtype)
        if code is None:
            raise TypeError(f"unsupported dtype {arr.dtype}")
        shape = (_U64 * max(len(orig_shape), 1))(*(orig_shape or (0,)))
        rc = self._lib.tvs_writer_add(
            self._h, name.encode(), code, len(orig_shape), shape,
            arr.ctypes.data_as(_P), arr.nbytes,
        )
        if rc != 0:
            raise _error(self._lib)

    def finish(self) -> None:
        rc = self._lib.tvs_writer_finish(self._h)
        self._h = None
        if rc != 0:
            raise _error(self._lib)

    def abort(self) -> None:
        if self._h:
            self._lib.tvs_writer_abort(self._h)
            self._h = None


class TvsReader:
    """Read a tvstore snapshot; arrays come back as writable copies of the
    mmap."""

    def __init__(self, path: str, verify: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tvstore library unavailable")
        self._lib = lib
        self._verify = 1 if verify else 0
        self._h = lib.tvs_reader_open(path.encode())
        if not self._h:
            raise _error(lib)

    def keys(self) -> list[str]:
        return [self._info(i)[0] for i in range(self._lib.tvs_reader_count(self._h))]

    def _info(self, i: int):
        name_buf = ctypes.create_string_buffer(512)
        dtype, ndim = _U8(), _U8()
        shape = (_U64 * 8)()
        blen = _U64()
        rc = self._lib.tvs_reader_info(
            self._h, i, name_buf, 512, ctypes.byref(dtype), ctypes.byref(ndim), shape,
            ctypes.byref(blen),
        )
        if rc != 0:
            raise _error(self._lib)
        name = name_buf.value.decode()
        if dtype.value >= len(_DTYPES):
            raise OSError(f"corrupt section {name}: dtype code {dtype.value}")
        dt = _DTYPES[dtype.value]
        shape_t = tuple(shape[j] for j in range(ndim.value))
        if math.prod(shape_t) * dt.itemsize != blen.value:
            raise OSError(
                f"corrupt section {name}: {blen.value} bytes for shape {shape_t} of {dt}"
            )
        return name, dt, shape_t, blen.value

    def read_all(self) -> dict[str, np.ndarray]:
        out = {}
        for i in range(self._lib.tvs_reader_count(self._h)):
            name, dt, shape, blen = self._info(i)
            ptr = self._lib.tvs_reader_data(self._h, i, self._verify)
            if not ptr:
                raise _error(self._lib)
            arr = np.empty(shape, dtype=dt)  # () is a 0-d scalar
            if blen:
                ctypes.memmove(arr.ctypes.data, ptr, blen)
            out[name] = arr
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tvs_reader_close(self._h)
            self._h = None
