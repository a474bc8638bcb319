"""The port's tvstore bindings (tpuvec_torch/native.py) vs the JAX
package's (tpuvec/native).

Both load a library built from the same ``csrc/tvstore.cpp``; the port
compiles its own into ``build/native/``. Held here: every dtype of the
code table round-trips (0-d and empty arrays too), a file written by one
package's writer reads back equal through the other's reader and is the
same bytes, corruption of a section or of the directory raises
``OSError`` (never a crash), and ``abort`` leaves no file.
"""

import ctypes
import ctypes.util
import gc
import os
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from tpuvec import native as jax_native  # noqa: E402
from tpuvec_torch import native  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ unavailable: the tvstore library cannot be built"
)

REPO = Path(__file__).resolve().parent.parent


def _trim_heap():
    gc.collect()
    ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Hand freed heap back to the OS before and after this module, and
    drop whatever JAX compiled for it."""
    _trim_heap()
    yield
    jax.clear_caches()
    _trim_heap()


def _arrays_of(dtype: np.dtype) -> dict[str, np.ndarray]:
    """A 2-D, a 0-d and an empty array of ``dtype``, seeded."""
    rng = np.random.default_rng(3)
    if dtype == np.bool_:
        full = rng.integers(0, 2, (9, 5)).astype(bool)
    elif dtype.kind == "f":
        full = rng.standard_normal((9, 5)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        full = rng.integers(info.min, info.max, (9, 5), dtype=dtype, endpoint=True)
    return {"full": full, "scalar": full[2, 3].reshape(()), "empty": full[:0, :3]}


def _write(writer_cls, path, arrays):
    w = writer_cls(str(path))
    for name, arr in arrays.items():
        w.add(name, arr)
    w.finish()


def _read(reader_cls, path):
    r = reader_cls(str(path))
    try:
        return r.keys(), r.read_all()
    finally:
        r.close()


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        assert got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_builds_into_the_build_directory():
    """The library is the port's own build of csrc/tvstore.cpp, named by
    the source's hash, under build/native/."""
    assert native.available()
    target = native._target()
    assert target.parent == REPO / "build" / "native"
    assert target.name.startswith("libtvstore-") and target.exists()


@pytest.mark.parametrize("dtype", native._DTYPES, ids=str)
def test_roundtrip_every_dtype(tmp_path, dtype):
    arrays = _arrays_of(dtype)
    _write(native.TvsWriter, tmp_path / "t.tvs", arrays)
    keys, out = _read(native.TvsReader, tmp_path / "t.tvs")
    assert keys == list(arrays)
    _assert_same(out, arrays)
    assert all(a.flags.writeable and a.flags.owndata for a in out.values())


def test_dtype_codes_are_the_jax_packages():
    """The code a file stores for each dtype."""
    assert native._DTYPES == jax_native._DTYPES


@pytest.mark.parametrize("direction", ["port writes, JAX reads", "JAX writes, port reads"])
def test_files_cross_packages(tmp_path, direction):
    """One file per direction holding every dtype: it reads back equal
    through the other package's reader, and both writers write the same
    bytes."""
    arrays = {f"{dt}::{k}": v for dt in native._DTYPES for k, v in _arrays_of(dt).items()}
    port_first = direction.startswith("port")
    writer, reader = ((native.TvsWriter, jax_native.TvsReader) if port_first
                      else (jax_native.TvsWriter, native.TvsReader))
    _write(writer, tmp_path / "a.tvs", arrays)
    keys, out = _read(reader, tmp_path / "a.tvs")
    assert keys == list(arrays)
    _assert_same(out, arrays)
    other = jax_native.TvsWriter if port_first else native.TvsWriter
    _write(other, tmp_path / "b.tvs", arrays)
    assert (tmp_path / "a.tvs").read_bytes() == (tmp_path / "b.tvs").read_bytes()


def test_unsupported_dtype_raises(tmp_path):
    w = native.TvsWriter(str(tmp_path / "t.tvs"))
    for arr in (np.zeros(3, np.float16), np.zeros(3, np.complex64), np.zeros(3, ">f4")):
        with pytest.raises(TypeError, match="unsupported dtype"):
            w.add("a", arr)
    w.abort()


def test_abort_leaves_nothing(tmp_path):
    path = tmp_path / "t.tvs"
    w = native.TvsWriter(str(path))
    w.add("a", np.zeros(4, np.float32))
    w.abort()
    assert list(tmp_path.iterdir()) == []


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        native.TvsReader(str(tmp_path / "absent.tvs"))


# Offsets in the directory entry of a section named "a" (1 byte): u16
# name_len | name | u8 dtype | u8 ndim | u64 shape[1] | u64 byte_len |
# u64 offset | u32 crc
_ENTRY = {"name_len": (0, "<H"), "dtype": (3, "<B"), "ndim": (4, "<B"),
          "byte_len": (13, "<Q"), "offset": (21, "<Q")}

# field -> value written into it (the directory's CRC recomputed): each
# must fail with OSError when the file is opened or read
DIRECTORY_CORRUPTIONS = {
    "name_len past the end": ("name_len", 0xFFFF),
    "ndim over 8": ("ndim", 9),
    "ndim 8 past the end": ("ndim", 8),
    "ndim 0 (shape disagrees with byte_len)": ("ndim", 0),
    "byte_len past the file": ("byte_len", 1 << 40),
    "byte_len short of the shape": ("byte_len", 8),
    "offset past the file": ("offset", 1 << 40),
    "dtype code outside the table": ("dtype", 200),
}


@pytest.fixture
def small_file(tmp_path):
    """A file of one float32 section "a" of 16 values: (path, its bytes,
    the directory offset)."""
    path = tmp_path / "t.tvs"
    _write(native.TvsWriter, path, {"a": np.arange(16, dtype=np.float32)})
    raw = bytearray(path.read_bytes())
    return path, raw, struct.unpack_from("<Q", raw, 16)[0]


def _expect_oserror(path, match=None):
    """Opening and reading ``path`` raises OSError."""
    with pytest.raises(OSError, match=match):
        r = native.TvsReader(str(path))
        try:
            r.read_all()
        finally:
            r.close()


@pytest.mark.parametrize("case", list(DIRECTORY_CORRUPTIONS))
def test_corrupt_directory_raises(small_file, case):
    path, raw, dir_off = small_file
    field, value = DIRECTORY_CORRUPTIONS[case]
    at, fmt = _ENTRY[field]
    struct.pack_into(fmt, raw, dir_off + at, value)
    struct.pack_into("<Q", raw, 24, zlib.crc32(bytes(raw[dir_off:])))
    path.write_bytes(bytes(raw))
    _expect_oserror(path)


def test_corrupt_payload_raises(small_file):
    path, raw, _ = small_file
    raw[80] ^= 0xFF  # a payload byte (the section starts at 64)
    path.write_bytes(bytes(raw))
    _expect_oserror(path, "CRC")
    # without verification the bytes come back as they are
    r = native.TvsReader(str(path), verify=False)
    assert r.read_all()["a"].shape == (16,)
    r.close()


@pytest.mark.parametrize("case", ["directory byte", "directory offset", "magic", "truncated"])
def test_corrupt_header_raises(small_file, case):
    path, raw, dir_off = small_file
    if case == "directory byte":
        raw[dir_off + 2] ^= 0xFF  # the name, CRC not recomputed
        match = "directory CRC"
    elif case == "directory offset":
        struct.pack_into("<Q", raw, 16, 1 << 40)
        match = "directory offset"
    elif case == "magic":
        raw[0:4] = b"XXXX"
        match = "magic"
    else:
        raw = raw[:20]
        match = "truncated"
    path.write_bytes(bytes(raw))
    _expect_oserror(path, match)


def test_unavailable_library_raises(monkeypatch, tmp_path):
    """Without the source (or g++) the library is unavailable and the
    writer and reader raise RuntimeError."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_SOURCE", tmp_path / "absent.cpp")
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.TvsWriter(str(tmp_path / "t.tvs"))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.TvsReader(str(tmp_path / "t.tvs"))


def test_concurrent_builds_end_whole(tmp_path):
    """Two processes building the same target at once (xdist workers, a
    follower beside its writer) each leave a whole, loadable library."""
    target = tmp_path / "libtvstore-test.so"
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "from pathlib import Path\n"
            "from tpuvec_torch import native\n"
            f"assert native._build(Path({str(target)!r}))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(tmp_path),
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    lib = ctypes.CDLL(str(target))
    assert lib.tvs_reader_open and sorted(os.listdir(tmp_path)) == [target.name]
