"""The port's host modules under VecTable vs the JAX package's: the codec
(``Vector``, ``pack_bits``, ``unpack_bits``) on the cases of
tests/test_codec.py, the types' parsers, sizes and errors, the HNSW
presets, and the timing module (which ``insert_batch`` reports to).

Each case runs against both packages' modules and must give the same
value, or raise the error of the same name.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tpuvec.codec as jax_codec  # noqa: E402
import tpuvec.index.params as jax_params  # noqa: E402
import tpuvec.types as jax_types  # noqa: E402
import tpuvec_torch.codec as port_codec  # noqa: E402
import tpuvec_torch.index.params as port_params  # noqa: E402
import tpuvec_torch.types as port_types  # noqa: E402
from tpuvec_torch.index.build import build_graph, plan_batch_sizes  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.utils import timing  # noqa: E402

PACKAGES = {
    "jax": types.SimpleNamespace(c=jax_codec, t=jax_types, p=jax_params),
    "port": types.SimpleNamespace(c=port_codec, t=port_types, p=port_params),
}
BITS = (np.random.default_rng(0).random(77) > 0.5).astype(np.uint8)


def _f32(m):
    return m.t.VectorType.FLOAT32


def _i8(m):
    return m.t.VectorType.INT8


def _bit(m):
    return m.t.VectorType.BIT


# name -> case(m): the cases of tests/test_codec.py, each as a value
CASES = {
    "f32 blob little-endian": lambda m: m.c.Vector.from_f32([1.0, -2.5, 3.25]).data,
    "i8 blob": lambda m: m.c.Vector.from_i8([-128, 0, 127]).data,
    "bit blob lsb first": lambda m: m.c.Vector.from_bits([1, 0, 0, 0, 0, 0, 0, 0, 1]).data,
    "pack unpack round trip": lambda m: m.c.unpack_bits(m.c.pack_bits(BITS), 77),
    "f32 blob of 3 bytes": lambda m: m.c.Vector.from_blob(b"\x00\x00\x00", _f32(m)),
    "empty f32 blob": lambda m: m.c.Vector.from_blob(b"", _f32(m)),
    "f32 dims inferred": lambda m: m.c.Vector.from_blob(bytes(16), _f32(m)).dimensions,
    "i8 dims inferred": lambda m: m.c.Vector.from_blob(bytes(7), _i8(m)).dimensions,
    "bit dims inferred": lambda m: m.c.Vector.from_blob(bytes(2), _bit(m)).dimensions,
    "explicit dims mismatch": lambda m: m.c.Vector.from_blob(bytes(16), _f32(m), dimensions=3),
    "f32 json round trip": lambda m: m.c.Vector.from_json("[1.0, 2.5, -3.0]", _f32(m)).to_json(),
    "i8 from json": lambda m: m.c.Vector.from_json("[1, -2, 127]", _i8(m)).as_i8(),
    "bit from json": lambda m: m.c.Vector.from_json("[1, 0, 1, 1]", _bit(m)).as_bits(),
    "invalid json": lambda m: m.c.Vector.from_json("not json", _f32(m)),
    "non-array json": lambda m: m.c.Vector.from_json('{"a": 1}', _f32(m)),
    "empty json": lambda m: m.c.Vector.from_json("[]", _f32(m)),
    "sql text": lambda m: m.c.Vector.from_sql_value("[1.0, 2.0]", _f32(m)).data,
    "sql blob": lambda m: m.c.Vector.from_sql_value(bytes(8), _f32(m)).as_f32(),
    "sql int": lambda m: m.c.Vector.from_sql_value(42, _f32(m)),
    "sniff f32": lambda m: m.c.Vector.sniff_from_blob(bytes(8)).vec_type.value,
    "sniff i8": lambda m: m.c.Vector.sniff_from_blob(bytes(7)).vec_type.value,
    "add sub f32": lambda m: (
        m.c.Vector.from_f32([1.0, 2.0]).add(m.c.Vector.from_f32([0.5, -1.0])).as_f32(),
        m.c.Vector.from_f32([1.0, 2.0]).sub(m.c.Vector.from_f32([0.5, -1.0])).as_f32(),
    ),
    "add i8 saturates": lambda m: m.c.Vector.from_i8([120, -120]).add(
        m.c.Vector.from_i8([20, -20])).as_i8(),
    "sub i8 saturates": lambda m: m.c.Vector.from_i8([-120, 120]).sub(
        m.c.Vector.from_i8([20, -20])).as_i8(),
    "add bits": lambda m: m.c.Vector.from_bits([1]).add(m.c.Vector.from_bits([1])),
    "dimension mismatch": lambda m: m.c.Vector.from_f32([1.0]).add(m.c.Vector.from_f32([1.0, 2.0])),
    "type mismatch": lambda m: m.c.Vector.from_f32([1.0]).add(m.c.Vector.from_i8([1])),
    "normalize": lambda m: m.c.Vector.from_f32([3.0, 4.0]).normalize().as_f32(),
    "normalize zero": lambda m: m.c.Vector.from_f32([0.0, 0.0]).normalize().as_f32(),
    "normalize i8": lambda m: m.c.Vector.from_i8([1]).normalize(),
    "slice": lambda m: m.c.Vector.from_f32([1.0, 2.0, 3.0, 4.0]).slice(1, 3).as_f32(),
    "slice out of range": lambda m: m.c.Vector.from_f32([1.0]).slice(0, 2),
    "slice bits": lambda m: m.c.Vector.from_bits([1, 0, 1, 1, 0, 0, 1, 0, 1]).slice(2, 9).as_bits(),
    "i8 json saturates": lambda m: m.c.Vector.from_json(
        "[300, -300, 3.9, -3.9, 127, -128, NaN]", _i8(m)).as_i8(),
    "bit to json": lambda m: m.c.Vector.from_bits([1, 0, 1]).to_json(),
    "as_f32 of i8": lambda m: m.c.Vector.from_i8([1]).as_f32(),
    # types: parsers, sizes and errors
    "parse vector types": lambda m: [m.t.VectorType.parse(s).value
                                     for s in ("float32", " Float ", "int8", "BIT", "binary")],
    "parse bad vector type": lambda m: m.t.VectorType.parse("float16"),
    "parse metrics": lambda m: [m.t.DistanceMetric.parse(s).value for s in
                                ("l2", "Euclidean", "l1", "manhattan", "COSINE", "hamming")],
    "parse bad metric": lambda m: m.t.DistanceMetric.parse("dot"),
    "parse quantizations": lambda m: [m.t.IndexQuantization.parse(s).value
                                      for s in ("none", "INT8", " binary")],
    "parse bad quantization": lambda m: m.t.IndexQuantization.parse("pq"),
    "parse index types": lambda m: [m.t.IndexType.parse(s).value for s in ("hnsw", "ENN")],
    "parse bad index type": lambda m: m.t.IndexType.parse("ivf"),
    "element sizes": lambda m: [(v.value, v.bytes_per_element, v.blob_nbytes(13))
                                for v in m.t.VectorType],
    "dimension mismatch error": lambda m: (
        str(m.t.DimensionMismatch(3, 4)), m.t.DimensionMismatch(3, 4).expected),
    "error hierarchy": lambda m: sorted(
        name for name, cls in vars(m.t).items()
        if isinstance(cls, type) and issubclass(cls, m.t.TpuVecError)),
    # params: presets and with_
    "presets": lambda m: [
        (p.m, p.max_m0, p.ef_construction, p.ef_search)
        for p in (m.p.HnswParams.high_recall(), m.p.HnswParams.hot_tier(),
                  m.p.HnswParams.warm_tier(), m.p.HnswParams.cold_tier())
    ],
    "with_": lambda m: m.p.HnswParams().with_(m=4, ef_search=11).__dict__,
    "validate": lambda m: m.p.HnswParams(m=1).validate(),
}


def _outcome(case, m):
    """('value', plain python value) or ('raises', the error's name)."""
    try:
        v = case(m)
    except Exception as exc:  # the error's name is the outcome compared
        return "raises", type(exc).__name__
    if isinstance(v, tuple):
        return "value", [_outcome(lambda _, x=x: x, m)[1] for x in v]
    if isinstance(v, np.ndarray):
        return "value", (v.dtype.str, v.tolist())
    if isinstance(v, (bytes, str, int, float, list, dict, type(None))):
        return "value", v
    raise TypeError(f"case returned {type(v)}")


@pytest.mark.parametrize("name", list(CASES))
def test_host_modules_match_jax(name):
    want = _outcome(CASES[name], PACKAGES["jax"])
    got = _outcome(CASES[name], PACKAGES["port"])
    assert got == want


def test_timing_records_insert_stages(tmp_path):
    """With timing enabled, insert_batch adds each stage's time to its
    timer and counters add up; disabled, nothing is recorded. trace()
    writes a Chrome trace."""
    cfg = config_for(32, cap=128)
    x = prepare_vectors(cfg, np.random.default_rng(1).standard_normal((40, 32)), device="cpu")
    timing.reset()
    try:
        build_graph(cfg, x, max_batch=16, device="cpu")
        assert timing.stats() == {}
        timing.enable()
        with timing.trace(str(tmp_path / "trace.json")):
            build_graph(cfg, x, max_batch=16, device="cpu")
        timing.count("extra", 2)
        timing.count("extra", 3)
        stats = timing.stats()
    finally:
        timing.disable()
        timing.reset()
    n_batches = len(plan_batch_sizes(40, 16))
    for stage in ("write", "candidates", "upper", "connect"):
        total, calls = stats[f"insert.{stage}"]
        assert calls == n_batches and total > 0
    assert stats["extra"] == (5, 2)
    assert "traceEvents" in json.loads((tmp_path / "trace.json").read_text())
