"""The port's quantizers, quantized vector preparation and int8 / Hamming
distances vs the JAX package's, on the same numpy inputs.

Integer distances are exact (no tolerance): int8 squared L2 and L1 are
int32 sums in both packages and Hamming distances are bit counts, so both
give the same integers, cast to float32 once. Raw cosine on int8 rows
(1 - q.x / (|q| |x|)) takes exact integer dot products and norms (checked
exactly) and then a float32 square root, product and quotient, which XLA
may fuse or rewrite: it agrees within 2e-7 (one or two float32 ulps at 1). Packed words are compared as np.uint32 (the
port holds them as int32 with the same bits). The binary threshold compares
each value with its row's mean, which the two packages sum in another
order; on seeded Gaussian data no value lies within an ulp of its mean.
"""

import ctypes
import ctypes.util
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuvec import quantize as jq  # noqa: E402
from tpuvec.index import graph as jax_graph  # noqa: E402
from tpuvec.index.bruteforce import bruteforce_knn_internal as jax_bruteforce  # noqa: E402
from tpuvec.ops import distance as jd  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec.types import IndexQuantization as JaxQuant  # noqa: E402
from tpuvec.types import VectorType as JaxVec  # noqa: E402
from tpuvec_torch import quantize as tq  # noqa: E402
from tpuvec_torch.index.bruteforce import bruteforce_knn_internal  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.ops import distance as td  # noqa: E402
from tpuvec_torch.types import DistanceMetric, IndexQuantization, VectorType  # noqa: E402


def _trim_heap():
    gc.collect()
    ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Hand freed heap back to the OS before and after this module, and
    drop the programs JAX compiled for it: glibc keeps freed XLA and torch
    buffers mapped, so a worker's memory only grows from file to file, and
    the suite's workers share one machine's memory."""
    _trim_heap()
    yield
    jax.clear_caches()
    _trim_heap()


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy, packed words as np.uint32."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _floats(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _int8(seed, *shape):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


def _words(seed, *shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


# (metric, vec_type, quantization): config 3's INT8 index, config 4's
# BINARY index, and the two user element types
PREPARE_CASES = [
    ("cosine", "float32", "int8"),
    ("cosine", "float32", "binary"),
    ("l2", "int8", "none"),
    ("hamming", "bit", "none"),
]


@pytest.mark.parametrize("metric,vec_type,quant", PREPARE_CASES)
def test_prepare_vectors_match_jax(metric, vec_type, quant):
    """d=100: int8 rows pad to 128, packed words 4 -> 8 (pad bits zero)."""
    d = 100
    kw = dict(cap=256)
    cfg = config_for(d, metric=DistanceMetric(metric), vec_type=VectorType(vec_type),
                     quantization=IndexQuantization(quant), **kw)
    jcfg = jax_graph.config_for(d, metric=JaxMetric(metric), vec_type=JaxVec(vec_type),
                                quantization=JaxQuant(quant), **kw)
    assert (cfg.padded_dim, cfg.normalized) == (jcfg.padded_dim, jcfg.normalized)
    raw = {"float32": _floats(1, 40, d), "int8": _int8(1, 40, d), "bit": _words(1, 40, 4)}[vec_type]
    got = prepare_vectors(cfg, raw, device="cpu")
    want = np.asarray(jax_graph.prepare_vectors(jcfg, jnp.asarray(raw)))
    assert got.dtype == cfg.store_dtype and got.shape == (40, cfg.padded_dim)
    assert _np(got).dtype == want.dtype
    np.testing.assert_array_equal(_np(got), want)
    if quant == "binary":  # the same words through the uint32 numpy form
        np.testing.assert_array_equal(_np(prepare_vectors(cfg, torch.from_numpy(raw), device="cpu")), want)


def test_quantizers_match_jax():
    v = _floats(2, 16, 96) * 0.6
    np.testing.assert_array_equal(
        tq.quantize_int8_for_index(torch.from_numpy(v)).numpy(),
        np.asarray(jq.quantize_int8_for_index(jnp.asarray(v))),
    )
    q = _int8(3, 16, 96)
    np.testing.assert_array_equal(
        tq.dequantize_int8_index(torch.from_numpy(q)).numpy(),
        np.asarray(jq.dequantize_int8_index(jnp.asarray(q))),
    )
    np.testing.assert_array_equal(
        _np(tq.quantize_binary_words(torch.from_numpy(v))),
        np.asarray(jq.quantize_binary_words(jnp.asarray(v))),
    )
    bits = np.random.default_rng(4).integers(0, 2, (5, 3, 64)).astype(np.uint8)
    np.testing.assert_array_equal(
        _np(tq.pack_bits_to_words(torch.from_numpy(bits))),
        np.asarray(jq.pack_bits_to_words(jnp.asarray(bits))),
    )
    for name in ("quantize_int8_np", "quantize_int8_for_index_np", "quantize_binary_np"):
        np.testing.assert_array_equal(getattr(tq, name)(v[0]), getattr(jq, name)(v[0]))


# (metric, normalized, element kind)
DIST_CASES = [
    ("l2", False, "int8"),
    ("cosine", True, "int8"),
    ("cosine", False, "int8"),
    ("l1", False, "int8"),
    ("hamming", False, "words"),
]


def _dist_inputs(kind, seed):
    if kind == "int8":
        return _int8(seed, 6, 256), _int8(seed + 1, 40, 256), _int8(seed + 2, 6, 12, 256)
    return _words(seed, 6, 8), _words(seed + 1, 40, 8), _words(seed + 2, 6, 12, 8)


@pytest.mark.parametrize("metric,normalized,kind", DIST_CASES)
def test_quantized_distances_match_jax_exactly(metric, normalized, kind):
    q, x, nb = _dist_inputs(kind, 10)
    tm, jm = DistanceMetric(metric), JaxMetric(metric)
    kw = dict(normalized=normalized)
    pair = td.internal_pairwise(tm, _t(q), _t(x), **kw)
    want = np.asarray(jd.internal_pairwise(jm, jnp.asarray(q), jnp.asarray(x), **kw))
    assert pair.dtype == torch.float32
    raw_cosine = metric == "cosine" and not normalized
    same = (lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=2e-7)) if raw_cosine else (
        np.testing.assert_array_equal)
    same(pair.numpy(), want)
    gath = td.gathered_internal(tm, _t(q), _t(nb), **kw)
    same(gath.numpy(), np.asarray(jd.gathered_internal(jm, jnp.asarray(q), jnp.asarray(nb), **kw)))
    if kind == "int8":  # the integer parts, exactly
        np.testing.assert_array_equal(
            td._int_dot(_t(q), _t(x).T).numpy(), np.asarray(jd._dot(jnp.asarray(q), jnp.asarray(x).T, True))
        )
    # the matrix form and the gathered form are the same integers
    rows = np.stack([td.internal_pairwise(tm, _t(q[i : i + 1]), _t(nb[i]), **kw).numpy()[0] for i in range(6)])
    np.testing.assert_array_equal(gath.numpy(), rows)
    if kind == "words":
        np.testing.assert_array_equal(
            td.unpack_pm1(_t(q)).numpy(), np.asarray(jd.unpack_pm1(jnp.asarray(q)))
        )


def test_int8_sums_exact_past_float32_integers():
    """All-127 int8 rows at Dp=1152 (VectorType.INT8, dim 1152): q.x =
    127^2 * 1152 = 18580608 > 2^24, reached through odd partial sums that a
    single float32 product rounds. The port's sums are exact, as JAX's
    int32 accumulation is."""
    d = 1152
    cfg = config_for(d, metric=DistanceMetric.L2, vec_type=VectorType.INT8)
    assert cfg.padded_dim == d and cfg.store_dtype == torch.int8
    q = np.full((2, d), 127, np.int8)
    x = np.full((3, d), 127, np.int8)
    x[1, 0] = 126  # |q - x|^2 = 127^2 - 2*127*126 + 126^2 = 1
    x[2] = -127
    assert int(td._int_dot(_t(q), _t(x).T)[0, 0]) == 18580608
    for metric in ("l2", "cosine"):
        got = td.internal_pairwise(DistanceMetric(metric), _t(q), _t(x)).numpy()
        want = np.asarray(jd.internal_pairwise(JaxMetric(metric), jnp.asarray(q), jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
    sq = td.internal_pairwise(DistanceMetric.L2, _t(q), _t(x)).numpy()
    np.testing.assert_array_equal(sq[0], [0.0, 1.0, 4 * 18580608.0])
    nb = np.broadcast_to(x, (2, 3, d)).copy()
    np.testing.assert_array_equal(td.gathered_internal(DistanceMetric.L2, _t(q), _t(nb)).numpy(), sq)


@pytest.mark.parametrize("kind", ["int8", "words"])
def test_bruteforce_quantized_matches_jax(kind):
    """The exact scan over int8 / packed-word rows across chunk boundaries
    and with masked rows: distances equal; ids equal wherever the k-th
    distance is not tied with the next one (as sets: torch.topk and
    lax.top_k order equal distances differently)."""
    rng = np.random.default_rng(5)
    if kind == "int8":
        x, q = _int8(20, 300, 128), _int8(21, 7, 128)
        tm, jm = DistanceMetric.L2, JaxMetric.L2
    else:
        x, q = _words(20, 300, 8), _words(21, 7, 8)
        tm, jm = DistanceMetric.HAMMING, JaxMetric.HAMMING
    valid = rng.random(300) > 0.15
    k = 10
    d_t, i_t = bruteforce_knn_internal(_t(q), _t(x), torch.from_numpy(valid), metric=tm, k=k, chunk=128)
    d_j, i_j = jax_bruteforce(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), metric=jm, k=k, chunk=128)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert valid[i_t.numpy()].all()
    full = td.internal_pairwise(tm, _t(q), _t(x)).numpy()
    full[:, ~valid] = np.inf
    kth_next = np.sort(full, axis=1)[:, k]
    for row in range(q.shape[0]):
        untied = d_t.numpy()[row] < kth_next[row]
        assert untied.any()
        assert set(i_t.numpy()[row][untied]) == set(np.asarray(i_j)[row][untied])
