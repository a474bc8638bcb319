"""The port's float distances, exact scan and vector preparation vs the
JAX package's, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6: both compute in float32 but sum in
different orders (torch's CPU kernels vs XLA:CPU at Precision.HIGHEST).
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

from tpuvec.index.bruteforce import bruteforce_knn as jax_bruteforce_knn  # noqa: E402
from tpuvec.index.graph import config_for as jax_config_for  # noqa: E402
from tpuvec.index.graph import prepare_vectors as jax_prepare_vectors  # noqa: E402
from tpuvec.ops import distance as jd  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec_torch.index.bruteforce import bruteforce_knn  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.ops import distance as td  # noqa: E402
from tpuvec_torch.types import DistanceMetric  # noqa: E402


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


TOL = dict(rtol=1e-5, atol=1e-6)

# (metric name, normalized): L2, cosine on normalized vectors (run as
# squared L2), raw cosine (1 - sim), L1
CASES = [("l2", False), ("cosine", True), ("cosine", False), ("l1", False)]


def _vectors(seed, *shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x


@pytest.mark.parametrize("metric,normalized", CASES)
def test_distances_match_jax(metric, normalized):
    q, x, nb = _vectors(1, 6, 48), _vectors(2, 40, 48), _vectors(3, 6, 12, 48)
    if normalized:
        q, x, nb = (a / np.linalg.norm(a, axis=-1, keepdims=True) for a in (q, x, nb))
    tm, jm = DistanceMetric(metric), JaxMetric(metric)
    kw = dict(normalized=normalized)

    pair = td.internal_pairwise(tm, torch.from_numpy(q), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(
        pair.numpy(), np.asarray(jd.internal_pairwise(jm, jnp.asarray(q), jnp.asarray(x), **kw)), **TOL
    )
    gath = td.gathered_internal(tm, torch.from_numpy(q), torch.from_numpy(nb), **kw)
    np.testing.assert_allclose(
        gath.numpy(), np.asarray(jd.gathered_internal(jm, jnp.asarray(q), jnp.asarray(nb), **kw)), **TOL
    )
    out = td.internal_to_output(tm, pair, **kw)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jd.internal_to_output(jm, jnp.asarray(pair.numpy()), **kw)), **TOL
    )
    assert td.internal_needs_normalize(tm, td.VectorType.FLOAT32) == jd.internal_needs_normalize(
        jm, jd.VectorType.FLOAT32
    )
    user = {"l2": (td.l2_pairwise, jd.l2_pairwise), "l1": (td.l1_pairwise, jd.l1_pairwise),
            "cosine": (td.cosine_pairwise, jd.cosine_pairwise)}[metric]
    np.testing.assert_allclose(
        user[0](torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        np.asarray(user[1](jnp.asarray(q), jnp.asarray(x))), **TOL,
    )


def test_int8_and_hamming_branches_raise():
    q = torch.ones((2, 8), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        td.internal_pairwise(DistanceMetric.L2, q, q)
    with pytest.raises(NotImplementedError):
        td.gathered_internal(DistanceMetric.HAMMING, q, q[:, None, :])


def test_prepare_and_exact_scan_match_jax():
    """Cosine preparation (normalize + pad to 128) and the exact k-NN scan,
    across chunk boundaries and with masked rows."""
    d = 40
    cfg, jcfg = config_for(d, cap=300), jax_config_for(d, cap=300)
    assert (cfg.cap, cfg.cap_u, cfg.padded_dim) == (jcfg.cap, jcfg.cap_u, jcfg.padded_dim)
    raw, rawq = _vectors(4, 300, d), _vectors(5, 7, d)
    xp = prepare_vectors(cfg, raw, device="cpu")
    qp = prepare_vectors(cfg, rawq, device="cpu")
    np.testing.assert_allclose(xp.numpy(), np.asarray(jax_prepare_vectors(jcfg, jnp.asarray(raw))), **TOL)
    valid = np.ones(300, bool)
    valid[::7] = False
    kw = dict(metric=DistanceMetric.COSINE, k=10, chunk=128, normalized=True)
    d_t, i_t = bruteforce_knn(qp, xp, torch.from_numpy(valid), **kw)
    kw["metric"] = JaxMetric.COSINE
    d_j, i_j = jax_bruteforce_knn(jnp.asarray(qp.numpy()), jnp.asarray(xp.numpy()), jnp.asarray(valid), **kw)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)
    assert valid[i_t.numpy()].all()
