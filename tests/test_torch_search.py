"""The port's search vs the JAX package's on one graph, and the numpy
carry between the packages (tpuvec_torch.interop).

The graph is built by the port on the CPU (no JAX build in this file) and
carried into a JAX GraphState; both packages then search it. Ids must be
identical; distances agree within atol 1e-5 (float32 sums in different
orders).
"""

import ctypes
import ctypes.util
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuvec.index import graph as jax_graph  # noqa: E402
from tpuvec.index.params import HnswParams as JaxParams  # noqa: E402
from tpuvec.index.search import search_graph as jax_search_graph  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec_torch import interop  # noqa: E402
from tpuvec_torch.index.build import build_graph  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import search, search_graph  # noqa: E402
from tpuvec_torch.types import DistanceMetric  # noqa: E402
from tpuvec_torch.utils.data import synthetic_embeddings  # noqa: E402


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


N, D, NQ = 300, 32, 16
PARAMS = dict(m=8, max_m0=16, ef_construction=64, ef_search=32)
CFG = config_for(D, metric=DistanceMetric.COSINE, cap=512, params=HnswParams(**PARAMS))


@pytest.fixture(scope="module")
def graph():
    data = synthetic_embeddings(N + NQ, D, intrinsic_dim=12, n_clusters=16, seed=6)
    xp = prepare_vectors(CFG, data[:N], device="cpu")
    qp = prepare_vectors(CFG, data[N:], device="cpu")
    return build_graph(CFG, xp, max_batch=64, device="cpu"), qp


def _jax_state(state):
    return jax_graph.GraphState(
        **{k: jnp.asarray(v) for k, v in interop.state_to_numpy(state).items()}
    )


def test_config_carries_across():
    jcfg = jax_graph.config_for(
        D, metric=JaxMetric.COSINE, cap=512, params=JaxParams(**PARAMS)
    )
    as_dict = {
        k: (v.value if hasattr(v, "value") else v) for k, v in dataclasses.asdict(jcfg).items()
    }
    assert interop.config_to_dict(CFG) == as_dict
    assert interop.config_from_dict(as_dict) == CFG


def test_search_matches_jax_on_the_same_graph(graph):
    state, qp = graph
    jcfg = jax_graph.config_for(
        D, metric=JaxMetric.COSINE, cap=512, params=JaxParams(**PARAMS)
    )
    d_j, i_j = jax_search_graph(jcfg, _jax_state(state), jnp.asarray(qp.numpy()), k=10, ef=32)
    d_t, i_t = search_graph(CFG, state, qp, k=10, ef=32)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    # user-facing distances: cosine = internal squared L2 / 2
    d_u, i_u = search(CFG, state, qp, k=10, ef=32)
    np.testing.assert_array_equal(i_u.numpy(), i_t.numpy())
    np.testing.assert_allclose(d_u.numpy(), d_t.numpy() / 2)


def test_state_round_trip_is_exact(graph):
    state, _ = graph
    arrays = interop.state_to_numpy(state)
    back = interop.state_to_numpy(interop.state_from_numpy(arrays, device="cpu"))
    jarrays = {k: np.asarray(v) for k, v in vars(_jax_state(state)).items()}
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype == jarrays[name].dtype, name
        assert back[name].shape == a.shape == jarrays[name].shape, name
        assert np.array_equal(back[name], a) and np.array_equal(jarrays[name], a), name
