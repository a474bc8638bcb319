"""The port's search vs the JAX package's on one graph, the level-0 loop
(tpuvec_torch.ops.beam.beam_loop) vs the JAX package's level-0 beam, and
the numpy carry between the packages (tpuvec_torch.interop).

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
from tpuvec.index.search import beam_search_level0 as jax_beam_search_level0  # noqa: E402
from tpuvec.index.search import search_graph as jax_search_graph  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec_torch import interop, kernels  # noqa: E402
from tpuvec_torch.index.build import build_graph  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import (  # noqa: E402
    default_max_iters,
    descend_to_level1,
    search,
    search_graph,
    seed_beam,
)
from tpuvec_torch.ops.beam import beam_loop  # noqa: E402
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


def _jax_config():
    return jax_graph.config_for(D, metric=JaxMetric.COSINE, cap=512, params=JaxParams(**PARAMS))


def _loop(state, qp, seeds, *, ef, e, max_iters):
    """The port's level-0 loop from the seeds, on the graph's tensors."""
    beam = seed_beam(*seeds, ef=ef, n_expand=e)
    return beam_loop(
        qp, state.vectors, state.adj0, *beam,
        metric=CFG.graph_metric, normalized=CFG.normalized, max_iters=max_iters,
    )


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
    d_j, i_j = jax_search_graph(_jax_config(), _jax_state(state), jnp.asarray(qp.numpy()), k=10, ef=32)
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


@pytest.mark.parametrize("e,ef", [(1, 32), (2, 64)])
def test_level0_loop_matches_jax(graph, e, ef):
    """beam_loop on the CPU vs the JAX package's level-0 beam (rank merge)
    from the same seeds on the carried graph: W = E * 16."""
    state, qp = graph
    seeds = descend_to_level1(CFG, state, qp)
    max_iters = default_max_iters(ef, e)
    d_t, i_t, it_t = _loop(state, qp, seeds, ef=ef, e=e, max_iters=max_iters)
    level0 = jax.jit(
        jax_beam_search_level0,
        static_argnames=("config", "ef", "max_iters", "n_expand", "merge"),
    )
    d_j, i_j, it_j = level0(
        _jax_config(), _jax_state(state), jnp.asarray(qp.numpy()),
        jnp.asarray(seeds[0].numpy()), jnp.asarray(seeds[1].numpy()),
        ef=ef, max_iters=max_iters, n_expand=e, merge="rank",
    )
    assert d_t.shape == (NQ, ef)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    assert it_t == int(it_j)


@pytest.mark.parametrize("max_iters", [None, 3])
def test_level0_loop_per_query_equals_batch(graph, max_iters):
    """What the kernel's one-block-per-query loop rests on: a batch run in
    lock step gives each query the beam it gets when run alone. Ids are
    identical; distances agree within atol 1e-6."""
    state, qp = graph
    seed_i, seed_d = descend_to_level1(CFG, state, qp)
    max_iters = default_max_iters(64, 2) if max_iters is None else max_iters

    def run(sl):
        return _loop(state, qp[sl], (seed_i[sl], seed_d[sl]), ef=64, e=2, max_iters=max_iters)

    d_b, i_b, it_b = run(slice(None))
    alone = [run(slice(k, k + 1)) for k in range(NQ)]
    assert torch.equal(i_b, torch.cat([a[1] for a in alone]))
    # the CPU's bmm sums in another order at batch 1: float32 rounding only
    torch.testing.assert_close(d_b, torch.cat([a[0] for a in alone]), rtol=0, atol=1e-6)
    assert it_b == max(a[2] for a in alone)


def test_level0_loop_wrapper_checks(graph, monkeypatch):
    """On CPU tensors beam_loop runs the plain loop and never loads a
    kernel; rows and metrics that are no form of the kernel (int8 queries
    on f32 rows, Hamming on f32 rows, a metric on words, int8 rows of a
    width that is not whole 16-byte loads), and wrong dtypes, shapes and
    layouts raise ValueError."""

    def no_kernel(name):
        raise AssertionError(f"a CPU tensor reached the kernel loader ({name})")

    monkeypatch.setattr(kernels, "load", no_kernel)
    state, qp = graph
    beam = seed_beam(*descend_to_level1(CFG, state, qp), ef=32, n_expand=1)
    kw = dict(metric=CFG.graph_metric, normalized=CFG.normalized, max_iters=4)
    d, i, it = beam_loop(qp, state.vectors, state.adj0, *beam, **kw)
    assert d.shape == i.shape == (NQ, 32) and 1 <= it <= 4

    with pytest.raises(ValueError, match="hamming"):
        beam_loop(qp, state.vectors, state.adj0, *beam,
                  metric=DistanceMetric.HAMMING, normalized=False, max_iters=4)
    with pytest.raises(ValueError, match="int8"):
        beam_loop(qp.to(torch.int8), state.vectors, state.adj0, *beam, **kw)
    words = state.vectors.view(torch.int32)
    with pytest.raises(ValueError, match="cosine"):
        beam_loop(qp.view(torch.int32), words, state.adj0, *beam, **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        beam_loop(qp[:, :40].to(torch.int8), state.vectors[:, :40].to(torch.int8), state.adj0,
                  *beam, **kw)

    beam_d, beam_i, beam_x, cand, active = beam
    bad = [
        (qp.double(), state.vectors, state.adj0, *beam),
        (qp[:, :16].contiguous(), state.vectors, state.adj0, *beam),
        (qp, state.vectors, state.adj0.long(), *beam),
        (qp, state.vectors[:100], state.adj0, *beam),
        (qp, state.vectors, state.adj0, beam_d[:, :24].contiguous(), beam_i[:, :24].contiguous(),
         beam_x[:, :24].contiguous(), cand, active),
        (qp, state.vectors, state.adj0, beam_d, beam_i, beam_x.int(), cand, active),
        (qp, state.vectors, state.adj0, beam_d, beam_i, beam_x, cand[:, 0], active),
        (qp, state.vectors, state.adj0, beam_d, beam_i, beam_x, cand, active[:8]),
        (qp, state.vectors, state.adj0, beam_d.t().contiguous().t(), beam_i, beam_x, cand, active),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            beam_loop(*args, **kw)
    with pytest.raises(ValueError, match="max_iters"):
        beam_loop(qp, state.vectors, state.adj0, *beam, **{**kw, "max_iters": -1})
