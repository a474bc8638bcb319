"""The port's quantized indexes (INT8 and BINARY, BASELINE configs 3 and
4) vs the JAX package's: build quality, search on one graph, and the
level-0 loop's int8 and Hamming forms.

This file holds the port tests' only quantized JAX build_graph calls, one
per quantization (module-scoped): a JAX build costs 6-20 s on the CPU,
most of it compile time.

- Builds agree up to tie order (the JAX construction beam's bitonic merge
  is not stable on ties, and quantized distances tie often), so they are
  held by recall: within 0.02 of the JAX build's against the exact scan.
- Search on the *same* graph (the port's, carried into the JAX package)
  returns identical ids: both use the stable rank merge and first-minimum
  descent, and integer distances are exact in both.
- The level-0 loop (beam_loop_plain, the kernel's yardstick on the card)
  equals JAX's beam_search_level0(merge="rank"): ids, distances and iters.
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

from tpuvec.index import build as jax_build  # noqa: E402
from tpuvec.index import graph as jax_graph  # noqa: E402
from tpuvec.index.params import HnswParams as JaxParams  # noqa: E402
from tpuvec.index.search import beam_search_level0 as jax_beam_search_level0  # noqa: E402
from tpuvec.index.search import search_graph as jax_search_graph  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec.types import IndexQuantization as JaxQuant  # noqa: E402
from tpuvec_torch import interop  # noqa: E402
from tpuvec_torch.index.bruteforce import bruteforce_knn_internal  # noqa: E402
from tpuvec_torch.index.build import build_graph  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import (  # noqa: E402
    default_max_iters,
    descend_to_level1,
    search_graph,
    seed_beam,
)
from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain  # noqa: E402
from tpuvec_torch.types import DistanceMetric, IndexQuantization  # noqa: E402
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


N, D, NQ = 256, 64, 32
PARAMS = dict(m=8, max_m0=16, ef_construction=32, ef_search=32)


def _configs(quant):
    cfg = config_for(D, metric=DistanceMetric.COSINE, quantization=IndexQuantization(quant),
                     cap=N, params=HnswParams(**PARAMS))
    jcfg = jax_graph.config_for(D, metric=JaxMetric.COSINE, quantization=JaxQuant(quant),
                                cap=N, params=JaxParams(**PARAMS))
    return cfg, jcfg


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the JAX package holds it: packed words as uint32."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _jnp(t: torch.Tensor):
    return jnp.asarray(_np(t))


def _jax_state(state):
    return jax_graph.GraphState(
        **{k: jnp.asarray(v) for k, v in interop.state_to_numpy(state).items()}
    )


@pytest.fixture(scope="module", params=["int8", "binary"])
def quantized(request):
    """Both packages' builds of the same data, and the port's queries."""
    cfg, jcfg = _configs(request.param)
    data = synthetic_embeddings(N + NQ, D, intrinsic_dim=12, n_clusters=16, seed=6)
    xp = prepare_vectors(cfg, data[:N], device="cpu")
    qp = prepare_vectors(cfg, data[N:], device="cpu")
    port = build_graph(cfg, _np(xp), max_batch=64, device="cpu")  # words arrive as uint32
    ref = jax_build.build_graph(jcfg, _jnp(xp), max_batch=64)
    ref = interop.state_from_numpy({k: np.asarray(v) for k, v in vars(ref).items()}, device="cpu")
    _, gt = bruteforce_knn_internal(
        qp, xp, torch.ones(N, dtype=torch.bool), metric=cfg.graph_metric, k=10,
        normalized=cfg.normalized,
    )
    yield dict(quant=request.param, cfg=cfg, jcfg=jcfg, xp=xp, qp=qp, port=port, ref=ref, gt=gt)
    jax.clear_caches()  # one quantization's compiled programs at a time
    _trim_heap()


def test_quantized_build_recall_close_to_jax(quantized):
    """Row dtypes as the JAX package stores them, every node placed, and
    recall@10 against the exact internal scan within 0.02 of the JAX
    build's; the share of level-0 edges both builds hold is printed."""
    cfg, port, ref, qp, gt = (quantized[k] for k in ("cfg", "port", "ref", "qp", "gt"))
    assert port.vectors.dtype == ref.vectors.dtype == cfg.store_dtype
    assert torch.equal(port.vectors, ref.vectors) and int(port.count) == N

    def recall(state):
        _, found = search_graph(cfg, state, qp, k=10, ef=32)
        return np.mean([len(set(f.tolist()) & set(g.tolist())) / 10 for f, g in zip(found, gt)])

    a, b = port.adj0.numpy()[:N], ref.adj0.numpy()[:N]
    same = sum(len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist())) for x, y in zip(a, b))
    total = sum(int((y >= 0).sum()) for y in b)
    r_port, r_ref = recall(port), recall(ref)
    print(f"{quantized['quant']}: adj0 edges shared with the JAX build {same / total:.4f}, "
          f"recall@10 port {r_port:.4f} vs JAX {r_ref:.4f}")
    assert r_port >= 0.9 and abs(r_port - r_ref) <= 0.02, (r_port, r_ref)


def test_quantized_state_round_trip_is_exact(quantized):
    """Packed words leave the port as np.uint32 (the JAX package's dtype)
    and come back as the same int32 bits."""
    port = quantized["port"]
    arrays = interop.state_to_numpy(port)
    assert arrays["vectors"].dtype == _np(port.vectors).dtype
    assert arrays["vectors"].dtype == (np.uint32 if quantized["quant"] == "binary" else np.int8)
    back = interop.state_from_numpy(arrays, device="cpu")
    for name, a in vars(port).items():
        assert getattr(back, name).dtype == a.dtype and torch.equal(getattr(back, name), a), name


@pytest.mark.parametrize("ef", [16, 32])
def test_quantized_search_matches_jax_on_the_same_graph(quantized, ef):
    cfg, jcfg, port, qp = (quantized[k] for k in ("cfg", "jcfg", "port", "qp"))
    d_j, i_j = jax_search_graph(jcfg, _jax_state(port), _jnp(qp), k=10, ef=ef)
    d_t, i_t = search_graph(cfg, port, qp, k=10, ef=ef)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


_jax_level0 = jax.jit(
    jax_beam_search_level0, static_argnames=("config", "ef", "max_iters", "n_expand", "merge")
)


@pytest.mark.parametrize("e,ef", [(1, 32), (2, 64)])
def test_quantized_level0_loop_matches_jax(quantized, e, ef):
    """beam_loop_plain's int8 (squared L2) and Hamming forms vs the JAX
    package's level-0 beam from the same seeds: exactly equal. beam_loop
    on CPU tensors is the same plain loop."""
    cfg, jcfg, port, qp = (quantized[k] for k in ("cfg", "jcfg", "port", "qp"))
    seeds = descend_to_level1(cfg, port, qp)
    max_iters = default_max_iters(ef, e)
    args = (qp, port.vectors, port.adj0, *seed_beam(*seeds, ef=ef, n_expand=e))
    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized, max_iters=max_iters)
    d_t, i_t, it_t = beam_loop_plain(*args, **kw)
    d_j, i_j, it_j = _jax_level0(
        jcfg, _jax_state(port), _jnp(qp), jnp.asarray(seeds[0].numpy()),
        jnp.asarray(seeds[1].numpy()), ef=ef, max_iters=max_iters, n_expand=e, merge="rank",
    )
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert it_t == int(it_j)
    d_w, i_w, it_w = beam_loop(*args, **kw)
    assert torch.equal(d_w, d_t) and torch.equal(i_w, i_t) and it_w == it_t
