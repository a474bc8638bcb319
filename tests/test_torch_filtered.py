"""Filtered search in the port vs the JAX package: the masked level-0 loop
(``beam_loop_plain(node_mask=)``, the yardstick of the loop kernel's masked
forms on the card), ``search_graph(filter_mask=)``, and the per-query coded
exact scan (``bruteforce_knn_internal(slot_codes=, q_codes=)``).

The graphs are built by the port on the CPU (300 x 32 cosine, and 256 x 64
INT8 and BINARY) and carried into JAX GraphStates; no JAX build runs here.
Inputs come from numpy seeds. f32 results are compared id for id (the data
is tie-free) with distances within 1e-5 (float32 sums in other orders).
int8 and Hamming distances are exact integers and tie as a rule, and the
JAX package's post-loop ``bitonic_sort`` is not stable, so their distances
are compared exactly, in order, and their ids as a set per distinct
distance; where a list is cut at k, the ids at the cut's distance are held
to having that distance.
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

from tpuvec.index import graph as jax_graph  # noqa: E402
from tpuvec.index.bruteforce import bruteforce_knn_internal as jax_bruteforce  # noqa: E402
from tpuvec.index.params import HnswParams as JaxParams  # noqa: E402
from tpuvec.index.search import beam_search_level0 as jax_beam_search_level0  # noqa: E402
from tpuvec.index.search import search_graph as jax_search_graph  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec.types import IndexQuantization as JaxQuant  # noqa: E402
from tpuvec_torch import interop, kernels  # noqa: E402
from tpuvec_torch.index.bruteforce import bruteforce_knn_internal  # noqa: E402
from tpuvec_torch.index.build import build_graph  # noqa: E402
from tpuvec_torch.index.graph import allocate, config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import (  # noqa: E402
    default_max_iters,
    descend_to_level1,
    search_graph,
    seed_beam,
)
from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain  # noqa: E402
from tpuvec_torch.ops.distance import internal_pairwise  # noqa: E402
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


NQ = 16
# form -> (rows, dims, cap, quantization, HNSW params), as test_torch_search.py
# and test_torch_quantized.py build their graphs
FORMS = {
    "f32": (300, 32, 512, "none", dict(m=8, max_m0=16, ef_construction=64, ef_search=32)),
    "int8": (256, 64, 256, "int8", dict(m=8, max_m0=16, ef_construction=32, ef_search=32)),
    "words": (256, 64, 256, "binary", dict(m=8, max_m0=16, ef_construction=32, ef_search=32)),
}


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the JAX package holds it: packed words as uint32."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _jnp(t: torch.Tensor):
    return jnp.asarray(_np(t))


@pytest.fixture(scope="module")
def graphs():
    """form -> the port's graph on the CPU, its JAX twin, configs, queries."""
    out = {}
    for form, (n, d, cap, quant, params) in FORMS.items():
        cfg = config_for(d, metric=DistanceMetric.COSINE, cap=cap,
                         quantization=IndexQuantization(quant), params=HnswParams(**params))
        jcfg = jax_graph.config_for(d, metric=JaxMetric.COSINE, cap=cap,
                                    quantization=JaxQuant(quant), params=JaxParams(**params))
        data = synthetic_embeddings(n + NQ, d, intrinsic_dim=12, n_clusters=16, seed=6)
        xp = prepare_vectors(cfg, data[:n], device="cpu")
        qp = prepare_vectors(cfg, data[n:], device="cpu")
        state = build_graph(cfg, _np(xp), max_batch=64, device="cpu")
        jstate = jax_graph.GraphState(
            **{k: jnp.asarray(v) for k, v in interop.state_to_numpy(state).items()}
        )
        out[form] = dict(n=n, cfg=cfg, jcfg=jcfg, state=state, jstate=jstate, qp=qp)
    return out


def _mask(g, kind, seeds=None):
    """[cap] bool: 50% (even ids), 10% (id % 10 == 0), none, or 50% with
    every query's seed taken out (the seed fails the mask)."""
    ids = torch.arange(g["cfg"].cap)
    if kind == "50%":
        return ids % 2 == 0
    if kind == "10%":
        return ids % 10 == 0
    if kind == "none":
        return torch.zeros(g["cfg"].cap, dtype=torch.bool)
    mask = ids % 2 == 0
    mask[seeds[seeds >= 0].long()] = False
    return mask


def _same_up_to_ties(d_t, i_t, d_j, i_j, exact):
    """Distances equal (exactly, or within 1e-5) in order; ids equal (f32)
    or, where distances tie as a rule, equal as a set per distinct
    distance of each row."""
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    if not exact:
        np.testing.assert_array_equal(i_t.numpy(), i_j)
        np.testing.assert_allclose(d_t.numpy(), d_j, atol=1e-5)
        return
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    for dt, it, ij in zip(d_t.numpy(), i_t.numpy(), i_j):
        for v in np.unique(dt):
            assert set(it[dt == v].tolist()) == set(ij[dt == v].tolist()), (v, it, ij)


def _same_cut_at_k(d_t, i_t, d_j, i_j, full_d):
    """Exact distances equal in order, ids equal as a set per distinct
    distance below each row's last one; the ids at the last distance (the
    cut at k may split its tie) have that distance in ``full_d`` [B, N]."""
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    for dt, it, ij, fd in zip(d_t.numpy(), i_t.numpy(), i_j, full_d):
        last = dt[np.isfinite(dt)].max() if np.isfinite(dt).any() else np.inf
        for v in np.unique(dt):
            if v < last:
                assert set(it[dt == v].tolist()) == set(ij[dt == v].tolist()), (v, it, ij)
            elif np.isfinite(v):
                assert (fd[it[dt == v]] == v).all(), (v, it)


_jax_level0 = jax.jit(
    jax_beam_search_level0,
    static_argnames=("config", "ef", "max_iters", "n_expand", "merge", "k_out"),
)


@pytest.mark.parametrize("mask_kind", ["50%", "10%", "none", "seed fails"])
@pytest.mark.parametrize("e,ef", [(1, 32), (2, 64)])
@pytest.mark.parametrize("form", list(FORMS))
def test_masked_loop_matches_jax(graphs, form, e, ef, mask_kind):
    """beam_loop_plain(node_mask=) vs the JAX package's
    beam_search_level0(node_mask=, merge="rank") from the same seeds:
    the KP-slot result buffer (ids, distances) and iters. beam_loop on CPU
    tensors is the same plain loop."""
    g = graphs[form]
    cfg, state, qp = g["cfg"], g["state"], g["qp"]
    seeds = descend_to_level1(cfg, state, qp)
    mask = _mask(g, mask_kind, seeds[0])
    if mask_kind == "seed fails":
        assert not mask[seeds[0].long()].any()
    max_iters = default_max_iters(ef, e)
    args = (qp, state.vectors, state.adj0,
            *seed_beam(*seeds, ef=ef, n_expand=e, node_mask=mask, k_out=10))
    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized, max_iters=max_iters,
              node_mask=mask)
    d_t, i_t, it_t = beam_loop_plain(*args, **kw)
    d_j, i_j, it_j = _jax_level0(
        g["jcfg"], g["jstate"], _jnp(qp), jnp.asarray(seeds[0].numpy()),
        jnp.asarray(seeds[1].numpy()), ef=ef, max_iters=max_iters, n_expand=e, merge="rank",
        node_mask=jnp.asarray(mask.numpy()), k_out=10,
    )
    assert d_t.shape == i_t.shape == (NQ, 32)
    _same_up_to_ties(d_t, i_t, d_j, i_j, exact=form != "f32")
    assert it_t == int(it_j)
    found = i_t[i_t >= 0].long()
    assert mask[found].all()
    assert (len(found) == 0) == (mask_kind == "none")
    d_w, i_w, it_w = beam_loop(*args, **kw)
    assert torch.equal(d_w, d_t) and torch.equal(i_w, i_t) and it_w == it_t


@pytest.mark.parametrize("mask_kind", ["50%", "10%"])
@pytest.mark.parametrize("form", list(FORMS))
def test_filtered_search_matches_jax(graphs, form, mask_kind):
    """search_graph(filter_mask=) vs the JAX package's on the same graph:
    every returned id passes the mask, slots past the ones found are
    (inf, -1), and the lists agree (f32 id for id; int8 and Hamming up to
    ties)."""
    g = graphs[form]
    cfg, state, qp = g["cfg"], g["state"], g["qp"]
    mask = _mask(g, mask_kind)
    d_t, i_t = search_graph(cfg, state, qp, k=10, ef=32, filter_mask=mask)
    d_j, i_j = jax_search_graph(g["jcfg"], g["jstate"], _jnp(qp), k=10, ef=32,
                                filter_mask=jnp.asarray(mask.numpy()))
    assert d_t.shape == (NQ, 10)
    assert mask[i_t[i_t >= 0].long()].all()
    assert torch.equal(i_t < 0, ~torch.isfinite(d_t))
    if form == "f32":
        _same_up_to_ties(d_t, i_t, d_j, i_j, exact=False)
    else:
        full = internal_pairwise(cfg.graph_metric, qp, state.vectors, normalized=cfg.normalized)
        _same_cut_at_k(d_t, i_t, d_j, i_j, full.numpy())


def test_filtered_search_on_an_empty_graph():
    cfg = config_for(32, metric=DistanceMetric.COSINE, cap=128,
                     params=HnswParams(m=8, max_m0=16, ef_construction=64))
    q = torch.ones((3, cfg.padded_dim))
    d, i = search_graph(cfg, allocate(cfg, device="cpu"), q, k=5, ef=16,
                        filter_mask=torch.ones(cfg.cap, dtype=torch.bool))
    assert (i == -1).all() and torch.isinf(d).all() and d.shape == (3, 5)


def test_masked_loop_wrapper_checks(graphs, monkeypatch):
    """On CPU tensors the masked beam_loop runs the plain loop and never
    loads a kernel; a mask of the wrong length, dtype or device, a result
    buffer of the wrong shape or dtype, and a mask without a buffer (or a
    buffer without a mask), and a mask without k_out at seeding raise
    ValueError."""

    def no_kernel(name):
        raise AssertionError(f"a CPU tensor reached the kernel loader ({name})")

    monkeypatch.setattr(kernels, "load", no_kernel)
    g = graphs["f32"]
    cfg, state, qp = g["cfg"], g["state"], g["qp"]
    mask = _mask(g, "50%")
    beam = seed_beam(*descend_to_level1(cfg, state, qp), ef=32, n_expand=1,
                     node_mask=mask, k_out=10)
    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized, max_iters=4)
    d, i, it = beam_loop(qp, state.vectors, state.adj0, *beam, **kw, node_mask=mask)
    assert d.shape == i.shape == (NQ, 32) and 1 <= it <= 4

    for bad in (mask[:-1], mask.to(torch.uint8), mask.to("meta")):
        with pytest.raises(ValueError):
            beam_loop(qp, state.vectors, state.adj0, *beam, **kw, node_mask=bad)
    res_d, res_i = beam[5:]
    for bad_res in ((res_d[:8], res_i), (res_d, res_i.long()), (res_d[:, :0], res_i[:, :0])):
        with pytest.raises(ValueError):
            beam_loop(qp, state.vectors, state.adj0, *beam[:5], *bad_res, **kw, node_mask=mask)
    with pytest.raises(ValueError, match="together"):
        beam_loop(qp, state.vectors, state.adj0, *beam[:5], **kw, node_mask=mask)
    with pytest.raises(ValueError, match="together"):
        beam_loop(qp, state.vectors, state.adj0, *beam, **kw)
    with pytest.raises(ValueError, match="k_out"):
        seed_beam(*descend_to_level1(cfg, state, qp), ef=32, n_expand=1, node_mask=mask)


# ------------------------------------------------------ the coded exact scan

SCAN_N, SCAN_B, SCAN_D, CHUNK = 1000, 12, 64, 256


def _scan_rows(metric_kind, rng):
    """(rows, queries, internal metric, normalized) of one metric form."""
    x = rng.standard_normal((SCAN_N + SCAN_B, SCAN_D)).astype(np.float32)
    if metric_kind == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return x[:SCAN_N], x[SCAN_N:], "cosine", True
    if metric_kind == "l2":
        return x[:SCAN_N], x[SCAN_N:], "l2", False
    if metric_kind == "int8":
        xi = rng.integers(-127, 128, (SCAN_N + SCAN_B, SCAN_D)).astype(np.int8)
        return xi[:SCAN_N], xi[SCAN_N:], "l2", False
    words = rng.integers(0, 2**32, (SCAN_N + SCAN_B, SCAN_D // 32), dtype=np.uint64)
    words = words.astype(np.uint32)
    return words[:SCAN_N], words[SCAN_N:], "hamming", False


@pytest.mark.parametrize("metric_kind", ["cosine", "l2", "int8", "hamming"])
def test_coded_scan_matches_jax(metric_kind):
    """bruteforce_knn_internal(slot_codes=, q_codes=) vs the JAX package's,
    with N not a multiple of the chunk, rows with no code (-1), a query of
    code -1 (those rows), one of code -2 (nothing) and one of a code no row
    holds; every returned id holds its query's code."""
    rng = np.random.default_rng(11)
    x, q, metric_name, normalized = _scan_rows(metric_kind, rng)
    valid = rng.random(SCAN_N) > 0.1
    codes = rng.integers(0, 5, SCAN_N).astype(np.int32)
    codes[rng.random(SCAN_N) < 0.1] = -1
    q_codes = rng.integers(0, 5, SCAN_B).astype(np.int32)
    q_codes[:3] = [-1, -2, 7]
    kw = dict(k=10, chunk=CHUNK, normalized=normalized)
    xt, qt = (torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in (x, q))
    d_t, i_t = bruteforce_knn_internal(
        qt, xt, torch.from_numpy(valid), metric=DistanceMetric(metric_name),
        slot_codes=torch.from_numpy(codes), q_codes=torch.from_numpy(q_codes), **kw,
    )
    d_j, i_j = jax_bruteforce(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), metric=JaxMetric(metric_name),
        slot_codes=jnp.asarray(codes), q_codes=jnp.asarray(q_codes), **kw,
    )
    ok = i_t >= 0
    assert not ok[1].any() and not ok[2].any() and ok[0].any()
    rows, cols = torch.nonzero(ok, as_tuple=True)
    found = i_t[rows, cols].long()
    assert (torch.from_numpy(codes)[found] == torch.from_numpy(q_codes)[rows]).all()
    assert torch.from_numpy(valid)[found].all()
    if metric_kind in ("cosine", "l2"):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-5)
    else:
        full = internal_pairwise(DistanceMetric(metric_name), qt, xt, normalized=False)
        _same_cut_at_k(d_t, i_t, d_j, i_j, full.numpy())


def test_coded_scan_needs_both_codes():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="together"):
        bruteforce_knn_internal(x, x, torch.ones(4, dtype=torch.bool), metric=DistanceMetric.L2,
                                k=2, slot_codes=torch.zeros(4, dtype=torch.int32))
