"""Graph edits in the port vs the JAX package: ``delete_ids`` field for
field, search on the edited graph, and the upper stage's k_up cap
(``_stage_upper`` with the JAX package's padded batch width).

The deletion graph is built by the port on the CPU (300 x 32 cosine) and
carried into a JAX GraphState; the upper stage runs one batch into a fresh
state in both packages. No JAX build runs here: each comparison is one
jitted JAX function or stage.
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
from tpuvec.index.search import search_graph as jax_search_graph  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec_torch import interop  # noqa: E402
from tpuvec_torch.index import build  # noqa: E402
from tpuvec_torch.index.graph import allocate, config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import search_graph  # noqa: E402
from tpuvec_torch.types import DistanceMetric  # noqa: E402
from tpuvec_torch.utils.data import synthetic_embeddings  # noqa: E402
from tpuvec_torch.utils.prng import sample_levels_np  # noqa: E402


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
JCFG = jax_graph.config_for(D, metric=JaxMetric.COSINE, cap=512, params=JaxParams(**PARAMS))


def _jax_state(state):
    return jax_graph.GraphState(
        **{k: jnp.asarray(v) for k, v in interop.state_to_numpy(state).items()}
    )


def _copy(state):
    return interop.state_from_numpy(interop.state_to_numpy(state), device="cpu")


@pytest.fixture(scope="module")
def graph():
    data = synthetic_embeddings(N + NQ, D, intrinsic_dim=12, n_clusters=16, seed=6)
    xp = prepare_vectors(CFG, data[:N], device="cpu")
    qp = prepare_vectors(CFG, data[N:], device="cpu")
    return build.build_graph(CFG, xp, max_batch=64, device="cpu"), qp


def _victims(state, case):
    """The id list of a deletion case (i32, -1 = padding)."""
    rng = np.random.default_rng(4)
    ep = int(state.entry_point)
    others = rng.permutation(np.setdiff1d(np.arange(N), [ep]))
    if case == "ids":
        ids = others[:20]
    elif case == "entry point":
        ids = np.concatenate([[ep], others[:9]])
    elif case == "padding":  # padded, with one id listed twice
        ids = np.concatenate([others[:6], [others[0]], [-1] * 9])
    else:  # every node
        ids = rng.permutation(N)
    return torch.from_numpy(ids.astype(np.int32))


_jax_delete = jax.jit(jax_build.delete_ids, static_argnames=("config",))


@pytest.mark.parametrize("case", ["ids", "entry point", "padding", "all"])
def test_delete_ids_matches_jax(graph, case):
    """delete_ids vs the JAX package's, every GraphState field equal; then
    both packages search the edited graph, unfiltered and with a 50% mask,
    and return the same ids (distances within 1e-5), none of them
    deleted."""
    state, qp = graph
    port = _copy(state)
    ids = _victims(state, case)
    ref = _jax_delete(JCFG, _jax_state(state), jnp.asarray(ids.numpy()))
    assert build.delete_ids(CFG, port, ids) is port
    ref_np = {k: np.asarray(v) for k, v in vars(ref).items()}
    for name, a in interop.state_to_numpy(port).items():
        assert a.dtype == ref_np[name].dtype, name
        np.testing.assert_array_equal(a, ref_np[name], err_msg=name)

    live = ids[ids >= 0].long()
    if case == "entry point":
        assert int(port.entry_point) != int(state.entry_point) >= 0
    if case == "padding":  # the duplicate counts twice, as in the JAX package
        assert int(port.count) == N - 7
    if case == "all":
        assert int(port.count) == 0 and int(port.entry_point) == -1
    for mask in (None, torch.arange(CFG.cap) % 2 == 0):
        d_t, i_t = search_graph(CFG, port, qp, k=10, ef=32, filter_mask=mask)
        d_j, i_j = jax_search_graph(
            JCFG, ref, jnp.asarray(qp.numpy()), k=10, ef=32,
            filter_mask=None if mask is None else jnp.asarray(mask.numpy()),
        )
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
        assert not np.isin(i_t.numpy(), live.numpy()).any()
        assert (case == "all") == bool((i_t < 0).all())


# ---------------------------------------------------------- the k_up cap

CAP_N, CAP_CAP = 1024, 8192


def test_upper_stage_caps_like_jax():
    """One batch of 1024 at m=2 into a fresh state: the port's _stage_write
    + _stage_upper(width=1024) vs the jitted JAX stages. About half the rows
    reach level 1, so k_up = 256 binds: the rows past it keep their level
    and upper slot but have no upper out-edges, and the upper graphs are
    equal (ids exactly, distances within 1e-5). A row past k_up holds only
    reverse edges, from the rows inside it."""
    params = dict(m=2, max_m0=4, ef_construction=16, ef_search=16)
    cfg = config_for(D, metric=DistanceMetric.COSINE, cap=CAP_CAP, params=HnswParams(**params))
    jcfg = jax_graph.config_for(D, metric=JaxMetric.COSINE, cap=CAP_CAP,
                                params=JaxParams(**params))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((CAP_N, D)).astype(np.float32)
    xp = prepare_vectors(cfg, x, device="cpu")
    ids = np.arange(CAP_N, dtype=np.int32)
    levels = sample_levels_np(ids, cfg.rng_seed, cfg.level_factor, cfg.lu).astype(np.int32)
    n_up = int((levels >= 1).sum())
    assert n_up > 256, n_up  # the cap binds

    port = allocate(cfg, device="cpu")
    ids_t, lv_t = torch.from_numpy(ids), torch.from_numpy(levels)
    build._stage_write(cfg, port, ids_t, xp, lv_t)
    build._stage_upper(cfg, port, ids_t, xp, width=CAP_N)
    ref = jax_graph.allocate(jcfg)
    ref = jax_build._stage_write(jcfg, ref, jnp.asarray(ids), jnp.asarray(xp.numpy()),
                                 jnp.asarray(levels))
    ref = jax_build._stage_upper(jcfg, ref, jnp.asarray(ids), jnp.asarray(xp.numpy()))

    np.testing.assert_array_equal(port.upper_adj.numpy(), np.asarray(ref.upper_adj))
    np.testing.assert_allclose(port.upper_dist.numpy(), np.asarray(ref.upper_dist), atol=1e-5)
    slots = port.upper_slot.numpy()[:CAP_N]
    up = np.flatnonzero(levels >= 1)
    assert (slots[up] >= 0).all() and (port.levels.numpy()[up] == levels[up]).all()
    rows = port.upper_adj.numpy()[slots[up]]
    assert (rows[:256] >= 0).any(axis=1).all()
    past = rows[256:]
    assert np.isin(past[past >= 0], up[:256]).all()
