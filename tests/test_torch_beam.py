"""The port's beam update (tpuvec_torch.ops.beam) vs the JAX package's
Pallas kernel and its plain reference, on the CPU.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against beam_update_plain there. Here the plain version is held against
the JAX functions, exactly (no tolerance): the update only compares and
moves values.
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

from tpuvec.ops import pallas_beam  # noqa: E402
from tpuvec.ops.sort import rank_topk_merge_sorted  # noqa: E402
from tpuvec_torch.index.build import build_graph  # noqa: E402
from tpuvec_torch.index.graph import allocate, config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.ops.beam import beam_update  # noqa: E402


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


_NAMES = ["beam_d", "beam_i", "beam_x", "cand", "active"]
_jax_reference = jax.jit(pallas_beam.beam_update_reference, static_argnames=("n_expand",))


def _inputs(seed, b, efp, w, ties=False):
    """A sorted beam with +inf padding, and a window that repeats beam ids,
    repeats its own ids and holds -1s. Tie-free unless ``ties``."""
    rng = np.random.default_rng(seed)
    n_live = rng.integers(efp // 4, efp, size=b)
    if ties:
        vals = rng.integers(0, 6, size=(b, efp + w)).astype(np.float32)
    else:
        vals = np.stack([rng.permutation(efp + w) for _ in range(b)]).astype(np.float32)
        vals = vals / 7.0 + 0.5
    bd = np.sort(vals[:, :efp], axis=1)
    bi = np.stack([rng.permutation(10 * efp)[:efp] for _ in range(b)]).astype(np.int32)
    bx = rng.random((b, efp)) > 0.6
    pad = np.arange(efp)[None, :] >= n_live[:, None]
    bd[pad], bi[pad], bx[pad] = np.inf, -1, True
    nbrs = rng.integers(0, 10 * efp, size=(b, w)).astype(np.int32)
    from_beam = rng.random((b, w)) < 0.3
    nbrs = np.where(from_beam, bi[np.arange(b)[:, None], rng.integers(0, efp, (b, w))], nbrs)
    nbrs[:, w // 2 :: 5] = nbrs[:, 1 : 1 + len(range(w // 2, w, 5))]  # repeats in the window
    nbrs[rng.random((b, w)) < 0.1] = -1
    nd = vals[:, efp:].copy()
    return bd, bi, bx, nbrs.astype(np.int32), nd


def _port(args, e):
    return beam_update(*(torch.from_numpy(a) for a in args), n_expand=e)


def _assert_same(port_out, jax_out):
    for name, p, j in zip(_NAMES, port_out, jax_out):
        p, j = p.numpy(), np.asarray(j)
        assert p.dtype == j.dtype, name
        assert np.array_equal(p, j), name


@pytest.mark.parametrize("b,efp,w", [(8, 64, 32), (8, 256, 64)])
@pytest.mark.parametrize("e", [1, 2])
def test_plain_matches_jax_reference(b, efp, w, e):
    args = _inputs(100 * e + efp, b, efp, w)
    _assert_same(_port(args, e), _jax_reference(*map(jnp.asarray, args), n_expand=e))


def test_plain_matches_pallas_interpret():
    args = _inputs(5, 8, 64, 64)
    ker = pallas_beam.beam_update(*map(jnp.asarray, args), n_expand=2, interpret=True)
    _assert_same(_port(args, 2), ker)


def test_ties_follow_the_stable_rank_merge(monkeypatch):
    """With ties the Pallas kernel's bitonic merge is unstable; the port
    follows the JAX search path's stable rank merge, composed here with
    the kernel's own dedup and frontier code."""

    def rank_merge(beam_d, beam_i, beam_x, new_d, new_i, impl=None):
        return rank_topk_merge_sorted(beam_d, beam_i, beam_x, new_d, new_i)

    monkeypatch.setattr(pallas_beam, "bitonic_topk_merge_sorted", rank_merge)
    for e in (1, 2):
        args = _inputs(11 + e, 8, 64, 64, ties=True)
        ref = pallas_beam._beam_update_math(*map(jnp.asarray, args), e)
        _assert_same(_port(args, e), ref)


def test_inactive_query_is_a_fixed_point():
    """An inactive query's window is all -1 (the search loop masks it), and
    its update changes nothing: so the loop may run on past the point
    where every query went inactive."""
    bd, bi, bx, _, nd = _inputs(3, 8, 64, 32)
    bx[:] = True  # nothing left to expand: inactive
    nbrs = np.full_like(bi[:, :32], -1)
    out = _port((bd, bi, bx, nbrs, nd), 2)
    assert np.array_equal(out[0].numpy(), bd)
    assert np.array_equal(out[1].numpy(), bi)
    assert np.array_equal(out[2].numpy(), bx)
    assert (out[3].numpy() == -1).all() and not out[4].numpy().any()


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_for(32, cap=128, params=HnswParams(m=4, max_m0=8, ef_construction=16))
    x = np.ones((4, 32), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        allocate(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph(cfg, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_vectors(cfg, x)
    assert allocate(cfg, device="cpu").adj0.device.type == "cpu"
    # a tensor that is not on the CPU never reaches the plain version
    meta = [torch.from_numpy(a).to("meta") for a in _inputs(0, 2, 16, 8)]
    monkeypatch.setattr("tpuvec_torch.ops.beam.beam_update_plain", None)
    with pytest.raises(ValueError, match="unsupported device"):
        beam_update(*meta)
