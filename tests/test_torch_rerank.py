"""The port's device rerank (tpuvec_torch.ops.rerank) vs the JAX package's
on the same numpy inputs: rerank_topk over an f32 and an int8 shadow,
expand_rerank_topk with and without a filter mask, _dedup_smallest, and
the chunked distance path.

Tie-free f32 data, so the top-k order is the same whatever the sort:
ids identical, distances within atol 1e-5 plus rtol 1e-6 (float32 sums
in different orders; over an int8 shadow, L2 and L1 distances run into
the thousands, where one float32 ulp is 1.2e-4).
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

from tpuvec.ops import rerank as jr  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec_torch.ops import rerank as tr  # noqa: E402
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


CAP, DIM, B, C, M0, K = 200, 48, 6, 24, 8, 10


def _inputs(seed, shadow_kind):
    """A shadow, coarse slots with -1s and repeats, their validity, queries,
    and an adjacency with -1 padding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((CAP, DIM)).astype(np.float32)
    if shadow_kind == "int8":  # per-row max-abs scale, as the binary probe keeps it
        x = np.round(x / np.abs(x).max(1, keepdims=True) * 127).astype(np.int8)
    slots = rng.integers(0, CAP, (B, C)).astype(np.int32)
    slots[:, -3:] = -1
    slots[:, 5] = slots[:, 4]  # a repeated slot
    ok = slots >= 0
    ok[0, :4] = False
    qf = rng.standard_normal((B, DIM)).astype(np.float32)
    adj0 = rng.integers(0, CAP, (CAP, M0)).astype(np.int32)
    adj0[:, -2:] = -1
    return x, slots, ok, qf, adj0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, want):
    d_t, i_t = got
    d_j, i_j = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2", "l1"])
@pytest.mark.parametrize("shadow_kind", ["f32", "int8"])
def test_rerank_topk_matches_jax(metric, shadow_kind):
    x, slots, ok, qf, _ = _inputs(1, shadow_kind)
    got = tr.rerank_topk(_t(x), _t(slots), _t(ok), _t(qf), metric=DistanceMetric(metric), k=K)
    want = jr.rerank_topk(jnp.asarray(x), jnp.asarray(slots), jnp.asarray(ok), jnp.asarray(qf),
                          metric=JaxMetric(metric), k=K)
    _check(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shadow_kind", ["f32", "int8"])
def test_expand_rerank_topk_matches_jax(masked, shadow_kind):
    """One-hop expansion: shared neighbours are deduped; with a filter
    mask, expanded neighbours are re-checked (coarse slots too)."""
    x, slots, ok, qf, adj0 = _inputs(2, shadow_kind)
    live = np.random.default_rng(3).random(CAP) > 0.3 if masked else None
    kw = dict(k=K)
    got = tr.expand_rerank_topk(
        _t(x), _t(adj0), _t(slots), _t(ok), _t(qf), metric=DistanceMetric.COSINE,
        filter_mask=None if live is None else _t(live), **kw,
    )
    want = jr.expand_rerank_topk(
        jnp.asarray(x), jnp.asarray(adj0), jnp.asarray(slots), jnp.asarray(ok), jnp.asarray(qf),
        metric=JaxMetric.COSINE, filter_mask=None if live is None else jnp.asarray(live), **kw,
    )
    _check(got, want)
    ids = got[1].numpy()
    for row in ids:
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == len(kept)
        if live is not None:
            assert live[kept].all()


def test_dedup_smallest_matches_jax():
    """Duplicate ids carry equal distances; invalid (+inf) entries and rows
    with fewer than k distinct ids pad with (+inf, -1)."""
    rng = np.random.default_rng(4)
    w = 37
    ids = rng.integers(0, 30, (B, w)).astype(np.int32)
    base = rng.permutation(1000)[:30].astype(np.float32) / 100
    dd = base[ids]
    dd[:, -5:] = np.inf
    dd[1, :] = np.inf
    dd[1, :3] = base[ids[1, :3]]
    got = tr._dedup_smallest(_t(dd), _t(ids), K)
    want = jr._dedup_smallest(jnp.asarray(dd), jnp.asarray(ids), K)
    _check(got, want)
    assert (got[1].numpy()[1, len(set(ids[1, :3].tolist())):] == -1).all()


def test_chunked_distances_equal_unchunked(monkeypatch):
    """Past RERANK_CHUNK_BYTES the candidate axis runs in chunks: the same
    distances and the same result."""
    x, slots, ok, qf, adj0 = _inputs(5, "f32")
    args = (_t(x), _t(adj0), _t(slots), _t(ok), _t(qf))
    kw = dict(metric=DistanceMetric.L2, k=K)
    whole = tr.expand_rerank_topk(*args, **kw)
    cand_width = C * (M0 + 1)
    monkeypatch.setattr(tr, "RERANK_CHUNK_BYTES", B * 128 * DIM * 4)  # 128-column chunks
    assert B * cand_width * DIM * 4 > tr.RERANK_CHUNK_BYTES
    chunked = tr.expand_rerank_topk(*args, **kw)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
