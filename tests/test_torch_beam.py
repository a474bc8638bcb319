"""The port's beam update (tpuvec_torch.ops.beam) vs the JAX package's
Pallas kernel and its plain reference, on the CPU.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against beam_update_plain there. Here the plain version is held against
the JAX functions, exactly (no tolerance): the update only compares and
moves values. The loop kernel's launch plan (``_loop_plan``, plain
Python) is checked at every shape the main path launches it at.
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
from tpuvec_torch.ops import beam as beam_ops  # noqa: E402
from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain, beam_update  # noqa: E402
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


# Every (form, B, EF, W, E, Dp, KP) the main path launches the loop kernel
# at (chip_smoke.py phases 3b-3d and 8): 100K / 1M f32 (Dp=768) search and
# construction; config 5 (Dp=384) search, construction and its flush's
# batches of 256; configs 3 and 4 (int8 Dp=1024, 32 words) and config 4's
# table; the masked forms at phase 7's and phase 8's shapes; the opt-in
# check's Dp=16384.
_PATH_SHAPES = [
    ("f32", 256, 64, 32, 1, 768, 0),
    ("f32", 1024, 256, 64, 2, 768, 0),
    ("f32", 256, 256, 64, 1, 384, 0),
    ("f32", 256, 512, 128, 2, 384, 0),
    ("f32", 17, 512, 128, 2, 384, 0),
    ("int8", 256, 64, 32, 1, 1024, 0),
    ("int8", 1024, 256, 64, 2, 1024, 0),
    ("words", 256, 64, 32, 1, 32, 0),
    ("words", 1024, 256, 64, 2, 32, 0),
    ("words", 256, 128, 32, 1, 32, 0),
    ("words", 256, 256, 64, 2, 32, 0),
    ("f32+mask", 256, 64, 32, 1, 768, 32),
    ("f32+mask", 256, 256, 32, 1, 768, 32),
    ("f32+mask", 256, 256, 64, 1, 384, 32),
    ("int8+mask", 256, 64, 32, 1, 1024, 128),
    ("words+mask", 256, 64, 32, 1, 32, 128),
    ("words+mask", 256, 128, 32, 1, 32, 256),
    ("f32", 4, 16, 16, 2, 16384, 0),
]


@pytest.mark.parametrize("form,b,ef,w,e,dp,kp", _PATH_SHAPES)
def test_loop_plan_fits_the_card(form, b, ef, w, e, dp, kp):
    """The plan fits a block's 227 KB with 1..W ring slots; the whole
    window where 2 blocks an SM still hold it at B <= 264 (one wave); never
    more waves than the kernel needs without a ring."""
    ring, smem, bps, waves = beam_ops._loop_plan(form, b, ef, w, e, dp, kp)
    row_bytes = dp * beam_ops._ELEM_BYTES[form.removesuffix("+mask")]
    kp_ = kp if form.endswith("+mask") else 0
    assert 1 <= ring <= w
    assert smem == beam_ops._loop_smem(row_bytes, ef, w, e, ring, kp_) <= 232_448
    assert 1 <= bps <= 4 and (smem + 1024) * bps <= 233_472
    assert waves * bps * 132 >= b

    def waves_at(ring_slots):
        slots_smem = beam_ops._loop_smem(row_bytes, ef, w, e, ring_slots, kp_)
        return -(-b // (132 * beam_ops._blocks_per_sm(slots_smem)))

    assert waves <= waves_at(0) or ring == 1
    whole = beam_ops._loop_smem(row_bytes, ef, w, e, w, kp_)
    if b <= 2 * 132 and (whole + 1024) * 2 <= 233_472:
        assert ring == w
    if ring < w:  # one more slot is past 227 KB or costs a wave
        more = beam_ops._loop_smem(row_bytes, ef, w, e, ring + 1, kp_)
        assert more > 232_448 or waves_at(ring + 1) > waves_at(0)


def test_loop_plan_refuses_rows_past_the_card():
    with pytest.raises(ValueError, match="more shared memory than the card gives"):
        beam_ops._loop_plan("f32", 4, 16, 16, 2, 65536)


def test_cpu_loop_is_the_plain_loop(monkeypatch):
    """beam_loop on CPU tensors is beam_loop_plain, bit for bit, unmasked and
    masked, and never plans or loads a kernel."""

    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU call reached the kernel's launch path")

    monkeypatch.setattr(beam_ops, "_loop_plan", no_kernel)
    monkeypatch.setattr("tpuvec_torch.kernels.load", no_kernel)
    rng = np.random.default_rng(8)
    cap, m0, b, ef = 300, 8, 6, 16
    x = rng.standard_normal((cap + b, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    vectors, q = torch.from_numpy(x[:cap]), torch.from_numpy(x[cap:])
    adj0 = torch.from_numpy(rng.integers(-1, cap, (cap, m0)).astype(np.int32))
    seeds = torch.from_numpy(rng.integers(0, cap, b).astype(np.int32))
    kw = dict(metric=DistanceMetric.COSINE, normalized=True, max_iters=12)
    seed_d = beam_ops.node_dist(kw["metric"], True, vectors, q, seeds[:, None])[:, 0]
    from tpuvec_torch.index.search import seed_beam

    mask = torch.from_numpy(rng.random(cap) < 0.5)
    for e, node_mask in ((1, None), (2, None), (1, mask)):
        extra = {} if node_mask is None else dict(node_mask=node_mask, k_out=3)
        args = (q, vectors, adj0, *seed_beam(seeds, seed_d, ef=ef, n_expand=e, **extra))
        loop_kw = kw if node_mask is None else dict(kw, node_mask=node_mask)
        got, want = beam_loop(*args, **loop_kw), beam_loop_plain(*args, **loop_kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2] > 0
