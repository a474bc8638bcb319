"""The level-0 beam: one iteration (dedup, merge, next frontier) and the
whole loop.

``beam_update`` is the port of the JAX package's Pallas kernel
(``tpuvec/ops/pallas_beam.py:beam_update``); ``beam_loop`` runs the whole
level-0 loop around it (``tpuvec/index/search.py:336-357``: adjacency
gather, vector gather, distance, update). On a CUDA tensor each launches
its hand-written kernel in ``tpuvec_torch/csrc/beam_update.cu``; on a CPU
tensor each runs its plain torch version (``beam_update_plain``,
``beam_loop_plain``).

Contract of one iteration (B queries, EF a power of two, W window
entries, E = n_expand):

  in:  beam_d f32[B, EF] sorted ascending, beam_i i32[B, EF],
       beam_x bool[B, EF] (expanded), nbrs i32[B, W] gathered neighbor
       ids (-1 = none), nd f32[B, W] their internal distances
  out: beam_d', beam_i', beam_x' (the EF smallest of beam and fresh
       window, stable: beam before window, window in order), cand i32[B, E]
       (the next frontier, -1 padded), active bool[B]

A window entry is fresh when its id is >= 0, not in the beam, and (E > 1)
not equal to an earlier window entry; the rest enter as (+inf, -1).
+inf slots are marked expanded. The next frontier is the first E
unexpanded slots, selected only when the best unexpanded distance is no
worse than the beam's last entry (``active``). An inactive query's update
is a fixed point: its window is all -1, so its beam is unchanged.

The loop repeats the iteration with the window of the frontier's
adjacency rows (``adj0[cand]``, W = E * M0) and their internal distances
to the query, until every query is inactive or ``max_iters`` iterations
have run. Since an inactive query's update is a fixed point, the kernel
runs each query on its own (one block each) and gives the same beams.

The kernel has a form for each kind of row the index stores: f32, int8
(exact int32 sums) and packed bit words (int32, Hamming). The form follows
the rows' dtype (``_loop_form``), and the launches of each form are
counted in ``beam_loop.form_launches``.

Filtered search (``node_mask`` [cap] bool, the JAX package's ``body_m``,
``tpuvec/index/search.py:295-316`` and ``:363-383``): the beam and its
frontier run exactly as above (filtered nodes still route), and a
separate result buffer res_d/res_i [B, KP] (KP = next_pow2(max(2 k, 4)),
seeded by ``index/search.py:seed_beam``, sorted ascending) collects the
mask-passing fresh entries of every expanded window. Each iteration,
before the beam merge, the window with every entry that is not fresh or
fails the mask set to (+inf, -1) is merged into the buffer by the same
stable merge (buffer before window), keeping KP. The buffer is not
deduplicated inside the loop: a node evicted from the beam and met again
is collected twice. After the loop the first occurrence of each id is
kept (the others become (+inf, -1)) and the buffer is sorted ascending,
stably. Each row form has a masked form of the kernel (``f32+mask``,
``int8+mask``, ``words+mask`` in ``form_launches``).
"""

from __future__ import annotations

import torch

from tpuvec_torch.ops.distance import gathered_internal
from tpuvec_torch.types import DistanceMetric

__all__ = [
    "beam_update", "beam_update_plain", "beam_loop", "beam_loop_plain",
    "frontier", "node_dist",
]

_INF = float("inf")

# The plain loop reads `active.any()` back to the host only every this many
# iterations. Iterating past the point where every query went inactive
# changes nothing (an inactive query's update is a fixed point), so the
# result equals a loop that checks every time.
_ACTIVE_CHECK_EVERY = 8


def frontier(sd: torch.Tensor, si: torch.Tensor, sx: torch.Tensor, n_expand: int):
    """(sel [B, EF], cand [B, E], active [B]) of a sorted beam."""
    b, efp = sd.shape
    finite = torch.isfinite(sd)
    unexp = ~sx & finite
    rank = torch.cumsum(unexp.to(torch.int32), dim=1)
    cd_best = torch.where(unexp, sd, _INF).amin(dim=1)
    worst = sd[:, efp - 1]
    active = torch.isfinite(cd_best) & ((cd_best <= worst) | ~torch.isfinite(worst))
    sel = unexp & (rank <= n_expand) & active[:, None]
    # selected slots are exactly the first E unexpanded ones, so their rank
    # is their frontier column; the others land in a spill column
    col = torch.where(sel, rank - 1, n_expand).to(torch.int64)
    cand = torch.full((b, n_expand + 1), -1, dtype=torch.int32, device=sd.device)
    cand.scatter_(1, col, torch.where(sel, si, -1))
    return sel, cand[:, :n_expand].contiguous(), active


def _fresh(beam_i, nbrs, n_expand):
    """fresh[b, w]: nbrs[b, w] is an id, not in the beam and (E > 1) not
    equal to an earlier window entry."""
    dup = (nbrs[:, :, None] == beam_i[:, None, :]).any(-1)
    if n_expand > 1:
        pos = torch.arange(nbrs.shape[1], device=nbrs.device)
        earlier = (pos[:, None] > pos[None, :])[None]
        dup |= ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(-1)
    return (nbrs >= 0) & ~dup


def _merge_smallest(d, i, new_d, new_i, keep):
    """The ``keep`` smallest of (d, i) ++ (new_d, new_i) by a stable sort:
    ties keep the old entries first, the new ones in their order."""
    sd, order = torch.sort(torch.cat([d, new_d], dim=1), dim=1, stable=True)
    order = order[:, :keep]
    return sd[:, :keep].contiguous(), torch.gather(torch.cat([i, new_i], dim=1), 1, order), order


def beam_update_plain(beam_d, beam_i, beam_x, nbrs, nd, *, n_expand=1):
    """Plain torch form of ``beam_update``: the tests' and the card
    check's yardstick for the kernel."""
    efp = beam_d.shape[1]
    fresh = _fresh(beam_i, nbrs, n_expand)
    sd, si, order = _merge_smallest(
        beam_d, beam_i, torch.where(fresh, nd, _INF), torch.where(fresh, nbrs, -1), efp
    )
    x = torch.cat([beam_x, torch.zeros_like(fresh)], dim=1)
    sx = torch.gather(x, 1, order) | ~torch.isfinite(sd)
    sel, cand, active = frontier(sd, si, sx, n_expand)
    return sd, si, sx | sel, cand, active


def _dims(t: torch.Tensor, ndim: int) -> tuple:
    return tuple(t.shape) if t.dim() == ndim else (-1,) * ndim


def _expect(fn: str, device: torch.device, want) -> None:
    """Raise ValueError unless every (tensor, dtype, shape) matches and lies
    contiguous on ``device``."""
    for t, dtype, shape in want:
        if t.device != device:
            raise ValueError(f"{fn}: all tensors must be on one device")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{fn}: expected {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: tensors must be contiguous")


def _check_beam(fn, efp, w, n_expand):
    if efp < 1 or efp & (efp - 1) or not (1 <= n_expand <= min(efp, 64)) or w < 1:
        raise ValueError(f"{fn}: bad shape EF={efp}, W={w}, E={n_expand}")
    if efp + w > 2048:  # the kernels' shared memory holds EF + W entries
        raise ValueError(f"{fn}: EF + W = {efp + w} exceeds 2048")


def _check(beam_d, beam_i, beam_x, nbrs, nd, n_expand):
    b, efp = _dims(beam_d, 2)
    w = _dims(nbrs, 2)[1]
    _expect("beam_update", beam_d.device, [
        (beam_d, torch.float32, (b, efp)),
        (beam_i, torch.int32, (b, efp)),
        (beam_x, torch.bool, (b, efp)),
        (nbrs, torch.int32, (b, w)),
        (nd, torch.float32, (b, w)),
    ])
    _check_beam("beam_update", efp, w, n_expand)


# A launcher's return code when a block would need more shared memory than
# the card gives (kSmemTooLarge in csrc/beam_update.cu).
_SMEM_TOO_LARGE = -1


def _raise_for(fn, kernels, lib, rc):
    if rc == _SMEM_TOO_LARGE:
        raise ValueError(f"{fn}: a block needs more shared memory than the card gives")
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: {kernels.error_string(lib, rc)}")


def beam_update(beam_d, beam_i, beam_x, nbrs, nd, *, n_expand=1):
    """One beam iteration (see the module docstring). CPU tensors run the
    plain version; CUDA tensors launch the kernel, or raise."""
    _check(beam_d, beam_i, beam_x, nbrs, nd, n_expand)
    dev = beam_d.device
    if dev.type == "cpu":
        return beam_update_plain(beam_d, beam_i, beam_x, nbrs, nd, n_expand=n_expand)
    if dev.type != "cuda":
        raise ValueError(f"beam_update: unsupported device {dev}")
    from tpuvec_torch import kernels

    lib = kernels.load("beam_update")
    b, efp = beam_d.shape
    w = nbrs.shape[1]
    out_d = torch.empty_like(beam_d)
    out_i = torch.empty_like(beam_i)
    out_x = torch.empty_like(beam_x)
    cand = torch.empty((b, n_expand), dtype=torch.int32, device=dev)
    active = torch.empty((b,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpuvec_beam_update(
            beam_d.data_ptr(), beam_i.data_ptr(), beam_x.data_ptr(),
            nbrs.data_ptr(), nd.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), out_x.data_ptr(),
            cand.data_ptr(), active.data_ptr(),
            b, efp, w, n_expand, stream,
        )
    _raise_for("beam_update", kernels, lib, rc)
    beam_update.launches += 1
    return out_d, out_i, out_x, cand, active


beam_update.launches = 0


def node_dist(metric, normalized, vectors, q, ids):
    """Internal distance q[b] -> vectors[ids[b, m]] [B, M]; ids < 0 -> inf."""
    vecs = vectors[ids.clamp_min(0)]  # clamp: ids may be -1
    d = gathered_internal(metric, q, vecs, normalized=normalized)
    return torch.where(ids >= 0, d, _INF)


def beam_loop_plain(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active,
                    res_d=None, res_i=None, *, metric, normalized, max_iters,
                    node_mask=None):
    """Plain torch form of ``beam_loop``: the whole batch in lock step, one
    ``beam_update_plain`` per iteration; with ``node_mask``, the result
    buffer res_d/res_i collects the mask-passing fresh entries first (the
    module docstring)."""
    b, e = cand.shape
    w = e * adj0.shape[1]
    kp = 0 if node_mask is None else res_d.shape[1]
    count = torch.zeros((b,), dtype=torch.int32, device=q.device)
    for it in range(max_iters):
        if it % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        count += active
        ok = (cand >= 0) & active[:, None]
        nbrs = adj0[cand.clamp_min(0)]  # [B, E, M0]
        nbrs = torch.where(ok[:, :, None], nbrs, -1).reshape(b, w)
        nd = node_dist(metric, normalized, vectors, q, nbrs)
        if node_mask is not None:
            allow = _fresh(beam_i, nbrs, e) & node_mask[nbrs.clamp_min(0)]
            res_d, res_i, _ = _merge_smallest(
                res_d, res_i, torch.where(allow, nd, _INF), torch.where(allow, nbrs, -1), kp
            )
        beam_d, beam_i, beam_x, cand, active = beam_update_plain(
            beam_d, beam_i, beam_x, nbrs, nd, n_expand=e
        )
    iters = int(count.max()) if b else 0
    if node_mask is None:
        return beam_d, beam_i, iters
    # keep the first (sorted) occurrence of each id, then sort stably
    pos = torch.arange(kp, device=q.device)
    earlier = (pos[:, None] > pos[None, :])[None]
    dup = ((res_i[:, :, None] == res_i[:, None, :]) & earlier).any(-1) & (res_i >= 0)
    res_d, order = torch.sort(torch.where(dup, _INF, res_d), dim=1, stable=True)
    res_i = torch.gather(torch.where(dup, -1, res_i), 1, order)
    return res_d, res_i, iters


# The kernel's row forms by row dtype: (name, elements per 16-byte load,
# the form's code in csrc/beam_update.cu)
_ROWS = {torch.float32: ("f32", 4, 0), torch.int8: ("int8", 16, 1), torch.int32: ("words", 4, 2)}


# Bytes of one element of each row form (a load is 16 bytes).
_ELEM_BYTES = {name: 16 // per_load for name, per_load, _ in _ROWS.values()}

# The H100 limits the loop kernel's launch plan is made for: SMs, the
# shared memory a block may opt in to (227 KB) and an SM holds (228 KB),
# the shared memory the card reserves for each block, and the blocks an SM
# runs at the kernel's 64 registers a thread (__launch_bounds__(256, 4) in
# csrc/beam_update.cu).
_SMS = 132
_SMEM_PER_BLOCK = 232_448
_SMEM_PER_SM = 233_472
_SMEM_RESERVED = 1_024
_BLOCKS_BY_REGISTERS = 4


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _loop_smem(row_bytes: int, ef: int, w: int, e: int, ring: int, kp: int) -> int:
    """Shared memory of one block of the loop kernel, array for array as
    csrc/beam_update.cu:layout carves it (each array 16-byte aligned); kp
    is 0 for the unmasked forms."""
    sizes = [row_bytes, row_bytes * ring, 8 * ring,  # query row, ring slots, their mbarriers
             4 * ef, 4 * ef, 4 * ef, 4 * ef,  # beam in / out: distances, ids
             4 * w, 4 * w, 4 * w, 4 * w,  # window ids; fresh ids, positions, distances
             4 * e, 16, ef, ef]  # frontier, scalars, expanded flags in / out
    if kp:
        sizes += [w, 4 * kp, 4 * kp, 4 * kp, 4 * kp]  # mask flags, result buffer
    return sum(_round16(x) for x in sizes)


def _blocks_per_sm(smem: int) -> int:
    return min(_BLOCKS_BY_REGISTERS, _SMEM_PER_SM // (smem + _SMEM_RESERVED))


def _loop_plan(form: str, b: int, ef: int, w: int, e: int, dp: int, kp: int = 0):
    """Launch plan of the loop kernel for B queries of form ``form`` ("f32",
    "int8", "words", each optionally "+mask"): (ring_slots, smem_bytes,
    blocks_per_sm, waves).

    The ring of row slots takes the whole window (W slots) when the
    launch's blocks still fit in the waves the kernel needs without a ring;
    else the most slots that keep those waves; and at least one. Raises
    ValueError when a block with one slot needs more shared memory than the
    card gives."""
    row, masked = form.removesuffix("+mask"), form.endswith("+mask")
    row_bytes = dp * _ELEM_BYTES[row]
    kp = kp if masked else 0

    def smem(ring):
        return _loop_smem(row_bytes, ef, w, e, ring, kp)

    def waves(bps):
        return -(-max(b, 1) // (_SMS * bps))

    if smem(1) > _SMEM_PER_BLOCK:
        raise ValueError(
            f"beam_loop: a block needs more shared memory than the card gives ({smem(1)} bytes "
            f"with one {row_bytes}-byte row slot, the most is {_SMEM_PER_BLOCK})"
        )
    need = -(-max(b, 1) // (_SMS * waves(_blocks_per_sm(smem(0)))))  # blocks an SM must hold
    budget = min(_SMEM_PER_BLOCK, _SMEM_PER_SM // need - _SMEM_RESERVED)
    ring = min(w, max(0, (budget - smem(0)) // (row_bytes + 8)))
    while ring > 0 and smem(ring) > budget:
        ring -= 1
    ring = max(ring, 1)
    bps = _blocks_per_sm(smem(ring))
    return ring, smem(ring), bps, waves(bps)


def _loop_form(metric: DistanceMetric, normalized: bool, row_dtype: torch.dtype):
    """(row form, distance form) of the kernel for rows of ``row_dtype``.
    Distance forms: 0 = squared L2 (L2, normalized cosine), 1 = L1,
    2 = cosine 1 - sim, on f32 or int8 rows; 3 = Hamming, on packed words
    (int32 holding the uint32 bits)."""
    if row_dtype not in _ROWS:
        raise ValueError(f"beam_loop: rows of {row_dtype} are not a row form of the kernel")
    row = _ROWS[row_dtype][0]
    if (metric is DistanceMetric.HAMMING) != (row == "words"):
        raise ValueError(
            f"beam_loop: {metric.value} distances do not apply to {row_dtype} rows "
            "(Hamming runs on packed int32 words, every other metric on f32 or int8)"
        )
    if metric is DistanceMetric.HAMMING:
        return row, 3
    if metric is DistanceMetric.L2 or (metric is DistanceMetric.COSINE and normalized):
        return row, 0
    if metric is DistanceMetric.L1:
        return row, 1
    if metric is DistanceMetric.COSINE:
        return row, 2
    raise ValueError(f"unsupported metric {metric}")


def _check_loop(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d, res_i,
                metric, normalized, max_iters, node_mask):
    if q.dtype != vectors.dtype:
        raise ValueError(f"beam_loop: queries are {q.dtype} but rows are {vectors.dtype}")
    row, form = _loop_form(metric, normalized, vectors.dtype)
    b, efp = _dims(beam_d, 2)
    dp = _dims(q, 2)[1]
    cap, m0 = _dims(adj0, 2)
    e = _dims(cand, 2)[1]
    want = [
        (q, vectors.dtype, (b, dp)),
        (vectors, vectors.dtype, (cap, dp)),
        (adj0, torch.int32, (cap, m0)),
        (beam_d, torch.float32, (b, efp)),
        (beam_i, torch.int32, (b, efp)),
        (beam_x, torch.bool, (b, efp)),
        (cand, torch.int32, (b, e)),
        (active, torch.bool, (b,)),
    ]
    if (node_mask is None) != (res_d is None) or (res_d is None) != (res_i is None):
        raise ValueError("beam_loop: node_mask and the result buffer res_d, res_i go together")
    if node_mask is not None:
        kp = _dims(res_d, 2)[1]
        if kp < 1:
            raise ValueError("beam_loop: the result buffer has no slot")
        want += [
            (node_mask, torch.bool, (cap,)),
            (res_d, torch.float32, (b, kp)),
            (res_i, torch.int32, (b, kp)),
        ]
    _expect("beam_loop", beam_d.device, want)
    _check_beam("beam_loop", efp, e * m0, e)
    per_load = _ROWS[vectors.dtype][1]
    if dp < per_load or dp % per_load:  # the kernel reads rows in 16-byte loads
        raise ValueError(f"beam_loop: {row} row width {dp} is not a multiple of {per_load}")
    if max_iters < 0:
        raise ValueError(f"beam_loop: max_iters = {max_iters} < 0")
    return row if node_mask is None else row + "+mask", form


def beam_loop(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d=None,
              res_i=None, *, metric: DistanceMetric, normalized: bool, max_iters: int,
              node_mask: torch.Tensor | None = None):
    """The level-0 loop from a seeded beam and its first frontier.

    q [B, Dp] prepared queries and vectors [cap, Dp] the graph's rows, both
    f32, int8, or int32 packed words (Hamming); adj0 i32[cap, M0] the
    graph's; beam_d/beam_i/beam_x [B, EF] the beam with the frontier
    already marked expanded; cand i32[B, E] and active bool[B] that frontier.
    Returns (beam_d [B, EF], beam_i [B, EF], iters): iters is the most
    iterations any query ran while active.

    Filtered (``node_mask`` bool [cap], with the seeded result buffer
    res_d f32 / res_i i32 [B, KP] from ``index/search.py:seed_beam``):
    returns (res_d [B, KP], res_i [B, KP], iters), the mask-passing nodes
    met, deduplicated and ascending (the module docstring).

    CPU tensors run the plain version; CUDA tensors launch the kernel (one
    block per query, its ring of row slots sized by ``_loop_plan``), or
    raise.
    """
    form_name, form = _check_loop(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active,
                                  res_d, res_i, metric, normalized, max_iters, node_mask)
    dev = beam_d.device
    if dev.type == "cpu":
        return beam_loop_plain(
            q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d, res_i,
            metric=metric, normalized=normalized, max_iters=max_iters, node_mask=node_mask,
        )
    if dev.type != "cuda":
        raise ValueError(f"beam_loop: unsupported device {dev}")
    if q.data_ptr() % 16 or vectors.data_ptr() % 16:
        raise ValueError("beam_loop: q and vectors must start on a 16-byte boundary")
    from tpuvec_torch import kernels

    lib = kernels.load("beam_update")
    b, efp = beam_d.shape
    m0 = adj0.shape[1]
    e = cand.shape[1]
    dp = q.shape[1]
    if node_mask is None:
        kp, mask_p, res_d_p, res_i_p = 0, None, None, None
        out_d, out_i = torch.empty_like(beam_d), torch.empty_like(beam_i)
    else:
        kp, mask_p, res_d_p, res_i_p = res_d.shape[1], node_mask.data_ptr(), res_d.data_ptr(), res_i.data_ptr()
        out_d, out_i = torch.empty_like(res_d), torch.empty_like(res_i)
    ring = _loop_plan(form_name, b, efp, e * m0, e, dp, kp)[0]
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpuvec_beam_search_level0(
            q.data_ptr(), vectors.data_ptr(), adj0.data_ptr(),
            beam_d.data_ptr(), beam_i.data_ptr(), beam_x.data_ptr(),
            cand.data_ptr(), active.data_ptr(), mask_p, res_d_p, res_i_p,
            out_d.data_ptr(), out_i.data_ptr(), iters.data_ptr(),
            b, efp, m0, e, dp, _ROWS[vectors.dtype][2], form, max_iters, kp, ring, stream,
        )
    _raise_for(f"beam_loop ({form_name} rows, EF={efp}, W={e * m0}, Dp={dp}, KP={kp})",
               kernels, lib, rc)
    beam_loop.launches += 1
    beam_loop.form_launches[form_name] += 1
    return out_d, out_i, int(iters.max()) if b else 0


beam_loop.launches = 0  # all forms
# per form: each row form, and its masked form
beam_loop.form_launches = {
    name + masked: 0 for name, _, _ in _ROWS.values() for masked in ("", "+mask")
}
