"""One level-0 beam-search iteration: dedup, merge and next frontier.

``beam_update`` is the port of the JAX package's Pallas kernel
(``tpuvec/ops/pallas_beam.py:beam_update``). On a CUDA tensor it launches
the hand-written kernel in ``tpuvec_torch/csrc/beam_update.cu``; on a CPU
tensor it runs ``beam_update_plain``, the same function in plain torch.

Contract (B queries, EF a power of two, W window entries, E = n_expand):

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
"""

from __future__ import annotations

import torch

__all__ = ["beam_update", "beam_update_plain", "frontier"]

_INF = float("inf")


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


def beam_update_plain(beam_d, beam_i, beam_x, nbrs, nd, *, n_expand=1):
    """Plain torch form of ``beam_update``: the tests' and the card
    check's yardstick for the kernel."""
    efp = beam_d.shape[1]
    w = nbrs.shape[1]
    dup = (nbrs[:, :, None] == beam_i[:, None, :]).any(-1)
    if n_expand > 1:
        pos = torch.arange(w, device=nbrs.device)
        earlier = (pos[:, None] > pos[None, :])[None]
        dup |= ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(-1)
    fresh = (nbrs >= 0) & ~dup
    d = torch.cat([beam_d, torch.where(fresh, nd, _INF)], dim=1)
    i = torch.cat([beam_i, torch.where(fresh, nbrs, -1)], dim=1)
    x = torch.cat([beam_x, torch.zeros_like(fresh)], dim=1)
    sd, order = torch.sort(d, dim=1, stable=True)
    order = order[:, :efp]
    sd = sd[:, :efp].contiguous()
    si = torch.gather(i, 1, order)
    sx = torch.gather(x, 1, order) | ~torch.isfinite(sd)
    sel, cand, active = frontier(sd, si, sx, n_expand)
    return sd, si, sx | sel, cand, active


def _check(beam_d, beam_i, beam_x, nbrs, nd, n_expand):
    b, efp = beam_d.shape
    w = nbrs.shape[1] if nbrs.dim() == 2 else -1
    want = [
        (beam_d, torch.float32, (b, efp)),
        (beam_i, torch.int32, (b, efp)),
        (beam_x, torch.bool, (b, efp)),
        (nbrs, torch.int32, (b, w)),
        (nd, torch.float32, (b, w)),
    ]
    for t, dtype, shape in want:
        if t.device != beam_d.device:
            raise ValueError("beam_update: all tensors must be on one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"beam_update: expected {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError("beam_update: tensors must be contiguous")
    if efp & (efp - 1) or not (1 <= n_expand <= min(efp, 64)) or w < 1:
        raise ValueError(f"beam_update: bad shape EF={efp}, W={w}, E={n_expand}")
    if efp + w > 2048:  # the kernel's shared memory holds EF + W entries
        raise ValueError(f"beam_update: EF + W = {efp + w} exceeds 2048")


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
    if rc != 0:
        raise RuntimeError(f"beam_update kernel launch failed: {kernels.error_string(lib, rc)}")
    beam_update.launches += 1
    return out_d, out_i, out_x, cand, active


beam_update.launches = 0
