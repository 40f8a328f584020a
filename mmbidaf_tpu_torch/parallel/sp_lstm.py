"""Sequence-parallel BiLSTM: the time axis sharded over a mesh axis — the
port of ``mmbidaf_tpu.parallel.sp_lstm``.

A time shard cannot start until its left neighbour's final state arrives,
so the batch splits into ``M`` microbatches that run as a wavefront:

- rank ``d`` of ``D`` holds the time chunk ``[d·T/D, (d+1)·T/D)``;
- in round ``r`` it runs forward-direction microbatch ``r - d`` and
  backward-direction microbatch ``r - (D-1-d)`` on its chunk (the reverse
  pipeline fills from the other end);
- after each round the (h, c) carries go one rank along the ``seq`` ring,
  +1 for the forward direction and −1 for the backward one, in one batch
  of point-to-point sends and receives (``mesh.exchange``). A rank outside
  the wavefront skips its compute; the pipeline heads start from zeros.

``M + D - 1`` rounds of ``T/D`` steps. pack_padded semantics hold exactly:
the per-step freeze at masked positions carries the last valid state across
chunk boundaries inside the carry. Outputs stay time-sharded; final states
are not returned (the audio tower uses the outputs only).

Training: the wavefront is one ``torch.autograd.Function``. Its backward
runs the wavefront in reverse — each rank recomputes a chunk's scan from the
carry it received in the forward, takes the chunk's gradients by autograd
and sends the carry's gradient back along the ring (−1 forward, +1
backward) — so every rank makes the same exchanges in the same order.
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.ops.common import mm
from mmbidaf_tpu_torch.ops.lstm import lstm_cell
from mmbidaf_tpu_torch.parallel.mesh import Mesh, exchange


def _local_scan(w_h, gates, mask, h, c):
    """Masked LSTM scan over one chunk from the carry ``(h, c)``: ``gates
    [Bm, Tc, 4h]``, ``mask [Bm, Tc]`` → ``(out [Bm, Tc, h], h, c)``, with
    ``ops.lstm.lstm_scan``'s step (freeze at pads, zeros out)."""
    outs = []
    for t in range(gates.shape[1]):
        h_new, c_new = lstm_cell(gates[:, t], h, c, w_h)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outs.append(h_new * m)
    return torch.stack(outs, dim=1), h, c


class _Ring:
    """The ``seq`` neighbours of this rank."""

    def __init__(self, mesh: Mesh, axis: str):
        self.D = mesh.shape[axis]
        self.d = mesh.coords[axis]
        self.group = mesh.group(axis)
        self.next = mesh.peer(axis, self.d + 1) if self.d + 1 < self.D else None
        self.prev = mesh.peer(axis, self.d - 1) if self.d > 0 else None

    def hop(self, to_next: torch.Tensor, to_prev: torch.Tensor):
        """Send ``to_next`` to rank d+1 and ``to_prev`` to d−1; return what
        d−1 sent forward and d+1 sent back (zeros at the ends)."""
        from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
        sends, recvs = [], []
        if self.next is not None:
            sends.append((to_next, self.next))
            recvs.append((from_next, self.next))
        if self.prev is not None:
            sends.append((to_prev, self.prev))
            recvs.append((from_prev, self.prev))
        if self.D > 1:
            exchange(sends, recvs, self.group)
        return from_prev, from_next


def _wavefront(ring: _Ring, M: int, g_f, g_b, w_hf, w_hb, m_f, m_b):
    """The forward wavefront on microbatched ``[M, Bm, Tc, ·]`` inputs →
    ``(out_f, out_b [M, Bm, Tc, h], init_f, init_b)``; ``init_*[m]`` is the
    stacked (h, c) carry microbatch ``m`` started from on this rank."""
    D, d = ring.D, ring.d
    _, Bm, Tc, _ = g_f.shape
    h_dim = w_hf.shape[0]
    zeros = g_f.new_zeros((2, Bm, h_dim))
    out_f, out_b = g_f.new_zeros((M, Bm, Tc, h_dim)), g_b.new_zeros((M, Bm, Tc, h_dim))
    init_f, init_b = g_f.new_zeros((M, 2, Bm, h_dim)), g_b.new_zeros((M, 2, Bm, h_dim))
    sf, sb = zeros, zeros
    for r in range(M + D - 1):
        i_f, i_b = r - d, r - (D - 1 - d)
        nf = nb = zeros
        if 0 <= i_f < M:
            init_f[i_f] = sf
            out_f[i_f], h, c = _local_scan(w_hf, g_f[i_f], m_f[i_f], sf[0], sf[1])
            nf = torch.stack([h, c])
        if 0 <= i_b < M:
            init_b[i_b] = sb
            out_b[i_b], h, c = _local_scan(w_hb, g_b[i_b], m_b[i_b], sb[0], sb[1])
            nb = torch.stack([h, c])
        if r < M + D - 2:
            # the forward carry goes to d+1, the backward one to d-1; the
            # pipeline heads receive zeros, the LSTM's initial state
            sf, sb = ring.hop(nf, nb)
    return out_f, out_b, init_f, init_b


class _Wavefront(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, M, g_f, g_b, w_hf, w_hb, m_f, m_b):
        with torch.no_grad():
            out_f, out_b, init_f, init_b = _wavefront(ring, M, g_f, g_b, w_hf, w_hb, m_f, m_b)
        ctx.ring, ctx.M = ring, M
        ctx.save_for_backward(g_f, g_b, w_hf, w_hb, m_f, m_b, init_f, init_b)
        return out_f, out_b

    @staticmethod
    def backward(ctx, d_out_f, d_out_b):
        g_f, g_b, w_hf, w_hb, m_f, m_b, init_f, init_b = ctx.saved_tensors
        ring, M = ctx.ring, ctx.M
        D, d = ring.D, ring.d
        dg_f, dg_b = torch.zeros_like(g_f), torch.zeros_like(g_b)
        dw_hf, dw_hb = torch.zeros_like(w_hf), torch.zeros_like(w_hb)
        zeros = init_f.new_zeros(init_f.shape[1:])
        # gradient of the carry each chunk ended with: from d+1 (forward
        # direction) and d-1 (backward direction); the chain's last rank
        # starts from zero (final states are not outputs)
        df, db = zeros, zeros

        def chunk_grads(w_h, gates, mask, init, d_out, d_carry):
            with torch.enable_grad():
                gates = gates.detach().requires_grad_()
                w = w_h.detach().requires_grad_()
                h0, c0 = (init[0].detach().requires_grad_(), init[1].detach().requires_grad_())
                out, h, c = _local_scan(w, gates, mask, h0, c0)
                dg, dw, dh0, dc0 = torch.autograd.grad(
                    (out, h, c), (gates, w, h0, c0), (d_out, d_carry[0], d_carry[1]))
            return dg, dw, torch.stack([dh0, dc0])

        for s in range(M + D - 1):
            # mirror of the forward schedule: forward-direction microbatches
            # start at rank D-1, backward-direction ones at rank 0
            j_f, j_b = s - (D - 1 - d), s - d
            nf = nb = zeros
            if 0 <= j_f < M:
                dg, dw, nf = chunk_grads(w_hf, g_f[j_f], m_f[j_f], init_f[j_f], d_out_f[j_f], df)
                dg_f[j_f] = dg
                dw_hf += dw
            if 0 <= j_b < M:
                dg, dw, nb = chunk_grads(w_hb, g_b[j_b], m_b[j_b], init_b[j_b], d_out_b[j_b], db)
                dg_b[j_b] = dg
                dw_hb += dw
            if s < M + D - 2:
                # the backward-direction carry's gradient goes to d+1, the
                # forward-direction one's to d-1
                db, df = ring.hop(nb, nf)
        return None, None, dg_f, dg_b, dw_hf, dw_hb, None, None


def make_sp_bilstm(mesh: Mesh, axis: str | None = None, microbatches: int | None = None):
    """Build ``sp_bilstm(params, x [B, Tc, Din], mask [B, Tc]) → [B, Tc, 2h]``
    on this rank's time chunk ``Tc = T/D`` (``params``: a ``BiLSTMParams``,
    the same on every rank). ``microbatches`` (default: the largest divisor
    of ``B`` up to ``D``) must divide ``B``, this rank's batch rows.

    Parity: the outputs of ``ops.lstm.bilstm_apply`` on the gathered time
    axis (same masked step, ``[fwd; bwd]`` layout); at ``D = 1`` the very
    operations of its plain scan."""
    axis = axis or mesh.axis_names[-1]
    ring = _Ring(mesh, axis)

    def sp_bilstm(params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, Tc, _ = x.shape
        D = ring.D
        if microbatches is None:
            M = min(D, B)
            while B % M:
                M -= 1
        else:
            M = microbatches
            if B % M:
                raise ValueError(
                    f"SP BiLSTM: microbatches {M} must divide the per-shard batch {B} — pass "
                    f"microbatches= a divisor of the batch, or size the batch as a multiple of "
                    f"the {axis!r} axis ({D})")
        Bm = B // M
        dtype = x.dtype
        # input GEMMs for the whole local chunk; the backward direction runs
        # on the locally flipped chunk (local flip + reversed rank order is
        # the global flip)
        g_f = mm(x, params.fwd.w_x) + params.fwd.b
        g_b = (mm(x, params.bwd.w_x) + params.bwd.b).flip(1)
        m_f = mask.to(dtype)
        m_b = m_f.flip(1)

        def split(a):
            return a.reshape(M, Bm, *a.shape[1:])

        args = (split(g_f), split(g_b), params.fwd.w_h, params.bwd.w_h, split(m_f), split(m_b))
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            out_f, out_b = _Wavefront.apply(ring, M, *args)
        else:
            out_f, out_b = _wavefront(ring, M, *args)[:2]
        h_dim = out_f.shape[-1]
        out_f = out_f.reshape(B, Tc, h_dim)
        out_b = out_b.reshape(B, Tc, h_dim).flip(1)  # un-flip local time
        return torch.cat([out_f, out_b], dim=-1)

    return sp_bilstm
