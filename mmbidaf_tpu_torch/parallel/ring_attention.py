"""Ring-scheduled BiDAF attention over a mesh axis — the port of
``mmbidaf_tpu.parallel.ring_attention``.

Both sequence axes are sharded over the axis: each rank keeps its shard of
the context ``c`` and the q shards travel around the ring (to rank d+1,
from rank d−1), with BiDAF's extra wrinkle that the COLUMN softmax's
statistics travel with them:

  pass 1: the payload ``(q, q_mask, col_max, col_denom, qc_unnorm)`` visits
    every rank; each visit folds the local c shard into the flash column
    statistics and the unnormalised ``s_colᵀ·c``. After n hops the payload
    is home and ``qc = qc_unnorm / col_denom`` is exact.
  pass 2: the payload ``(q, q_mask, qc)`` goes round again; each rank
    accumulates the flash row softmax of its c shard and the ``a`` / ``b``
    outputs.

The block update is the JAX module's: the −1e30 multiplicative mask and the
same rescale order, in f32. The dropout variant takes the dropped copies
``cd`` / ``qd`` for the similarity only (``qd`` travels beside ``q``); C2Q
and Q2C use the undropped ``c`` and ``q``.

Training: each hop is a ``torch.autograd.Function`` whose backward sends
the payload's gradient the other way round the ring (to d−1, from d+1);
every rank holds the same chain of hops, so their backwards pair up.
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.ops.common import einsum
from mmbidaf_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, exchange

NEG_INF = -1e30


class _Hop(torch.autograd.Function):
    """Rotate tensors one rank along the ring; the gradient rotates back."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return ring.rotate(xs, +1)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.rotate(grads, -1))


class _RingPeers:
    def __init__(self, mesh: Mesh, axis: str):
        self.n = mesh.shape[axis]
        d = mesh.coords[axis]
        self.group = mesh.group(axis)
        self.next = mesh.peer(axis, (d + 1) % self.n)
        self.prev = mesh.peer(axis, (d - 1) % self.n)

    def rotate(self, xs, direction: int) -> tuple:
        """The tensors ``xs`` of the rank one step behind (``direction``
        +1) or ahead (−1) on the ring, in one batch of sends and receives."""
        to, frm = (self.next, self.prev) if direction > 0 else (self.prev, self.next)
        outs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in xs)
        exchange([(x, to) for x in xs], [(o, frm) for o in outs], self.group)
        return outs

    def hop(self, xs: tuple) -> tuple:
        if self.n == 1:
            return xs
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return _Hop.apply(self, *xs)
        return self.rotate(xs, +1)


def make_ring_bidaf(mesh: Mesh, axis: str | None = None, dropout: bool = False):
    """Build ``ring_fn(params, c, q, c_mask, q_mask) → [B, tc, 4D]`` (f32) on
    this rank's shards ``c [B, tc, D]``, ``q [B, tq, D]`` (use
    ``shard_seq`` to cut and pad the global axes); ``params`` the BiDAF
    block's, the same on every rank. ``dropout=True`` returns
    ``ring_fn(params, c, q, cd, qd, c_mask, q_mask)`` whose similarity reads
    the dropped copies. Operands are cast to f32, as the JAX module does.
    Each rank holds its own batch rows (its data shard, or the whole batch)."""
    axis = axis or mesh.axis_names[-1]
    ring = _RingPeers(mesh, axis)
    n = ring.n
    f32 = torch.float32

    def body(params, c, q, cd, qd, cm, qm):
        B, tq = qm.shape
        D = c.shape[-1]
        w_c, w_q, w_cq, bias = (params.w_c.to(f32), params.w_q.to(f32), params.w_cq.to(f32),
                                params.bias.to(f32))
        cd = c if cd is None else cd
        lean = qd is None

        def sim(qd_cur):
            s0 = (cd * w_c).sum(-1)[:, :, None]
            s1 = (qd_cur * w_q).sum(-1)[:, None, :]
            s2 = einsum("btd,bsd->bts", cd * w_cq, qd_cur)
            return s0 + s1 + s2 + bias                       # [B, tc, tq]

        def split(payload):
            if lean:
                q_cur, qm_cur, *rest = payload
                return q_cur, q_cur, qm_cur, rest
            q_cur, qd_cur, qm_cur, *rest = payload
            return q_cur, qd_cur, qm_cur, rest

        def join(q_cur, qd_cur, qm_cur, rest):
            head = (q_cur, qm_cur) if lean else (q_cur, qd_cur, qm_cur)
            return (*head, *rest)

        # ---- pass 1: the column-softmax statistics ride with each q shard ----
        state = join(q, qd, qm, (torch.full((B, tq), NEG_INF, dtype=f32, device=c.device),
                                 torch.zeros((B, tq), dtype=f32, device=c.device),
                                 torch.zeros((B, tq, D), dtype=f32, device=c.device)))
        cmask = cm[:, :, None]
        for _ in range(n):
            q_cur, qd_cur, qm_cur, (cmax, cden, qc) = split(state)
            Sc = cmask * sim(qd_cur) + (1.0 - cmask) * NEG_INF
            new_max = torch.maximum(cmax, Sc.amax(dim=1))
            scale = torch.exp(cmax - new_max)
            p = torch.exp(Sc - new_max[:, None, :])
            cden = cden * scale + p.sum(dim=1)
            qc = qc * scale[..., None] + einsum("bts,btd->bsd", p, c)
            state = ring.hop(join(q_cur, qd_cur, qm_cur, (new_max, cden, qc)))
        q_home, qd_home, qm_home, (_, cden, qc) = split(state)
        qcn = qc / torch.clamp_min(cden, 1e-30)[..., None]

        # ---- pass 2: the flash row softmax over the travelling q shards ----
        tc = c.shape[1]
        rmax = torch.full((B, tc), NEG_INF, dtype=f32, device=c.device)
        rden = torch.zeros((B, tc), dtype=f32, device=c.device)
        a_acc = torch.zeros((B, tc, D), dtype=f32, device=c.device)
        b_acc = torch.zeros((B, tc, D), dtype=f32, device=c.device)
        state = join(q_home, qd_home, qm_home, (qcn,))
        for k in range(n):
            q_cur, qd_cur, qm_cur, (qc_cur,) = split(state)
            qmask = qm_cur[:, None, :]
            Sr = qmask * sim(qd_cur) + (1.0 - qmask) * NEG_INF
            new_max = torch.maximum(rmax, Sr.amax(dim=2))
            scale = torch.exp(rmax - new_max)
            p = torch.exp(Sr - new_max[:, :, None])
            rden = rden * scale + p.sum(dim=2)
            a_acc = a_acc * scale[..., None] + einsum("bts,bsd->btd", p, q_cur)
            b_acc = b_acc * scale[..., None] + einsum("bts,bsd->btd", p, qc_cur)
            rmax = new_max
            if k + 1 < n:  # the last shard's visit needs no hop after it
                state = ring.hop(state)
        inv = (1.0 / torch.clamp_min(rden, 1e-30))[..., None]
        a = a_acc * inv
        b = b_acc * inv
        return torch.cat([c, a, c * a, c * b], dim=-1)

    def ring_fn(params, c, q, c_mask, q_mask):
        return body(params, c.to(f32), q.to(f32), None, None, c_mask.to(f32), q_mask.to(f32))

    def ring_fn_dropout(params, c, q, cd, qd, c_mask, q_mask):
        return body(params, c.to(f32), q.to(f32), cd.to(f32), qd.to(f32), c_mask.to(f32),
                    q_mask.to(f32))

    return ring_fn_dropout if dropout else ring_fn


def shard_seq(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous shard of ``x`` along ``dim``, the axis padded
    with zeros to a multiple of the mesh axis first (as the JAX ring pads)."""
    n, d = mesh.shape[axis], mesh.coords[axis]
    pad = -x.shape[dim] % n
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    per = x.shape[dim] // n
    return x.narrow(dim, d * per, per)


class _GatherSeq(torch.autograd.Function):
    """All-gather along a dim over the ``seq`` group. What follows the
    gather runs alike on every rank of the group, each on ``1/n`` of the
    loss (the train step's scaling), so the backward sums the gradient
    over the group and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim, ctx.index, ctx.size = group, dim, index, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous(), ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def gather_seq(x: torch.Tensor, mesh: Mesh, axis: str, length: int, dim: int = 1) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` gathered in rank order and cut to
    ``length`` (the inverse of ``shard_seq``)."""
    group = mesh.group(axis)
    if group is None:
        return x.narrow(dim, 0, length)
    if torch.is_grad_enabled() and x.requires_grad:
        out = _GatherSeq.apply(x, group, dim, mesh.coords[axis])
    else:
        out = all_gather(x, group, dim)
    return out.narrow(dim, 0, length)
