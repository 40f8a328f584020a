"""K2, K7 and K8's split of an example over T_q across a thread-block
cluster, and K9's walk over q tiles on one, on the CPU.

The plan (``ops/cuda/bidaf_kernel.py::drop_plan``, the mirror of
``csrc/bidaf_cluster.cuh::plan``) is a pure function of (T_c, T_q, D): the
tiles cover T_q once, none is empty, the cluster has at most 16 blocks and
K8's block fits Hopper's 227 KB. K2's plan (``fused_plan``) is the same
split judged on the forward section of the layout alone: it holds to T_q =
2048 at T_c=32, D=256, and past it ``bidaf_route`` hands the shape to K9;
every shape K2's first body took (one block an example, S resident) still
has a route. The card tests ``test_bidaf_drop_plan_matches_the_card`` and
``test_bidaf_fused_plan_matches_the_card`` hold both against the C plan.

The algebra of the split is held here before the card sees it: a blockwise
emulation in this file (per-tile row statistics, K9's combine in rank
order, the column softmax exact in each tile, rs as the tiles' row sums of
``d_s_row∘s_row`` checked against the identity ``d_a·a + rowsum(E∘P)``, and
the two exchanges) against JAX's ``bidaf_attention_fused_dropout`` and its
VJP, the Pallas kernels run in interpret mode on the CPU, and the same
emulation with ``cd = c, qd = q`` (K2's ``kDrop = false`` body) at C in
{1, 2, 3, 16} against JAX's ``bidaf_attention_fused``. Bounds: the kernels'
own, ``TOLERANCE`` on the output and ``BACKWARD_TOLERANCE`` normwise on
each gradient.

K9's plan (``tiled_plan``, the mirror of ``csrc/bidaf_tiled.cu::walk_plan``)
is held to its invariants (spans and walk tiles cover T_q once in rank
order, none empty, at most 6 ranks, a block that fits) and its walk (per
tile the exact column softmax, a running row maximum with a_acc and P_acc
rescaled, then the rank-order combine) is emulated at C in {1, 2, 3} x
tiles a rank in {1, 3} against JAX's Pallas ``bidaf_attention_tiled`` in
interpret mode, within ``TOLERANCE``.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused as j_bidaf_fused
from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused_dropout as j_bidaf_drop
from mmbidaf_tpu.ops.pallas.bidaf_tiled_kernel import bidaf_attention_tiled as j_bidaf_tiled
from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.masked import NEG_INF
from mmbidaf_tpu_torch.tools import bidaf_variants

SMEM_LIMIT = 232_448


@pytest.mark.parametrize("T_c,T_q,D", [
    (32, 16, 256), (32, 512, 256),  # the bench_train image and audio blocks
    (33, 100, 320), (5, 33, 40),    # the card tests' shapes
    (7, 45, 20),                    # the smoke script's small ragged shape
    (32, 1, 256), (1, 1, 1),        # one q column
    (32, 1024, 256),                # long audio: 16 tiles of 64 columns
])
def test_drop_plan_tiles_cover_q_once(T_c, T_q, D):
    plan = bk.drop_plan(T_c, T_q, D)
    assert 1 <= plan.C <= 16 and len(plan.tiles) == plan.C
    assert [j for begin, end in plan.tiles for j in range(begin, end)] == list(range(T_q))
    assert all(end > begin for begin, end in plan.tiles)
    assert max(end - begin for begin, end in plan.tiles) == plan.tq
    assert plan.smem_fwd < plan.smem_bwd <= SMEM_LIMIT


def test_drop_plan_of_the_training_blocks():
    """The bench_train audio block (T_q=512): 16 tiles of 32 columns; the
    image block (T_q=16): one block an example; T_q=1024 is accepted."""
    assert bk.drop_plan(32, 512, 256)[:2] == (16, 32)
    assert bk.drop_plan(32, 16, 256)[:2] == (1, 16)
    assert bk.drop_plan(7, 45, 20)[:2] == (2, 23)
    assert bk.drop_plan(32, 1024, 256)[:2] == (16, 64)
    assert largest_accepted_t_q(32, 256) >= 1024


def largest_accepted_t_q(T_c: int, D: int, plan=bk.drop_plan) -> int:
    """The largest T_q ``plan`` accepts at (T_c, D) (the plan's shared
    memory grows with T_q)."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            plan(T_c, mid, D)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("T_c,T_q,D,route", [
    (32, 4096, 256, "tiled"),  # 16 tiles of 256 columns: K7/K8 take the tiled route
    (128, 512, 256, "tiled"),  # the [T_c, D] operands alone pass a block's shared memory
    (0, 16, 8, None), (4, 0, 8, None), (4, 16, 0, None),  # empty shapes: no route at all
])
def test_drop_plan_refuses_what_no_block_holds(T_c, T_q, D, route):
    with pytest.raises(ValueError, match="no BiDAF cluster plan"):
        bk.drop_plan(T_c, T_q, D)
    if route is None:
        with pytest.raises(ValueError, match="no K7/K8 route"):
            bk.drop_route(T_c, T_q, D)
    else:
        assert bk.drop_route(T_c, T_q, D) == route


def test_largest_accepted_t_q_is_refused_one_past():
    t_q = largest_accepted_t_q(32, 256)
    assert bk.drop_plan(32, t_q, 256).smem_bwd <= SMEM_LIMIT
    with pytest.raises(ValueError, match="no BiDAF cluster plan"):
        bk.drop_plan(32, t_q + 1, 256)


@pytest.mark.parametrize("T_c,T_q,D", [
    (32, 16, 256), (32, 512, 256),  # the serving image and audio blocks
    (32, 2048, 256),                # the plan's edge at the model's widths
    (32, 1, 256), (1, 1, 1),        # one q column
    (5, 33, 40), (7, 45, 20),       # the card tests' and the smoke script's small shapes
])
def test_fused_plan_tiles_cover_q_once(T_c, T_q, D):
    plan = bk.fused_plan(T_c, T_q, D)
    assert 1 <= plan.C <= 16 and len(plan.tiles) == plan.C
    assert [j for begin, end in plan.tiles for j in range(begin, end)] == list(range(T_q))
    assert all(end > begin for begin, end in plan.tiles)
    assert max(end - begin for begin, end in plan.tiles) == plan.tq
    assert plan.smem_fwd <= SMEM_LIMIT
    assert bk.bidaf_route(T_c, T_q, D) == "cluster"


def test_fused_plan_of_the_serving_blocks():
    """The serving audio block (T_q=512): 16 tiles of 32 columns, 95,872
    bytes a block; the image block (T_q=16): one block an example."""
    assert bk.fused_plan(32, 512, 256)[:2] == (16, 32)
    assert bk.fused_plan(32, 512, 256).smem_fwd == 95_872
    assert bk.fused_plan(32, 16, 256)[:2] == (1, 16)


def test_fused_plan_hands_over_to_k9_past_its_edge():
    """K2's plan holds to T_q = 2048 at T_c=32, D=256 (16 tiles of 128
    columns), past K7/K8's 1088; one past, the route is K9, whose blocks
    fit."""
    edge = largest_accepted_t_q(32, 256, bk.fused_plan)
    assert edge == 2048 and bk.fused_plan(32, edge, 256)[:2] == (16, 128)
    assert edge > largest_accepted_t_q(32, 256)
    with pytest.raises(ValueError, match="no BiDAF cluster plan"):
        bk.fused_plan(32, edge + 1, 256)
    assert bk.bidaf_route(32, edge + 1, 256) == "K9"
    plan = bk.tiled_plan(32, edge + 1, 256)
    assert plan.resident and plan.C == 6 and plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("T_c,D", [(32, 256), (5, 40), (64, 384), (128, 64)])
def test_fused_plan_is_the_drop_plan_where_both_hold(T_c, D):
    """Where K7/K8's plan is the first split (no cluster raised to fit K8's
    block), K2's is the same plan; K2 never raises the cluster."""
    for T_q in (1, 7, 16, 32, 33, 100, 512, 1000):
        try:
            drop = bk.drop_plan(T_c, T_q, D)
        except ValueError:
            continue
        if drop != bk._split(T_c, T_q, D):
            continue  # K8's block needed the raise
        assert bk.fused_plan(T_c, T_q, D) == drop


def _first_k2_smem_bytes(T_c: int, T_q: int, D: int) -> int:
    """The shared memory of K2's first body (one block an example: c, a
    streamed q tile of 32 rows, S and s_col, P and three vectors), which
    decided what its wrapper took."""
    return 4 * (T_c * D + 32 * (D + 1) + 2 * T_c * (T_q + 1) + T_c * T_c + T_c + 32 + D)


def test_no_shape_the_first_k2_body_took_is_refused():
    """Over a grid of shapes, every one the first body took has a route now:
    K2's cluster plan, or K9's walk."""
    took = 0
    for T_c in (1, 5, 32, 33, 64, 100, 128, 160):
        for T_q in (1, 16, 33, 100, 512, 1024, 1500):
            for D in (8, 40, 256, 384, 512, 1024, 1500):
                if _first_k2_smem_bytes(T_c, T_q, D) > SMEM_LIMIT:
                    continue
                took += 1
                if bk.bidaf_route(T_c, T_q, D) == "K9":
                    bk.tiled_plan(T_c, T_q, D)  # raises if no K9 block fits
    assert took > 100


@pytest.mark.parametrize("T_c,T_q,D,resident,spill", [
    (32, 4096, 256, True, False),        # the long-audio attention: 6 ranks of 11 tiles of 63
    (32, 2049, 256, True, False),        # one past K2's plan: 6 ranks of 342 columns
    (32, 1, 256, True, False), (1, 1, 1, True, False),  # one q column
    (40, 300, 256, True, False), (7, 45, 20, True, False),  # card tests' and smoke's small shapes
    (2, 1000, 40, True, False), (33, 130, 12, True, False),  # several tiles a rank, ragged last
    (64, 4096, 384, False, False),       # c∘w_cq no longer fits beside the accumulators
    (114, 4096, 256, False, False),      # the last context whose accumulators fit a block
    (115, 4096, 256, True, True),        # the first that spills them to device memory
    (600, 4096, 256, False, True),       # a long context, spilled, c∘w_cq from device memory
    (130, 301, 256, True, True),         # spilled, 5 ranks, the last of 57 columns
    (200, 16, 256, True, True),          # spilled, a cluster of one
])
def test_tiled_plan_walks_q_once(T_c, T_q, D, resident, spill):
    """K9's walk: the ranks' spans and their tiles cover T_q once in rank
    order, none is empty, every tile lies in its rank's span and is at most
    ``tq`` wide, the cluster has at most 6 blocks, and a block fits; where
    the accumulators spill, a block's device memory holds a_acc and P_acc
    (rows of 16-byte multiples, so the next block's a_acc stays aligned)."""
    plan = bk.tiled_plan(T_c, T_q, D)
    assert 1 <= plan.C <= 6 and len(plan.spans) == plan.C
    assert [j for begin, end in plan.spans for j in range(begin, end)] == list(range(T_q))
    assert [j for begin, end in plan.tiles for j in range(begin, end)] == list(range(T_q))
    assert all(0 < end - begin <= plan.span for begin, end in plan.spans)
    assert all(0 < end - begin <= plan.tq for begin, end in plan.tiles)
    assert all(any(b0 <= begin and end <= b1 for b0, b1 in plan.spans) for begin, end in plan.tiles)
    assert plan.smem <= SMEM_LIMIT and plan.resident == resident
    assert (plan.work > 0) == spill and plan.work % 4 == 0
    if spill:
        assert plan.work >= T_c * (D + T_c)


def test_tiled_plan_of_the_long_audio_block():
    """B=16 long-audio examples run as one wave: 6 ranks a cluster (96
    blocks), each walking 683 columns (the last 681) in 11 tiles of 63,
    c∘w_cq resident; ``tq_blk`` caps the tile; a cluster of one where T_q is
    short."""
    plan = bk.tiled_plan(32, 4096, 256)
    assert (plan.C, plan.span, plan.tq, plan.resident) == (6, 683, 63, True)
    assert len(plan.tiles) == 66 and 16 * plan.C <= 132
    assert bk.tiled_plan(32, 4096, 256, tq_blk=32).tq == 32
    assert bk.tiled_plan(7, 45, 20, tq_blk=16)[:3] == (1, 45, 15)


@pytest.mark.parametrize("T_c,T_q,D", [(5000, 64, 256), (4289, 4096, 256), (0, 16, 8), (4, 0, 8),
                                       (4, 16, 0)])
def test_tiled_plan_refuses_what_no_block_holds(T_c, T_q, D):
    with pytest.raises(ValueError, match="no K9 plan"):
        bk.tiled_plan(T_c, T_q, D)


def _first_k9_smem_bytes(T_c: int, T_q: int, D: int) -> int:
    """The shared memory of K9's first port (a c tile of min(128, T_c)
    rows, a streamed q tile of 32 rows, S and s_col over a q block of 8
    columns, the narrowest it would halve to), which decided what its
    wrapper took."""
    tc, tq = min(128, T_c), min(8, T_q)
    return 4 * (tc * D + 32 * (D + 1) + 2 * T_c * (tq + 1) + T_c + tq + D)


def test_no_shape_the_first_k9_took_is_refused():
    """Over a grid of shapes, every one K9's first port took (T_c to 887 at
    D=256, to 1971 at D=128) has a walk plan now, and every plan fits a
    block; past T_c=114 at D=256 the accumulators spill."""
    took = 0
    for T_c in (1, 33, 114, 115, 300, 600, 887, 1971):
        for T_q in (1, 16, 512, 4096):
            for D in (8, 128, 256, 512):
                if _first_k9_smem_bytes(T_c, T_q, D) > SMEM_LIMIT:
                    continue
                took += 1
                plan = bk.tiled_plan(T_c, T_q, D)
                assert plan.smem <= SMEM_LIMIT
                assert plan.work > 0 or _walk_fits_shared(T_c, D)
    assert took > 80
    assert bk.tiled_plan(114, 4096, 256).work == 0 and bk.tiled_plan(115, 4096, 256).work > 0


def _walk_fits_shared(T_c: int, D: int) -> bool:
    """Whether a_acc [T_c, D] and P_acc [T_c, T_c] alone fit a block."""
    return 4 * T_c * (D + T_c) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# A blockwise emulation of the kernels' split (test-only).
# ---------------------------------------------------------------------------


def _tiles(T_q: int, C: int):
    tq = -(-T_q // C)
    tiles = [(r * tq, min((r + 1) * tq, T_q)) for r in range(C)]
    assert all(end > begin for begin, end in tiles), "an empty tile"
    return tiles


def _tile_stats(cd, qd, cm, qm, w_c, w_q, w_cq, bias, j0, j1):
    """One tile: S_J, the exact column softmax, the row maxima m, p = exp(v −
    m) and l = Σp over the tile's columns."""
    S = ((cd @ w_c)[:, :, None] + (qd[:, j0:j1] @ w_q)[:, None, :]
         + (cd * w_cq) @ qd[:, j0:j1].transpose(1, 2) + bias)
    cmm, qmm = cm[:, :, None], qm[:, None, j0:j1]
    s_col = torch.softmax(cmm * S + (1.0 - cmm) * NEG_INF, dim=1)
    v = qmm * S + (1.0 - qmm) * NEG_INF
    m = v.max(dim=2).values
    p = torch.exp(v - m[:, :, None])
    return s_col, p, m, p.sum(dim=2)


def _exchange_1(c, q, cd, qd, cm, qm, w_c, w_q, w_cq, bias, C):
    """Every tile's stats and partials a_J = p·q_J, P_J = p·s_colᵀ, then
    K9's weights and the combined a and P, summed in rank order."""
    tiles = _tiles(q.shape[1], C)
    st = [_tile_stats(cd, qd, cm, qm, w_c, w_q, w_cq, bias, j0, j1) for j0, j1 in tiles]
    a_parts = [p @ q[:, j0:j1] for (_, p, _, _), (j0, j1) in zip(st, tiles)]
    p_parts = [p @ s_col.transpose(1, 2) for s_col, p, _, _ in st]
    M = torch.stack([m for _, _, m, _ in st]).max(dim=0).values
    scale = [torch.exp(m - M) for _, _, m, _ in st]
    L = sum(s * l for s, (_, _, _, l) in zip(scale, st))
    w = [s / L for s in scale]
    a = sum(wj[:, :, None] * aj for wj, aj in zip(w, a_parts))
    P = sum(wj[:, :, None] * pj for wj, pj in zip(w, p_parts))
    return tiles, st, w, a, P


def split_forward(c, q, cd, qd, cm, qm, w_c, w_q, w_cq, bias, C):
    _, _, _, a, P = _exchange_1(c, q, cd, qd, cm, qm, w_c, w_q, w_cq, bias, C)
    return torch.cat([c, a, c * a, c * (P @ c)], dim=-1)


def split_backward(c, q, cd, qd, cm, qm, w_c, w_q, w_cq, bias, g, C):
    B, T_c, D = c.shape
    T = lambda x: x.transpose(1, 2)  # noqa: E731
    tiles, st, w, a, P = _exchange_1(c, q, cd, qd, cm, qm, w_c, w_q, w_cq, bias, C)
    g0, g1, g2, g3 = (g[..., k * D:(k + 1) * D] for k in range(4))
    d_a, d_b = g1 + g2 * c, g3 * c
    E = d_b @ T(c)
    d_c = g0 + g2 * a + g3 * (P @ c) + T(P) @ d_b
    s_rows = [p * wj[:, :, None] for (_, p, _, _), wj in zip(st, w)]
    d_s_rows = [E @ s_col + d_a @ T(q[:, j0:j1]) for (s_col, _, _, _), (j0, j1) in zip(st, tiles)]
    # rs = rowsum(d_s_row∘s_row): the tiles' row sums in rank order (the
    # kernel's), which is d_a·a + rowsum(E∘P), a over the ranks' D columns
    rs = sum((dsr * sr).sum(dim=2) for dsr, sr in zip(d_s_rows, s_rows))
    slices = [(r * D // C, (r + 1) * D // C) for r in range(C)]
    rs_identity = sum((d_a[..., d0:d1] * a[..., d0:d1]).sum(dim=-1) for d0, d1 in slices)
    torch.testing.assert_close(rs_identity + (E * P).sum(dim=-1), rs, atol=1e-4, rtol=1e-5)
    cw = cd * w_cq
    d_q, d_qd = torch.empty_like(q), torch.empty_like(q)
    ds0_parts, dsq_parts, wq_parts = [], [], []
    for (s_col, _, _, _), s_row, d_s_row, (j0, j1) in zip(st, s_rows, d_s_rows, tiles):
        qm_j = qm[:, None, j0:j1]
        d_s_col = T(E) @ s_row
        cs = (d_s_col * s_col).sum(dim=1, keepdim=True)
        dS = qm_j * (s_row * (d_s_row - rs[:, :, None])) + cm[:, :, None] * (s_col * (d_s_col - cs))
        ds1 = dS.sum(dim=1)
        d_q[:, j0:j1] = T(s_row) @ d_a
        d_qd[:, j0:j1] = ds1[:, :, None] * w_q + T(dS) @ cw
        ds0_parts.append(dS.sum(dim=2))
        dsq_parts.append(dS @ qd[:, j0:j1])
        wq_parts.append((qd[:, j0:j1] * ds1[:, :, None]).sum(dim=1))
    ds0, dSq, wq = sum(ds0_parts), sum(dsq_parts), sum(wq_parts)
    d_cd = ds0[:, :, None] * w_c + dSq * w_cq
    return (d_c, d_q, d_cd, d_qd, (cd * ds0[:, :, None]).sum(dim=(0, 1)), wq.sum(dim=0),
            (dSq * cd).sum(dim=(0, 1)), ds0.sum())


@pytest.mark.parametrize("C", [1, 2, 3])
def test_split_matches_pallas_and_its_vjp(C):
    """T_q=11 over C tiles (3: 4 + 4 + 3 columns, a partial last tile), with
    a fully masked q row (example 1), a fully masked c column (example 2),
    and in example 0 a q mask that leaves the last tile fully masked."""
    rng = np.random.default_rng(40 + C)
    B, T_c, T_q, D = 3, 6, 11, 12
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c, q, g = f32(B, T_c, D), f32(B, T_q, D), f32(B, T_c, 4 * D)
    keep = lambda shape: (rng.random(shape) < 0.8).astype(np.float32) / 0.8  # noqa: E731
    cd, qd = c * keep(c.shape), q * keep(q.shape)
    c_mask = (np.arange(T_c)[None] < np.array([6, 4, 0])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([7, 0, 11])[:, None]).astype(np.float32)
    w_c, w_q, w_cq = f32(D) * 0.3, f32(D) * 0.3, f32(D) * 0.3
    bias = np.float32(-0.2)

    jp = {"w_c": jnp.asarray(w_c), "w_q": jnp.asarray(w_q), "w_cq": jnp.asarray(w_cq),
          "bias": jnp.float32(bias)}
    j_args = [jnp.asarray(v) for v in (c, q, cd, qd, c_mask, q_mask)]
    j_out, vjp = jax.vjp(lambda p, *xs: j_bidaf_drop(p, *xs, j_args[4], j_args[5]),
                         jp, *j_args[:4])
    j_dp, *j_dx = vjp(jnp.asarray(g))

    t = [torch.from_numpy(v) for v in (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq)]
    ops = (*t, torch.tensor(bias))
    out = split_forward(*ops, C=C)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **bk.TOLERANCE)
    got = split_backward(*ops, torch.from_numpy(g), C=C)
    ref = [*j_dx, j_dp["w_c"], j_dp["w_q"], j_dp["w_cq"], j_dp["bias"]]
    tol = bk.BACKWARD_TOLERANCE
    for name, o, r in zip(("d_c", "d_q", "d_cd", "d_qd", "dw_c", "dw_q", "dw_cq", "dbias"), got, ref):
        r = np.asarray(r)
        err = np.abs(o.numpy() - r).max()
        assert err <= tol["atol"] + tol["rtol"] * np.abs(r).max(), (name, err)
    # and the plain version, which the wrapper runs on CPU tensors, agrees with the split
    plain = bk.bidaf_dropout_backward(*ops, torch.from_numpy(g))
    for o, r in zip(got, plain):
        torch.testing.assert_close(o, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(bidaf_variants.VARIANTS))
def test_bidaf_variants_edit_the_sources_once(variant):
    """Each variant of ``tools/bidaf_variants.py`` finds every text it
    replaces exactly once in the checkout's sources."""
    for fname, edits in bidaf_variants.VARIANTS[variant].items():
        text = (build.CSRC / fname).read_text()
        assert [text.count(old) for old, _ in edits] == [1] * len(edits), fname


def test_bidaf_variants_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert bidaf_variants.main([]) == 1


@pytest.mark.parametrize("C", [1, 2, 3, 16])
def test_k2_split_matches_pallas(C):
    """K2's body (``kDrop = false``: S from c and q) split over C tiles of
    T_q=46 (16: fifteen tiles of 3 columns and one of 1), with a fully
    masked q row (example 1), a fully masked c column (example 2), and in
    example 0 a q mask that leaves the last tiles fully masked."""
    rng = np.random.default_rng(60 + C)
    B, T_c, T_q, D = 3, 6, 46, 12
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c, q = f32(B, T_c, D), f32(B, T_q, D)
    c_mask = (np.arange(T_c)[None] < np.array([6, 4, 0])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([40, 0, 46])[:, None]).astype(np.float32)
    w_c, w_q, w_cq = f32(D) * 0.3, f32(D) * 0.3, f32(D) * 0.3
    bias = np.float32(-0.2)
    jp = {"w_c": jnp.asarray(w_c), "w_q": jnp.asarray(w_q), "w_cq": jnp.asarray(w_cq),
          "bias": jnp.float32(bias)}
    ref = j_bidaf_fused(jp, *(jnp.asarray(v) for v in (c, q, c_mask, q_mask)), interpret=True)
    tc, tq = torch.from_numpy(c), torch.from_numpy(q)
    out = split_forward(tc, tq, tc, tq, *(torch.from_numpy(v) for v in (c_mask, q_mask, w_c, w_q,
                                                                          w_cq)),
                        torch.tensor(bias), C=C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **bk.TOLERANCE)


# ---------------------------------------------------------------------------
# K9's walk, emulated (test-only).
# ---------------------------------------------------------------------------


def walk_forward(c, q, cm, qm, w_c, w_q, w_cq, bias, spans, spill=False, cd=None, qd=None,
                 stats=False):
    """K9's arithmetic: each rank walks its tiles (``spans[r]``, a list of
    ``(j0, j1)``) keeping a running row maximum m, the row sum l and the
    accumulators a_acc = Σ p·q_t and P_acc = Σ p·s_colᵀ, rescaled by
    exp(m − m_new) at each tile (the column softmax exact inside the tile);
    then the ranks are combined in rank order with K2's weights (with
    ``spill``, as the kernel does where a_acc and P_acc are in device
    memory: each rank combines its own rows). K7's tiled route (``kDrop``)
    forms S from ``cd``/``qd`` and, with ``stats``, also returns each row's
    combined maximum M and sum L as ``[B, 2, T_c]``."""
    B, T_c, D = c.shape
    cd = c if cd is None else cd
    qd = q if qd is None else qd
    cw, s0 = cd * w_cq, cd @ w_c
    ranks = []
    for tiles in spans:
        m = torch.full((B, T_c), float("-inf"))
        l = torch.zeros(B, T_c)
        a_acc, p_acc = torch.zeros(B, T_c, D), torch.zeros(B, T_c, T_c)
        for j0, j1 in tiles:
            qt, qdt = q[:, j0:j1], qd[:, j0:j1]
            S = s0[:, :, None] + (qdt @ w_q)[:, None, :] + cw @ qdt.transpose(1, 2) + bias
            cmm, qmm = cm[:, :, None], qm[:, None, j0:j1]
            s_col = torch.softmax(cmm * S + (1.0 - cmm) * NEG_INF, dim=1)
            v = qmm * S + (1.0 - qmm) * NEG_INF
            m_new = torch.maximum(m, v.max(dim=2).values)
            scale = torch.exp(m - m_new)
            p = torch.exp(v - m_new[:, :, None])
            l = l * scale + p.sum(dim=2)
            a_acc = a_acc * scale[:, :, None] + p @ qt
            p_acc = p_acc * scale[:, :, None] + p @ s_col.transpose(1, 2)
            m = m_new
        ranks.append((m, l, a_acc, p_acc))
    M = torch.stack([m for m, _, _, _ in ranks]).max(dim=0).values
    e = [torch.exp(m - M) for m, _, _, _ in ranks]
    L = sum(ej * l for ej, (_, l, _, _) in zip(e, ranks))
    if spill:
        out = _combine_by_rows(c, ranks)
    else:
        a = sum((ej / L)[:, :, None] * aj for ej, (_, _, aj, _) in zip(e, ranks))
        P = sum((ej / L)[:, :, None] * pj for ej, (_, _, _, pj) in zip(e, ranks))
        out = torch.cat([c, a, c * a, c * (P @ c)], dim=-1)
    return (out, torch.stack([M, L], dim=1)) if stats else out


def _combine_by_rows(c, ranks):
    """The spilled combine: rank r owns the rows [r·NR, r·NR + NR) (NR =
    ceil(T_c / C); the last ranks may own fewer or none), forms their
    weights from every rank's m and l, their rows of P and of a, and b = P·c
    over all of c."""
    B, T_c, D = c.shape
    C = len(ranks)
    NR = -(-T_c // C)
    out = torch.full((B, T_c, 4 * D), float("nan"))
    for r in range(C):
        rows = slice(min(r * NR, T_c), min((r + 1) * NR, T_c))
        M = torch.stack([m[:, rows] for m, _, _, _ in ranks]).max(dim=0).values
        e = [torch.exp(m[:, rows] - M) for m, _, _, _ in ranks]
        L = sum(ej * l[:, rows] for ej, (_, l, _, _) in zip(e, ranks))
        a = sum((ej / L)[:, :, None] * aj[:, rows] for ej, (_, _, aj, _) in zip(e, ranks))
        P = sum((ej / L)[:, :, None] * pj[:, rows] for ej, (_, _, _, pj) in zip(e, ranks))
        cr = c[:, rows]
        out[:, rows] = torch.cat([cr, a, cr * a, cr * (P @ c)], dim=-1)
    return out


def _walk(T_q: int, C: int, n: int):
    """C ranks of ``ceil(T_q / C)`` columns, each walked in n tiles (the last
    rank's, and each span's last tile, may be shorter)."""
    span = -(-T_q // C)
    tq = -(-span // n)
    spans = [[(j, min(j + tq, end)) for j in range(begin, end, tq)]
             for begin, end in ((r * span, min((r + 1) * span, T_q)) for r in range(C))]
    assert all(len(t) >= 1 for t in spans) and max(len(t) for t in spans) == n
    return spans


_WALK_B, _WALK_TC, _WALK_TQ, _WALK_D = 3, 16, 40, 12


@pytest.fixture(scope="module")
def walk_case():
    """Inputs at 8x8 block multiples (T_c=16, T_q=40): ragged masks, a fully
    masked q row (example 1) and a fully masked c column (example 2), and in
    example 0 a q mask that leaves the last tiles fully masked; the JAX
    Pallas kernel (8x8 blocks, interpret mode) on them, once."""
    rng = np.random.default_rng(77)
    B, T_c, T_q, D = _WALK_B, _WALK_TC, _WALK_TQ, _WALK_D
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c, q = f32(B, T_c, D), f32(B, T_q, D)
    c_mask = (np.arange(T_c)[None] < np.array([13, 9, 0])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([22, 0, 37])[:, None]).astype(np.float32)
    w_c, w_q, w_cq = f32(D) * 0.3, f32(D) * 0.3, f32(D) * 0.3
    bias = np.float32(0.25)
    jp = {"w_c": jnp.asarray(w_c), "w_q": jnp.asarray(w_q), "w_cq": jnp.asarray(w_cq),
          "bias": jnp.float32(bias)}
    ref = j_bidaf_tiled(jp, *(jnp.asarray(v) for v in (c, q, c_mask, q_mask)), tc_blk=8, tq_blk=8,
                        interpret=True)
    ops = [torch.from_numpy(v) for v in (c, q, c_mask, q_mask, w_c, w_q, w_cq)]
    return ops + [torch.tensor(bias)], np.asarray(ref)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("C,spill", [(1, False), (2, False), (3, False), (1, True), (3, True),
                                     (6, True)])
def test_walk_matches_pallas(walk_case, C, n, spill):
    """K9's walk over C ranks of n tiles each (C=3, n=3: spans of 14, 14 and
    12 columns in tiles of 5, the last ones of 4 and 2), combined as the
    shared-memory kernel does or, with ``spill``, each rank its own rows
    (C=3: 6, 6 and 4 of T_c=16; C=6: five ranks of 3 and one of 1), against
    JAX's blockwise Pallas kernel and against the plain version, within
    ``TOLERANCE``; every row is written once."""
    (c, q, cm, qm, w_c, w_q, w_cq, bias), ref = walk_case
    out = walk_forward(c, q, cm, qm, w_c, w_q, w_cq, bias, _walk(_WALK_TQ, C, n), spill=spill)
    assert not out.isnan().any()
    np.testing.assert_allclose(out.numpy(), ref, **bk.TOLERANCE)
    params = types.SimpleNamespace(w_c=w_c, w_q=w_q, w_cq=w_cq, bias=bias)
    torch.testing.assert_close(out, bk.bidaf_reference(params, c, q, cm, qm), **bk.TOLERANCE)
    # example 1's q is fully masked: C2Q is the plain mean of q over T_q
    torch.testing.assert_close(out[1, :, _WALK_D:2 * _WALK_D],
                               q[1].mean(dim=0).expand(_WALK_TC, _WALK_D), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# K7 / K8's routes: the cluster plan raised before it refuses, and the tiled
# route (K7 on K9's walk with S from cd and qd, K8 on
# csrc/bidaf_tiled_bwd.cu) for what no cluster block holds.
# ---------------------------------------------------------------------------

GATE_TC = (1, 8, 32, 33, 40, 48, 64, 65, 128)
GATE_TQ = (1, 16, 32, 64, 512, 1088, 1089, 2048, 4096)


def test_drop_plan_raises_the_cluster_before_it_refuses():
    """At (32, 32, 256) one tile of 32 columns needs 233,600 bytes: two of
    16 fit; T_c = 40 and 48 at short T_q likewise. Shapes whose first split
    fits keep it, and K2 never raises (its wrapper hands over to K9)."""
    assert bk._split(32, 32, 256).smem_bwd == 233_600
    assert bk.drop_plan(32, 32, 256)[:2] == (2, 16)
    assert bk.drop_plan(40, 16, 256)[:2] == (2, 8)
    assert bk.drop_plan(48, 16, 256)[:2] == (4, 4)
    assert bk.drop_plan(32, 16, 256)[:2] == (1, 16)
    assert bk.fused_plan(32, 32, 256)[:2] == (1, 32)
    for T_c, T_q in ((32, 32), (40, 16), (48, 16)):
        assert bk.drop_plan(T_c, T_q, 256).smem_bwd <= SMEM_LIMIT
        assert bk.drop_route(T_c, T_q, 256) == "cluster"


@pytest.mark.parametrize("D", [200, 256, 512, 1024])
@pytest.mark.parametrize("T_c", GATE_TC)
def test_every_gate_shape_has_a_route_that_fits(T_c, D):
    """Every T_q of the gate at this (T_c, D) has a route whose blocks fit
    Hopper's shared memory: the cluster plan (K8's block, C <= 16) or both
    tiled plans (K7's walk with two rings; K8's pass and finish blocks)."""
    for T_q in GATE_TQ:
        route = bk.drop_route(T_c, T_q, D)
        if route == "cluster":
            plan = bk.drop_plan(T_c, T_q, D)
            assert plan.C <= 16 and plan.smem_bwd <= SMEM_LIMIT
            continue
        walk, bwd = bk.tiled_plan(T_c, T_q, D, 128, drop=True), bk.tiled_bwd_plan(T_c, T_q, D)
        assert walk.smem <= SMEM_LIMIT and walk.C <= 6
        assert bwd.smem <= SMEM_LIMIT and bwd.smem_finish <= SMEM_LIMIT and bwd.C <= 8


@pytest.mark.parametrize("D", [512, 1024])
@pytest.mark.parametrize("T_c", GATE_TC)
def test_every_gate_shape_has_a_serving_route_that_fits(T_c, D):
    """K2's wrapper at the widths of a hidden-256 and a hidden-512 model:
    every T_q of the gate on K2's cluster (its forward block fits, C <= 16)
    or handed to K9, whose walk plan fits."""
    for T_q in GATE_TQ:
        if bk.bidaf_route(T_c, T_q, D) == "cluster":
            plan = bk.fused_plan(T_c, T_q, D)
            assert plan.C <= 16 and plan.smem_fwd <= SMEM_LIMIT
        else:
            walk = bk.tiled_plan(T_c, T_q, D)
            assert walk.smem <= SMEM_LIMIT and walk.C <= 6


@pytest.mark.parametrize("T_c,T_q,D", [(5, 33, 40), (7, 45, 20)])
def test_the_small_gate_shapes_stay_on_the_cluster_route(T_c, T_q, D):
    assert bk.drop_route(T_c, T_q, D) == "cluster"
    assert bk.drop_plan(T_c, T_q, D) == bk._split(T_c, T_q, D)


def test_no_shape_the_cluster_route_took_changes_route():
    """Over a grid, every shape whose first split fitted K8's block (all
    the cluster route took before the raise) keeps that plan and route; the
    capability configs' blocks (T_c = 64) and long audio take the tiled
    route."""
    took = 0
    for T_c in (1, 5, 8, 16, 32, 33, 40, 47, 48, 64, 100):
        for T_q in (1, 2, 7, 16, 31, 32, 33, 64, 100, 512, 1000, 1088, 1089, 2048):
            for D in (8, 40, 200, 256, 384):
                first = bk._split(T_c, T_q, D)
                if first.smem_bwd > SMEM_LIMIT:
                    continue
                took += 1
                assert bk.drop_route(T_c, T_q, D) == "cluster"
                assert bk.drop_plan(T_c, T_q, D) == first
    assert took > 300
    for shape in ((64, 64, 256), (64, 512, 256), (32, 4096, 256), (32, 1089, 256)):
        assert bk.drop_route(*shape) == "tiled"


@pytest.mark.parametrize("T_c,T_q,D", [
    (64, 64, 256), (64, 512, 256), (32, 4096, 256), (128, 512, 256),  # the gate's run shapes
    (64, 1, 256), (48, 20, 200), (300, 7, 8), (1, 4096, 1),
])
def test_tiled_bwd_plan_deals_q_once(T_c, T_q, D):
    """K8's tiled plan: the tiles cover T_q once in rank order, each block's
    tiles consecutive and at most ``per``, none idle, at most 8 blocks of
    tiles of at most 32 columns, both blocks fit, and the workspace is
    BwdWork's size."""
    plan = bk.tiled_bwd_plan(T_c, T_q, D)
    assert 1 <= plan.C <= 8 and len(plan.tiles) == plan.C and 1 <= plan.tq <= 32
    assert all(1 <= len(t) <= plan.per for t in plan.tiles)
    assert [j for t in plan.tiles for j0, j1 in t for j in range(j0, j1)] == list(range(T_q))
    assert all(0 < j1 - j0 <= plan.tq for t in plan.tiles for j0, j1 in t)
    assert plan.smem <= SMEM_LIMIT and plan.smem_finish <= SMEM_LIMIT
    assert plan.work == bk._bwd_work(T_c, D, plan.C) >= T_c * D * (2 + 2 * plan.C)


@pytest.mark.parametrize("T_c,T_q,D", [(12000, 4, 8), (0, 4, 4), (4, 0, 4), (4, 4, 0)])
def test_tiled_bwd_plan_refuses_what_no_block_holds(T_c, T_q, D):
    """Past T_c ~ 11,600 not even a pass block of one q column fits (five
    [T_c, 1] sections); empty shapes have no plan. Then there is no route at
    all; K7's walk refuses earlier, past T_c ~ 4,000 at D=256."""
    with pytest.raises(ValueError, match="no K8 tiled plan"):
        bk.tiled_bwd_plan(T_c, T_q, D)
    with pytest.raises(ValueError, match="no K7/K8 route"):
        bk.drop_route(T_c, T_q, D)
    if T_c > 0:
        bk.tiled_bwd_plan(T_c // 4, max(T_q, 1), max(D, 1))
        with pytest.raises(ValueError, match="no K7/K8 route"):
            bk.drop_route(5000, 64, 256)


def tiled_backward(c, q, cd, qd, cm, qm, w_c, w_q, w_cq, bias, g, stats, tiles):
    """K8's tiled route, pass by pass (test-only): ``tiles[r]`` the q tiles
    of block r. Prep: cw, d_a, s0, E. Pass 1 per tile: S, p = exp(v − M)
    (M from K7's stats), s_col, d_s_row; the block's Σ p, Σ p∘d_s_row and
    partials Σ p·q_J, Σ p·s_colᵀ. Pass 2: L and rs from the blocks' sums in
    rank order, then per tile s_row = p / L, d_s_col, dS, d_q, d_qd and the
    partials. Finish: a and P over L, d_c, d_cd and the parameter grads."""
    T = lambda x: x.transpose(1, 2)  # noqa: E731
    B, T_c, D = c.shape
    g0, g1, g2, g3 = (g[..., k * D:(k + 1) * D] for k in range(4))
    cw, da, s0, E = cd * w_cq, g1 + g2 * c, cd @ w_c, (g3 * c) @ T(c)
    M = stats[:, 0]

    def tile(j0, j1):
        qt, qdt = q[:, j0:j1], qd[:, j0:j1]
        S = s0[:, :, None] + (qdt @ w_q)[:, None, :] + cw @ T(qdt) + bias
        qmm, cmm = qm[:, None, j0:j1], cm[:, :, None]
        p = torch.exp(qmm * S + (1.0 - qmm) * NEG_INF - M[:, :, None])
        s_col = torch.softmax(cmm * S + (1.0 - cmm) * NEG_INF, dim=1)
        return qt, qdt, p, s_col, E @ s_col + da @ T(qt)

    l_r, pd_r, a_r, p_r = [], [], [], []
    for blk in tiles:
        acc = [torch.zeros(B, T_c), torch.zeros(B, T_c), torch.zeros(B, T_c, D),
               torch.zeros(B, T_c, T_c)]
        for j0, j1 in blk:
            qt, _, p, s_col, dsr = tile(j0, j1)
            for k, v in enumerate((p.sum(2), (p * dsr).sum(2), p @ qt, p @ T(s_col))):
                acc[k] = acc[k] + v
        for lst, v in zip((l_r, pd_r, a_r, p_r), acc):
            lst.append(v)
    L = sum(l_r)
    rs = sum(pd_r) / L
    d_q, d_qd = torch.empty_like(q), torch.empty_like(q)
    ds0, dsq, wq, bs = 0.0, 0.0, 0.0, 0.0
    for blk in tiles:
        for j0, j1 in blk:
            qt, qdt, p, s_col, dsr = tile(j0, j1)
            s_row = p / L[:, :, None]
            dsc = T(E) @ s_row
            csum = (dsc * s_col).sum(1, keepdim=True)
            dS = (qm[:, None, j0:j1] * (s_row * (dsr - rs[:, :, None]))
                  + cm[:, :, None] * (s_col * (dsc - csum)))
            ds1 = dS.sum(1)
            d_q[:, j0:j1] = T(s_row) @ da
            d_qd[:, j0:j1] = ds1[:, :, None] * w_q + T(dS) @ cw
            ds0, dsq = ds0 + dS.sum(2), dsq + dS @ qdt
            wq, bs = wq + (qdt * ds1[:, :, None]).sum(1), bs + ds1.sum()
    a, P = sum(a_r) / L[:, :, None], sum(p_r) / L[:, :, None]
    d_c = g0 + g2 * a + g3 * (P @ c) + T(P) @ (g3 * c)
    d_cd = ds0[:, :, None] * w_c + dsq * w_cq
    return (d_c, d_q, d_cd, d_qd, (cd * ds0[:, :, None]).sum((0, 1)), wq.sum(0),
            (dsq * cd).sum((0, 1)), bs)


@pytest.mark.parametrize("tq,blocks", [(32, 1), (4, 2), (3, 3), (1, 8)])
@pytest.mark.parametrize("walk_ranks,walk_tiles", [(1, 1), (3, 2)])
def test_tiled_route_matches_pallas_and_its_vjp(tq, blocks, walk_ranks, walk_tiles):
    """K7's tiled route (K9's walk with S from cd, qd, its row statistics
    kept) and K8's tiled route (tiles of ``tq`` dealt to ``blocks`` blocks
    in runs) on T_q=11 with a fully masked q row (example 1), a fully
    masked c column (example 2) and in example 0 a q mask that leaves the
    last tiles fully masked, against JAX's ``bidaf_attention_fused_dropout``
    and its VJP in interpret mode: ``TOLERANCE`` on the output,
    ``BACKWARD_TOLERANCE`` normwise on each gradient."""
    rng = np.random.default_rng(90 + tq)
    B, T_c, T_q, D = 3, 6, 11, 12
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c, q, g = f32(B, T_c, D), f32(B, T_q, D), f32(B, T_c, 4 * D)
    keep = lambda shape: (rng.random(shape) < 0.8).astype(np.float32) / 0.8  # noqa: E731
    cd, qd = c * keep(c.shape), q * keep(q.shape)
    c_mask = (np.arange(T_c)[None] < np.array([6, 4, 0])[:, None]).astype(np.float32)
    q_mask = (np.arange(T_q)[None] < np.array([7, 0, 11])[:, None]).astype(np.float32)
    w_c, w_q, w_cq = f32(D) * 0.3, f32(D) * 0.3, f32(D) * 0.3
    bias = np.float32(-0.2)
    jp = {"w_c": jnp.asarray(w_c), "w_q": jnp.asarray(w_q), "w_cq": jnp.asarray(w_cq),
          "bias": jnp.float32(bias)}
    j_args = [jnp.asarray(v) for v in (c, q, cd, qd, c_mask, q_mask)]
    j_out, vjp = jax.vjp(lambda p, *xs: j_bidaf_drop(p, *xs, j_args[4], j_args[5]),
                         jp, *j_args[:4])
    j_dp, *j_dx = vjp(jnp.asarray(g))

    t = [torch.from_numpy(v) for v in (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq)]
    ops = (*t, torch.tensor(bias))
    c_, q_, cd_, qd_, cm_, qm_ = t[:6]
    out, stats = walk_forward(c_, q_, cm_, qm_, *t[6:], ops[9], _walk(T_q, walk_ranks, walk_tiles),
                              cd=cd_, qd=qd_, stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **bk.TOLERANCE)
    nt = -(-T_q // tq)
    per = -(-nt // blocks)
    tiles = [[(k * tq, min((k + 1) * tq, T_q)) for k in range(r * per, min((r + 1) * per, nt))]
             for r in range(-(-nt // per))]
    got = tiled_backward(*ops, torch.from_numpy(g), stats, tiles)
    ref = [*j_dx, j_dp["w_c"], j_dp["w_q"], j_dp["w_cq"], j_dp["bias"]]
    tol = bk.BACKWARD_TOLERANCE
    for name, o, r in zip(("d_c", "d_q", "d_cd", "d_qd", "dw_c", "dw_q", "dw_cq", "dbias"), got, ref):
        r = np.asarray(r)
        err = np.abs(o.numpy() - r).max()
        assert err <= tol["atol"] + tol["rtol"] * np.abs(r).max(), (name, err)
    # example 1's q is fully masked: s_row is uniform over T_q (L = T_q)
    torch.testing.assert_close(stats[1, 1], torch.full((T_c,), float(T_q)))


def test_tiled_route_is_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions whatever the
    route (here the tiled one, T_c=64), move no counter, and the forward
    returns no row statistics."""
    rng = np.random.default_rng(3)
    B, T_c, T_q, D = 2, 64, 70, 8
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    ops = (f(B, T_c, D), f(B, T_q, D), f(B, T_c, D), f(B, T_q, D), torch.ones(B, T_c),
           torch.ones(B, T_q), f(D), f(D), f(D), torch.tensor(0.1))
    assert bk.drop_route(T_c, T_q, 256) == "tiled"
    counts = (bk.bidaf_dropout_forward.launches, dict(bk.bidaf_dropout_forward.routes),
              bk.bidaf_dropout_backward.launches, dict(bk.bidaf_dropout_backward.routes))
    out, stats = bk.bidaf_dropout_forward(*ops, with_stats=True)
    assert stats is None
    torch.testing.assert_close(out, bk.bidaf_dropout_reference(*ops), rtol=0, atol=0)
    g = f(B, T_c, 4 * D)
    for o, r in zip(bk.bidaf_dropout_backward(*ops, g),
                    bk.bidaf_dropout_backward_reference(*ops, g)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert counts == (bk.bidaf_dropout_forward.launches, dict(bk.bidaf_dropout_forward.routes),
                      bk.bidaf_dropout_backward.launches, dict(bk.bidaf_dropout_backward.routes))
