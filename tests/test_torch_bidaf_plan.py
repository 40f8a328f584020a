"""K2, K7 and K8's split of an example over T_q across a thread-block
cluster, on the CPU.

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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused as j_bidaf_fused
from mmbidaf_tpu.ops.pallas.bidaf_kernel import bidaf_attention_fused_dropout as j_bidaf_drop
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


@pytest.mark.parametrize("T_c,T_q,D", [
    (32, 4096, 256),  # 16 tiles of 256 columns
    (128, 512, 256),  # the [T_c, D] operands alone pass a block's shared memory
    (0, 16, 8), (4, 0, 8), (4, 16, 0),
])
def test_drop_plan_refuses_what_no_block_holds(T_c, T_q, D):
    with pytest.raises(ValueError, match="no BiDAF cluster plan"):
        bk.drop_plan(T_c, T_q, D)


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
    bk.tiled_blocks(32, edge + 1, 256)


@pytest.mark.parametrize("T_c,D", [(32, 256), (5, 40), (64, 384), (128, 64)])
def test_fused_plan_is_the_drop_plan_where_both_hold(T_c, D):
    for T_q in (1, 7, 16, 33, 100, 512, 1000):
        try:
            drop = bk.drop_plan(T_c, T_q, D)
        except ValueError:
            continue
        assert bk.fused_plan(T_c, T_q, D) == drop


def _first_k2_smem_bytes(T_c: int, T_q: int, D: int) -> int:
    """The shared memory of K2's first body (one block an example: c, a
    streamed q tile of 32 rows, S and s_col, P and three vectors), which
    decided what its wrapper took."""
    return 4 * (T_c * D + 32 * (D + 1) + 2 * T_c * (T_q + 1) + T_c * T_c + T_c + 32 + D)


def test_no_shape_the_first_k2_body_took_is_refused():
    """Over a grid of shapes, every one the first body took has a route now:
    K2's cluster plan, or K9's blocks."""
    took = 0
    for T_c in (1, 5, 32, 33, 64, 100, 128, 160):
        for T_q in (1, 16, 33, 100, 512, 1024, 1500):
            for D in (8, 40, 256, 384, 512, 1024, 1500):
                if _first_k2_smem_bytes(T_c, T_q, D) > SMEM_LIMIT:
                    continue
                took += 1
                if bk.bidaf_route(T_c, T_q, D) == "K9":
                    bk.tiled_blocks(T_c, T_q, D)  # raises if K9's blocks do not fit
    assert took > 100


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
