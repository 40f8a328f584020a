"""K2, K9, K7 and K8: the BiDAF attention kernels (``csrc/bidaf.cu``,
``csrc/bidaf_tiled.cu``, ``csrc/bidaf_bwd.cu``) and their plain versions.

K2 is the port of ``mmbidaf_tpu/ops/pallas/bidaf_kernel.py::bidaf_attention_fused``
(inference path, no dropout). Inputs are cast to f32 as on the TPU
(``bidaf_kernel.py:117-125``); the output is f32 ``[B, T_c, 4D]``. K2 runs
K7's cluster body with S formed from ``c`` and ``q`` themselves
(``csrc/bidaf.cu::bidaf_fwd_cluster_kernel``; the same sums in the same
order, so K2 gives K7's bits at ``cd = c, qd = q``), on :func:`fused_plan`:
K7's split, judged on the forward section of the block's layout alone.
Past that plan (T_q > 2048 at T_c=32, D=256: the 4096-frame audio tower)
its wrapper hands the shape to K9, the port of
``bidaf_tiled_kernel.py::bidaf_attention_tiled``: the same function, on
K2's launch too (a cluster an example), each rank walking its span of q
columns tile by tile with flash-style row statistics, the ranks combined
in a fixed order (:func:`tiled_plan`; :func:`bidaf_route`;
``bidaf_attention_fused.routes`` counts both). Both are hand kernels;
neither falls back.

K7 and K8 are the training pair, the port of
``bidaf_attention_fused_dropout`` and its custom VJP: the forward forms S
from the dropped ``cd``/``qd`` and everything after S from the undropped
``c``/``q``; the backward recomputes S and both softmaxes and returns
``d_c, d_q, d_cd, d_qd`` and the parameter grads summed over the batch.
Both split each example over T_q across a thread-block cluster
(``csrc/bidaf_cluster.cuh``; :func:`drop_plan` mirrors its plan, sized by
K8's block): each block
keeps its q tile and the tile's S in shared memory, the row softmax is
combined from per-tile maxima and sums as K9 does, and every sum across
tiles or over the batch runs in a fixed order through distributed shared
memory (no atomics, so two runs agree bit for bit). :class:`BiDAFDropoutFn`
ties them into one ``torch.autograd.Function``; the dropout masks are drawn
outside (``cd = c·m/keep``) and autograd adds ``d_cd·m/keep`` to ``d_c``.
``bidaf_attention_fused_trainable`` is the ``cd = c, qd = q`` case.

Each wrapper (``bidaf_attention_fused`` K2, ``bidaf_attention_tiled`` K9,
``bidaf_dropout_forward`` K7, ``bidaf_dropout_backward`` K8) runs its plain
version on a CPU tensor and launches its kernel on a CUDA tensor, or raises
— K7/K8 also, before any launch, for shapes with no cluster plan (at T_c=32,
D=256, T_q past 1088), K9 for shapes with no walk plan (at D=256, T_c past
4288), and K2, K7, K8 and K9 where the card holds none of the plan's
clusters. ``<wrapper>.launches`` counts launches of its own kernel. K2's
wrapper calls the custom op ``torch.ops.mmbidaf.bidaf`` (CPU: the plain
version; CUDA: K2's or K9's launch, which alone moves the counters; fake:
the output's shape), so ``torch.export`` keeps the block as one node.

Tolerances of kernel vs plain on the card: K2/K7/K9 form Q2C as
``(s_row·s_colᵀ)·c`` where the plain version contracts ``s_row, s_col, c``
in einsum's order, and sum every product in their own order; K7 and K9
combine the row softmax from per-tile maxima and sums. On outputs up to
~12 in magnitude (unit-normal c and q, D=256) the largest error measured
on an H100 was 5.2e-6 (K2), 1.1e-5 (K7 at T_q=512) and 7.9e-6 (K9 at
T_q=4096), so ``atol = 5e-5, rtol = 1e-5``. K8 reassociates
``qc = s_colᵀ·c`` and ``d_qc = s_rowᵀ·d_b`` through ``[T_c, T_c]`` products
and sums the parameter grads over B·T_c or B·T_q products, so it is held
normwise: each output within ``atol + rtol·max|ref|`` of that output. dbias
is a sum of terms that cancel to ~0 (each softmax's gradient sums to zero),
so only the atol bounds it. With unit-normal c, q and cotangent at the
bench_train shapes (B=32, T_q=16 and 512) the largest errors measured on an
H100 were 1.7e-5 on d_c/d_q/d_cd/d_qd up to 36, 4.9e-4 on the parameter
grads up to 1140 (4e-7 of their scale) and 2.2e-5 on dbias, so
``BACKWARD_TOLERANCE`` (``atol = 5e-4, rtol = 2e-6``, normwise) leaves a 5x
margin on the parameter grads and 20x on dbias.
"""

from __future__ import annotations

import functools
import types
from typing import NamedTuple

import torch

from mmbidaf_tpu_torch.ops.bidaf import attend, bidaf_apply, similarity_matrix
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.masked import NEG_INF

TOLERANCE = {"atol": 5e-5, "rtol": 1e-5}
# K8 vs its plain version on the card, per output: |err| <= atol + rtol·max|ref|.
BACKWARD_TOLERANCE = {"atol": 5e-4, "rtol": 2e-6}

SMEM_LIMIT_BYTES = build.SMEM_LIMIT_BYTES

# K9's walk (csrc/bidaf_tiled.cu): ranks a cluster at most, q columns a rank
# at least where T_q allows, q tiles in flight a block.
_WALK_CLUSTER = 6
_MIN_SPAN = 64
_STAGES = 2


class TiledPlan(NamedTuple):
    """How K9 walks one ``T_c x T_q`` example at width ``D``: a cluster of
    ``C`` blocks, rank ``r`` walking the q columns ``spans[r] = (begin,
    end)`` (``span`` wide, the last maybe fewer) in tiles of at most ``tq``
    columns (``tiles``, every rank's in rank order), ``c∘w_cq`` held in
    shared memory (``resident``) or read from device memory, the dynamic
    shared memory a block in bytes, and the floats of device memory a block
    where ``a_acc`` and ``P_acc`` spill there (``work``; 0: in shared
    memory)."""
    C: int
    span: int
    tq: int
    resident: bool
    smem: int
    work: int
    spans: tuple
    tiles: tuple


def _odd4(n: int) -> int:
    """A float4 row stride: ``n`` rounded up to 4 with an odd number of fours."""
    m = _round4(n)
    return m if (m // 4) % 2 else m + 4


def _walk_smem(T_c: int, tq: int, D: int, C: int, resident: bool, spill: bool) -> tuple[int, int]:
    """K9's dynamic shared memory a block in bytes and its floats of device
    memory (``bidaf_tiled.cu::WalkLayout``): sections of floats, each
    rounded up to four. The walk's dead sections come first and hold the
    combine's P where it fits (a cluster of one combines in place), or with
    ``spill`` the weights of the rank's rows, a_acc ``[T_c, LD]`` and P_acc
    ``[T_c, LT]`` then in device memory."""
    LD, LQ, LT, tq4 = _odd4(D), _odd4(tq), T_c | 1, _round4(tq)
    dead = sum(map(_round4, (_STAGES * tq4 * LD, T_c * LD if resident else 0, T_c * LQ, T_c * LQ,
                             T_c, T_c, D, T_c, _STAGES * tq4)))
    if spill:
        return 4 * (dead + 2 * _round4(T_c)), T_c * LD + _round4(T_c * LT)
    live = sum(map(_round4, (T_c * LD, T_c * LT, T_c, T_c, C * T_c, C * T_c)))
    pf = _round4(T_c * LT)
    return 4 * (dead + live + (pf if C > 1 and pf > dead else 0)), 0


@functools.lru_cache(maxsize=64)
def tiled_plan(T_c: int, T_q: int, D: int, tq_blk: int = 128) -> TiledPlan:
    """K9's plan (``bidaf_tiled.cu::walk_plan``): ``C = ceil(T_q / 64)`` ranks
    up to 6 (an H100 holds only 15 clusters of 8 one-SM blocks at once, so
    B=16 would take two waves), spans of ``ceil(T_q / C)`` columns (then ``C = ceil(T_q /
    span)``, so none is empty), and the fewest walk tiles a span, each at
    most ``tq_blk`` columns, whose block fits Hopper's shared memory with
    ``c∘w_cq`` resident, else without; past that (long contexts: a_acc
    ``[T_c, D]`` and P_acc ``[T_c, T_c]`` too large for a block) the same
    with both accumulators in device memory. Raises ``ValueError`` where no
    block fits."""
    if min(T_c, T_q, D, tq_blk) <= 0:
        raise ValueError(f"no K9 plan for T_c={T_c}, T_q={T_q}, D={D}, tq_blk={tq_blk}")
    C = min(-(-T_q // _MIN_SPAN), _WALK_CLUSTER)
    span = -(-T_q // C)
    C = -(-T_q // span)
    for spill in (False, True):
        for resident in (True, False):
            for n in range(-(-span // min(tq_blk, span)), span + 1):
                tq = -(-span // n)
                smem, work = _walk_smem(T_c, tq, D, C, resident, spill)
                if smem <= SMEM_LIMIT_BYTES:
                    spans = tuple((r * span, min((r + 1) * span, T_q)) for r in range(C))
                    tiles = tuple((j, min(j + tq, end)) for begin, end in spans
                                  for j in range(begin, end, tq))
                    return TiledPlan(C, span, tq, resident, smem, work, spans, tiles)
    raise ValueError(f"no K9 plan for T_c={T_c}, T_q={T_q}, D={D}: a block of one q column "
                     f"needs {_walk_smem(T_c, 1, D, C, False, True)[0]} bytes of shared memory, "
                     f"over the {SMEM_LIMIT_BYTES} a block has")


def bidaf_route(T_c: int, T_q: int, D: int) -> str:
    """The hand kernel ``bidaf_attention_fused`` launches on the card:
    ``"cluster"`` (K2) where :func:`fused_plan` holds, else ``"K9"``."""
    try:
        fused_plan(T_c, T_q, D)
    except ValueError:
        return "K9"
    return "cluster"


# K2 / K7 / K8's cluster plan (csrc/bidaf_cluster.cuh): q columns a block
# where T_q allows, and the largest cluster.
_TARGET_TILE = 32
_MAX_CLUSTER = 16


class DropPlan(NamedTuple):
    """How K2, K7 and K8 split one ``T_c x T_q`` example at width ``D``: a
    cluster of ``C`` blocks, block ``r`` owning the q columns ``tiles[r] =
    (begin, end)`` (``tq`` the widest) and the D columns ``[r·D/C,
    (r+1)·D/C)`` of the sums over the tiles, and the dynamic shared memory
    a block of the forward (K2, K7) and of the backward (K8) in bytes."""
    C: int
    tq: int
    tiles: tuple
    smem_fwd: int
    smem_bwd: int


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _drop_smem(T_c: int, tq: int, D: int, C: int) -> tuple[int, int]:
    """The forward's (K2, K7) and K8's dynamic shared memory a block
    (``bidaf_cluster.cuh::Layout``): sections of floats, each rounded up to
    four, rows of odd stride."""
    LD, LQ, LT = D | 1, tq | 1, T_c | 1
    fwd = sum(map(_round4, (tq * LD, T_c * LD, T_c * LQ, T_c * LQ, T_c * LQ, T_c * LT, T_c * LT,
                            T_c, T_c, T_c, tq, C * T_c, C * T_c, 2 * T_c * (-(-D // C) | 1))))
    bwd = fwd + sum(map(_round4, (T_c * LD, T_c * LD, T_c * LQ, T_c * LT, T_c * LT, T_c, T_c, T_c,
                                  T_c, tq, D)))
    return 4 * fwd, 4 * bwd


def _split(T_c: int, T_q: int, D: int) -> DropPlan:
    """``bidaf_cluster.cuh::plan``'s split, whether a block fits or not:
    ``C = ceil(T_q / 32)`` blocks up to 16, tiles of ``tq = ceil(T_q / C)``
    columns, then ``C = ceil(T_q / tq)`` so that none is empty. Raises
    ``ValueError`` for an empty shape."""
    if T_c <= 0 or T_q <= 0 or D <= 0:
        raise ValueError(f"no BiDAF cluster plan for T_c={T_c}, T_q={T_q}, D={D}")
    C = min(-(-T_q // _TARGET_TILE), _MAX_CLUSTER)
    tq = -(-T_q // C)
    C = -(-T_q // tq)
    tiles = tuple((r * tq, min((r + 1) * tq, T_q)) for r in range(C))
    return DropPlan(C, tq, tiles, *_drop_smem(T_c, tq, D, C))


def _fitting(plan: DropPlan, kernel: str, smem: int, T_c: int, T_q: int, D: int) -> DropPlan:
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"no BiDAF cluster plan for T_c={T_c}, T_q={T_q}, D={D}: a {kernel} block "
                         f"of {plan.tq} q columns needs {smem} bytes of shared memory, over the "
                         f"{SMEM_LIMIT_BYTES} a block has")
    return plan


def drop_plan(T_c: int, T_q: int, D: int) -> DropPlan:
    """The cluster plan of K7 and K8 (``bidaf_cluster.cuh::plan``), sized by
    K8's block. Raises ``ValueError`` where that block does not fit
    Hopper's shared memory."""
    plan = _split(T_c, T_q, D)
    return _fitting(plan, "K8", plan.smem_bwd, T_c, T_q, D)


def fused_plan(T_c: int, T_q: int, D: int) -> DropPlan:
    """K2's cluster plan (``bidaf_cluster.cuh::plan`` with ``fwd_only``): the
    same split, judged on the forward section of the layout (``smem_fwd``).
    Raises ``ValueError`` where that does not fit Hopper's shared memory."""
    plan = _split(T_c, T_q, D)
    return _fitting(plan, "K2", plan.smem_fwd, T_c, T_q, D)


_occupancy_checked: set = set()


def _check_cluster(lib, entry: str, plan: DropPlan, T_c: int, T_q: int, D: int) -> None:
    """Once per shape, that the card can hold one of the plan's clusters
    (``cudaOccupancyMaxActiveClusters > 0``); raises otherwise, before
    anything is launched."""
    key = (entry, T_c, T_q, D)
    if key not in _occupancy_checked:
        n = getattr(lib, f"{entry}_occupancy")(T_c, T_q, D)
        if n <= 0:
            raise RuntimeError(f"{entry}: the card holds no cluster of {plan.C} blocks of this plan "
                               f"({plan.smem_fwd} / {plan.smem_bwd} bytes of shared memory a block "
                               f"for the forward / K8; cudaOccupancyMaxActiveClusters {n})")
        _occupancy_checked.add(key)


def _f32_params(params) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{k: getattr(params, k).float()
                                    for k in ("w_c", "w_q", "w_cq", "bias")})


def bidaf_reference(params, c, q, c_mask, q_mask) -> torch.Tensor:
    """Plain PyTorch version: ``ops.bidaf.bidaf_apply`` on f32-cast inputs."""
    return bidaf_apply(_f32_params(params), c.float(), q.float(), c_mask.float(), q_mask.float())


# K9 computes K2's function; its plain version is K2's.
bidaf_tiled_reference = bidaf_reference


def _operands(params, c, q, c_mask, q_mask) -> list[torch.Tensor]:
    """K2's / K9's operands as checked contiguous f32 tensors, in the C
    entry points' order (c, q, c_mask, q_mask, w_c, w_q, w_cq, bias)."""
    B, T_c, D = c.shape
    T_q = q.shape[1]
    p = _f32_params(params)
    args = {
        "c": (c.float().contiguous(), (B, T_c, D)),
        "q": (q.float().contiguous(), (B, T_q, D)),
        "c_mask": (c_mask.float().contiguous(), (B, T_c)),
        "q_mask": (q_mask.float().contiguous(), (B, T_q)),
        "w_c": (p.w_c.contiguous(), (D,)),
        "w_q": (p.w_q.contiguous(), (D,)),
        "w_cq": (p.w_cq.contiguous(), (D,)),
        "bias": (p.bias.reshape(1).contiguous(), (1,)),
    }
    for name, (t, shape) in args.items():
        build.check_tensor(t, name, shape, c.device)
    return [t for t, _ in args.values()]


def bidaf_attention_fused(params, c, q, c_mask, q_mask) -> torch.Tensor:
    """The whole BiDAF block through a hand kernel → f32 ``[B, T_c, 4D]``:
    K2 on its cluster route, or K9 where :func:`bidaf_route` says so, through
    the custom op ``torch.ops.mmbidaf.bidaf`` (one node in an exported
    program). ``bidaf_attention_fused.launches`` counts K2's launches,
    ``bidaf_attention_fused.routes`` the calls of each route; both move only
    where a kernel launches."""
    build.check_device(c, "bidaf_attention_fused")
    return torch.ops.mmbidaf.bidaf(c, q, c_mask, q_mask, params.w_c, params.w_q, params.w_cq,
                                   params.bias)


bidaf_attention_fused.launches = 0
bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}


@torch.library.custom_op("mmbidaf::bidaf", mutates_args=(), device_types="cpu")
def bidaf_op(c: torch.Tensor, q: torch.Tensor, c_mask: torch.Tensor, q_mask: torch.Tensor,
             w_c: torch.Tensor, w_q: torch.Tensor, w_cq: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """K2 (and K9 past its plan) as a custom op: ``c [B, T_c, D]``, ``q [B,
    T_q, D]``, their masks, ``w_c``, ``w_q``, ``w_cq [D]`` and the scalar
    ``bias`` → f32 ``[B, T_c, 4D]``. On the CPU, the plain version."""
    p = types.SimpleNamespace(w_c=w_c, w_q=w_q, w_cq=w_cq, bias=bias)
    return bidaf_reference(p, c, q, c_mask, q_mask).contiguous()


@bidaf_op.register_kernel("cuda")
def _bidaf_launch(c, q, c_mask, q_mask, w_c, w_q, w_cq, bias):
    params = types.SimpleNamespace(w_c=w_c, w_q=w_q, w_cq=w_cq, bias=bias)
    B, T_c, D = c.shape
    T_q = q.shape[1]
    route = bidaf_route(T_c, T_q, D)
    if route == "K9":
        out = bidaf_attention_tiled(params, c, q, c_mask, q_mask)
    else:
        ops = _operands(params, c, q, c_mask, q_mask)
        lib = build.library()
        _check_cluster(lib, "mmb_bidaf_forward", fused_plan(T_c, T_q, D), T_c, T_q, D)
        out = torch.empty(B, T_c, 4 * D, device=c.device)
        rc = lib.mmb_bidaf_forward(
            *(t.data_ptr() for t in ops), out.data_ptr(),
            B, T_c, T_q, D, torch.cuda.current_stream(c.device).cuda_stream,
        )
        build.check_launch(lib, rc, "mmb_bidaf_forward")
        bidaf_attention_fused.launches += 1
    bidaf_attention_fused.routes[route] += 1
    return out


@bidaf_op.register_fake
def _bidaf_fake(c, q, c_mask, q_mask, w_c, w_q, w_cq, bias):
    B, T_c, D = c.shape
    return c.new_empty(B, T_c, 4 * D, dtype=torch.float32)


def bidaf_attention_tiled(params, c, q, c_mask, q_mask, tc_blk: int = 128,
                          tq_blk: int = 128) -> torch.Tensor:
    """K9: the BiDAF block walked over q tiles → f32 ``[B, T_c, 4D]``, K2's
    function for any T_q, in one launch (plan: :func:`tiled_plan`; the last
    tiles are cut short, not padded), with no device memory but the output
    unless the context is too long for the accumulators to fit a block
    (``plan.work``). ``tq_blk`` caps the walk tile;
    ``tc_blk`` keeps the JAX signature and does nothing on the card, where
    every tile holds all T_c rows (the column softmax is exact inside it).
    ``bidaf_attention_tiled.launches`` counts kernel launches."""
    build.check_device(c, "bidaf_attention_tiled")
    if c.device.type == "cpu":
        return bidaf_tiled_reference(params, c, q, c_mask, q_mask)
    B, T_c, D = c.shape
    T_q = q.shape[1]
    plan = tiled_plan(T_c, T_q, D, tq_blk)
    ops = _operands(params, c, q, c_mask, q_mask)
    lib = build.library()
    key = ("mmb_bidaf_tiled_forward", T_c, T_q, D, tq_blk)
    if key not in _occupancy_checked:
        n = lib.mmb_bidaf_tiled_forward_occupancy(T_c, T_q, D, tq_blk)
        if n <= 0:
            raise RuntimeError(f"bidaf_attention_tiled: the card holds no cluster of {plan.C} "
                               f"blocks of {plan.smem} bytes of shared memory "
                               f"(cudaOccupancyMaxActiveClusters {n})")
        _occupancy_checked.add(key)
    out = torch.empty(B, T_c, 4 * D, device=c.device)
    work = torch.empty(B * plan.C * plan.work, device=c.device) if plan.work else None
    rc = lib.mmb_bidaf_tiled_forward(
        *(t.data_ptr() for t in ops), out.data_ptr(), None if work is None else work.data_ptr(),
        B, T_c, T_q, D, tq_blk,
        torch.cuda.current_stream(c.device).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bidaf_tiled_forward")
    bidaf_attention_tiled.launches += 1
    return out


bidaf_attention_tiled.launches = 0


# ---------------------------------------------------------------------------
# K7 / K8: the training pair. Operands are f32 tensors; ``p`` is the
# (w_c, w_q, w_cq, bias) tuple with a scalar bias.
# ---------------------------------------------------------------------------


def bidaf_dropout_reference(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias):
    """Plain version of K7: S from ``cd``/``qd``, the rest from ``c``/``q``."""
    p = types.SimpleNamespace(w_c=w_c, w_q=w_q, w_cq=w_cq, bias=bias)
    return attend(similarity_matrix(p, cd, qd), c, q, c_mask, q_mask)


def bidaf_dropout_backward_reference(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, g):
    """Plain version of K8, the TPU kernel's arithmetic (``_bidaf_drop_bwd_kernel``)
    batched: → ``(d_c, d_q, d_cd, d_qd, dw_c, dw_q, dw_cq, dbias)``."""
    D = c.shape[-1]
    T = lambda x: x.transpose(1, 2)  # noqa: E731
    cw = cd * w_cq
    S = (cd @ w_c)[:, :, None] + (qd @ w_q)[:, None, :] + cw @ T(qd) + bias
    qm, cm = q_mask[:, None, :], c_mask[:, :, None]
    s_row = torch.softmax(qm * S + (1.0 - qm) * NEG_INF, dim=2)
    s_col = torch.softmax(cm * S + (1.0 - cm) * NEG_INF, dim=1)
    a = s_row @ q
    qc = T(s_col) @ c
    b = s_row @ qc
    g0, g1, g2, g3 = (g[..., k * D:(k + 1) * D] for k in range(4))
    d_c = g0 + g2 * a + g3 * b
    d_a = g1 + g2 * c
    d_b = g3 * c
    d_s_row = d_b @ T(qc) + d_a @ T(q)
    d_qc = T(s_row) @ d_b
    d_s_col = c @ T(d_qc)
    d_c = d_c + s_col @ d_qc
    d_q = T(s_row) @ d_a
    dS = qm * (s_row * (d_s_row - (d_s_row * s_row).sum(dim=2, keepdim=True)))
    dS = dS + cm * (s_col * (d_s_col - (d_s_col * s_col).sum(dim=1, keepdim=True)))
    d_s0 = dS.sum(dim=2, keepdim=True)
    d_s1 = dS.sum(dim=1)[:, :, None]
    dSq = dS @ qd
    d_cd = d_s0 * w_c + dSq * w_cq
    d_qd = d_s1 * w_q + T(dS) @ cw
    return (d_c, d_q, d_cd, d_qd, (cd * d_s0).sum(dim=(0, 1)), (qd * d_s1).sum(dim=(0, 1)),
            (dSq * cd).sum(dim=(0, 1)), dS.sum())


def _check_drop_operands(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias):
    B, T_c, D = c.shape
    T_q = q.shape[1]
    dev = c.device
    for name, t, shape in (("c", c, (B, T_c, D)), ("q", q, (B, T_q, D)), ("cd", cd, (B, T_c, D)),
                           ("qd", qd, (B, T_q, D)), ("c_mask", c_mask, (B, T_c)),
                           ("q_mask", q_mask, (B, T_q)), ("w_c", w_c, (D,)), ("w_q", w_q, (D,)),
                           ("w_cq", w_cq, (D,)), ("bias", bias, ())):
        build.check_tensor(t, name, shape, dev)
    return B, T_c, T_q, D, dev


def bidaf_dropout_forward(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias) -> torch.Tensor:
    """K7 (contract of :func:`bidaf_dropout_reference`) → f32 ``[B, T_c, 4D]``;
    the shape must have a :func:`drop_plan`. ``bidaf_dropout_forward.launches``
    counts kernel launches."""
    if c.device.type == "cpu":
        return bidaf_dropout_reference(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
    if c.device.type != "cuda":
        raise ValueError(f"bidaf_dropout_forward: unsupported device {c.device}")
    ops = (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
    B, T_c, T_q, D, dev = _check_drop_operands(*ops)
    lib = build.library()
    _check_cluster(lib, "mmb_bidaf_forward_dropout", drop_plan(T_c, T_q, D), T_c, T_q, D)
    out = torch.empty(B, T_c, 4 * D, device=dev)
    rc = lib.mmb_bidaf_forward_dropout(*(t.data_ptr() for t in ops), out.data_ptr(),
                                       B, T_c, T_q, D, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, rc, "mmb_bidaf_forward_dropout")
    bidaf_dropout_forward.launches += 1
    return out


bidaf_dropout_forward.launches = 0


def bidaf_dropout_backward(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, g):
    """K8 (contract of :func:`bidaf_dropout_backward_reference`) → ``(d_c,
    d_q, d_cd, d_qd, dw_c, dw_q, dw_cq, dbias)``; the shape must have a
    :func:`drop_plan`. ``bidaf_dropout_backward.launches`` counts calls that
    launched it (two kernels a call)."""
    if c.device.type == "cpu":
        return bidaf_dropout_backward_reference(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq,
                                                bias, g)
    if c.device.type != "cuda":
        raise ValueError(f"bidaf_dropout_backward: unsupported device {c.device}")
    ops = (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
    B, T_c, T_q, D, dev = _check_drop_operands(*ops)
    build.check_tensor(g, "g", (B, T_c, 4 * D), dev)
    lib = build.library()
    _check_cluster(lib, "mmb_bidaf_backward", drop_plan(T_c, T_q, D), T_c, T_q, D)
    d_c, d_cd = torch.empty_like(c), torch.empty_like(c)
    d_q, d_qd = torch.empty_like(q), torch.empty_like(q)
    partial = torch.empty(B, 3 * D + 1, device=dev)
    d_params = torch.empty(3 * D + 1, device=dev)
    rc = lib.mmb_bidaf_backward(
        *(t.data_ptr() for t in ops), g.data_ptr(), d_c.data_ptr(), d_q.data_ptr(),
        d_cd.data_ptr(), d_qd.data_ptr(), partial.data_ptr(), d_params.data_ptr(),
        B, T_c, T_q, D, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bidaf_backward")
    bidaf_dropout_backward.launches += 1
    return (d_c, d_q, d_cd, d_qd, d_params[:D], d_params[D:2 * D], d_params[2 * D:3 * D],
            d_params[3 * D])


bidaf_dropout_backward.launches = 0


class BiDAFDropoutFn(torch.autograd.Function):
    """The BiDAF block with similarity-only dropout operands: K7 forward, K8
    backward. All inputs f32 and contiguous; ``bias`` is a 0-d tensor."""

    @staticmethod
    def forward(ctx, c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias):
        ops = (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
        ctx.save_for_backward(*ops)
        return bidaf_dropout_forward(*ops)

    @staticmethod
    def backward(ctx, g):
        d_c, d_q, d_cd, d_qd, dw_c, dw_q, dw_cq, dbias = bidaf_dropout_backward(
            *ctx.saved_tensors, g.contiguous())
        return d_c, d_q, d_cd, d_qd, None, None, dw_c, dw_q, dw_cq, dbias


def bidaf_attention_fused_dropout(params, c, q, cd, qd, c_mask, q_mask) -> torch.Tensor:
    """The BiDAF block for training with dropped similarity operands ``cd``,
    ``qd`` (``bidaf_attention_fused_dropout``'s contract) → f32 ``[B, T_c, 4D]``;
    gradients reach ``c, q, cd, qd`` and the parameters through K8."""
    f = lambda x: x.float().contiguous()  # noqa: E731
    return BiDAFDropoutFn.apply(f(c), f(q), f(cd), f(qd), f(c_mask), f(q_mask), f(params.w_c),
                                f(params.w_q), f(params.w_cq), f(params.bias).reshape(()))


def bidaf_attention_fused_trainable(params, c, q, c_mask, q_mask) -> torch.Tensor:
    """The dropout-free training block: the ``cd = c, qd = q`` case."""
    return bidaf_attention_fused_dropout(params, c, q, c, q, c_mask, q_mask)
