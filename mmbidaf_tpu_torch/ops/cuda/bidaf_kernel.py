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
memory (no atomics, so two runs agree bit for bit). Where no cluster block
holds the shape (K8's block keeps every ``[T_c, D]`` operand of an example:
none fits past T_c=40 at D=256, so the capability configs' 64 sentences and
long audio), both take the tiled route (:func:`drop_route`): K7 on K9's
walk with S formed from ``cd``/``qd`` (``bidaf_tiled.cu``, ``kDrop``), which
also writes each row's softmax maximum and sum, and K8 on
``csrc/bidaf_tiled_bwd.cu`` (five launches: the ``[T_c, D]`` arrays in a
device-memory workspace, the q tiles walked twice by independent blocks,
every sum in a fixed order). :class:`BiDAFDropoutFn` ties them into one
``torch.autograd.Function``, one route for the forward and the backward;
the dropout masks are drawn outside (``cd = c·m/keep``) and autograd adds
``d_cd·m/keep`` to ``d_c``. ``bidaf_attention_fused_trainable`` is the
``cd = c, qd = q`` case.

Each wrapper (``bidaf_attention_fused`` K2, ``bidaf_attention_tiled`` K9,
``bidaf_dropout_forward`` K7, ``bidaf_dropout_backward`` K8) runs its plain
version on a CPU tensor and launches its kernel on a CUDA tensor, or raises
— K7/K8 also, before any launch, for shapes with neither route (at D=256,
T_c past ~4000), K9 for shapes with no walk plan (at D=256, T_c past
4288), and K2, K7, K8 and K9 where the card holds none of the plan's
clusters. ``<wrapper>.launches`` counts launches of its own kernel, and
K2's, K7's and K8's ``.routes`` the launches of each route. K2's
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
margin on the parameter grads and 20x on dbias. The tiled route is held to
the same bounds (K8 against its plain version run in f64: dbias is a sum of
B·T_c·T_q terms that cancel, and at T_q=4096 the f32 plain version's own
sums over T_q are as far from exact as the bound).
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


def _walk_smem(T_c: int, tq: int, D: int, C: int, resident: bool, spill: bool,
               drop: bool = False) -> tuple[int, int]:
    """K9's dynamic shared memory a block in bytes and its floats of device
    memory (``bidaf_tiled.cu::WalkLayout``): sections of floats, each
    rounded up to four. The walk's dead sections come first and hold the
    combine's P where it fits (a cluster of one combines in place), or with
    ``spill`` the weights of the rank's rows, a_acc ``[T_c, LD]`` and P_acc
    ``[T_c, LT]`` then in device memory. ``drop``: K7's tiled route, whose
    block holds a second ring of tiles (qd's beside q's)."""
    LD, LQ, LT, tq4 = _odd4(D), _odd4(tq), T_c | 1, _round4(tq)
    dead = sum(map(_round4, (_STAGES * tq4 * LD, _STAGES * tq4 * LD if drop else 0,
                             T_c * LD if resident else 0, T_c * LQ, T_c * LQ,
                             T_c, T_c, D, T_c, _STAGES * tq4)))
    if spill:
        return 4 * (dead + 2 * _round4(T_c)), T_c * LD + _round4(T_c * LT)
    live = sum(map(_round4, (T_c * LD, T_c * LT, T_c, T_c, C * T_c, C * T_c)))
    pf = _round4(T_c * LT)
    return 4 * (dead + live + (pf if C > 1 and pf > dead else 0)), 0


@functools.lru_cache(maxsize=64)
def tiled_plan(T_c: int, T_q: int, D: int, tq_blk: int = 128, drop: bool = False) -> TiledPlan:
    """K9's plan (``bidaf_tiled.cu::walk_plan``): ``C = ceil(T_q / 64)`` ranks
    up to 6 (an H100 holds only 15 clusters of 8 one-SM blocks at once, so
    B=16 would take two waves), spans of ``ceil(T_q / C)`` columns (then ``C = ceil(T_q /
    span)``, so none is empty), and the fewest walk tiles a span, each at
    most ``tq_blk`` columns, whose block fits Hopper's shared memory with
    ``c∘w_cq`` resident, else without; past that (long contexts: a_acc
    ``[T_c, D]`` and P_acc ``[T_c, T_c]`` too large for a block) the same
    with both accumulators in device memory. ``drop``: the plan of K7's
    tiled route (``walk_plan(..., drop)``: K9's walk with a second ring for
    qd's tiles). Raises ``ValueError`` where no block fits."""
    if min(T_c, T_q, D, tq_blk) <= 0:
        raise ValueError(f"no K9 plan for T_c={T_c}, T_q={T_q}, D={D}, tq_blk={tq_blk}")
    C = min(-(-T_q // _MIN_SPAN), _WALK_CLUSTER)
    span = -(-T_q // C)
    C = -(-T_q // span)
    for spill in (False, True):
        for resident in (True, False):
            for n in range(-(-span // min(tq_blk, span)), span + 1):
                tq = -(-span // n)
                smem, work = _walk_smem(T_c, tq, D, C, resident, spill, drop)
                if smem <= SMEM_LIMIT_BYTES:
                    spans = tuple((r * span, min((r + 1) * span, T_q)) for r in range(C))
                    tiles = tuple((j, min(j + tq, end)) for begin, end in spans
                                  for j in range(begin, end, tq))
                    return TiledPlan(C, span, tq, resident, smem, work, spans, tiles)
    raise ValueError(f"no K9 plan for T_c={T_c}, T_q={T_q}, D={D}: a block of one q column "
                     f"needs {_walk_smem(T_c, 1, D, C, False, True, drop)[0]} bytes of shared memory, "
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


def _split(T_c: int, T_q: int, D: int, C: int | None = None) -> DropPlan:
    """``bidaf_cluster.cuh::plan``'s split, whether a block fits or not:
    ``C = ceil(T_q / 32)`` blocks up to 16 (or the ``C`` asked for), tiles
    of ``tq = ceil(T_q / C)`` columns, then ``C = ceil(T_q / tq)`` so that
    none is empty. Raises ``ValueError`` for an empty shape."""
    if T_c <= 0 or T_q <= 0 or D <= 0:
        raise ValueError(f"no BiDAF cluster plan for T_c={T_c}, T_q={T_q}, D={D}")
    if C is None:
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
    K8's block: the first split, or where its K8 block does not fit
    Hopper's shared memory, the split asked for one more block at a time up
    to 16 blocks (and T_q) before it refuses. Raises ``ValueError`` where
    no such block fits (:func:`drop_route` then names the tiled route)."""
    plan = _split(T_c, T_q, D)
    for asked in range(min(-(-T_q // _TARGET_TILE), _MAX_CLUSTER) + 1, min(_MAX_CLUSTER, T_q) + 1):
        if plan.smem_bwd <= SMEM_LIMIT_BYTES:
            break
        plan = _split(T_c, T_q, D, asked)
    return _fitting(plan, "K8", plan.smem_bwd, T_c, T_q, D)


def fused_plan(T_c: int, T_q: int, D: int) -> DropPlan:
    """K2's cluster plan (``bidaf_cluster.cuh::plan`` with ``fwd_only``): the
    same split, judged on the forward section of the layout (``smem_fwd``).
    Raises ``ValueError`` where that does not fit Hopper's shared memory."""
    plan = _split(T_c, T_q, D)
    return _fitting(plan, "K2", plan.smem_fwd, T_c, T_q, D)


# K8's tiled route (csrc/bidaf_tiled_bwd.cu): q columns a tile at most,
# blocks an example at most; K7's tiled route walks tiles of at most 128.
_BWD_TILE = 32
_BWD_RANKS = 8
_FINISH_ROWS = 8
_DROP_TILE = 128


class TiledBwdPlan(NamedTuple):
    """How K8's tiled route deals one ``T_c x T_q`` example at width ``D``:
    ``C`` independent blocks, block ``r`` walking the q tiles ``tiles[r]``
    (``per`` of ``tq`` columns, the last maybe fewer) twice; the dynamic
    shared memory of a pass block and of a finish block in bytes, the
    finish blocks an example (8 rows of c each), and the floats of device
    memory the example's workspace holds."""
    C: int
    per: int
    tq: int
    smem: int
    smem_finish: int
    finish_blocks: int
    work: int
    tiles: tuple


def _bwd_smem(T_c: int, tq: int, D: int) -> int:
    """A pass block of K8's tiled route (``bidaf_tiled_bwd.cu::BwdLayout``), bytes."""
    LD, LQ = D | 1, tq | 1
    return 4 * sum(map(_round4, (tq * LD, tq * LD, *(T_c * LQ,) * 5, T_c, tq, T_c, T_c, T_c,
                                 T_c, tq, T_c, tq, tq, D, 1)))


def _bwd_work(T_c: int, D: int, C: int) -> int:
    """The workspace of one example in floats (``bidaf_tiled_bwd.cu::BwdWork``)."""
    TD, TT = T_c * D, T_c * T_c
    return sum(map(_round4, (TD, TD, TD, T_c, TT, C * T_c, C * T_c, C * TD, C * TT, C * TD,
                             C * T_c, C * D, C)))


@functools.lru_cache(maxsize=64)
def tiled_bwd_plan(T_c: int, T_q: int, D: int) -> TiledBwdPlan:
    """K8's tiled plan (``bidaf_tiled_bwd.cu::bwd_plan``): the widest tile of
    32, 16, … 1 columns (at most T_q) whose pass block fits, the
    ``ceil(T_q / tq)`` tiles dealt to ``C = min(tiles, 8)`` blocks in runs
    of ``per = ceil(tiles / C)`` (then ``C = ceil(tiles / per)``, none
    idle). Raises ``ValueError`` where no tile fits."""
    if min(T_c, T_q, D) <= 0:
        raise ValueError(f"no K8 tiled plan for T_c={T_c}, T_q={T_q}, D={D}")
    R = _FINISH_ROWS
    smem_finish = 4 * (2 * _round4(R * T_c) + _round4(R) + _round4(T_c))
    tq = min(T_q, _BWD_TILE)
    while smem_finish <= SMEM_LIMIT_BYTES and tq >= 1:
        smem = _bwd_smem(T_c, tq, D)
        if smem <= SMEM_LIMIT_BYTES:
            nt = -(-T_q // tq)
            C = min(nt, _BWD_RANKS)
            per = -(-nt // C)
            C = -(-nt // per)
            tiles = tuple(tuple((t * tq, min((t + 1) * tq, T_q))
                                for t in range(r * per, min((r + 1) * per, nt))) for r in range(C))
            return TiledBwdPlan(C, per, tq, smem, smem_finish, -(-T_c // R), _bwd_work(T_c, D, C),
                                tiles)
        tq //= 2
    raise ValueError(f"no K8 tiled plan for T_c={T_c}, T_q={T_q}, D={D}: a block of one q "
                     f"column needs {_bwd_smem(T_c, 1, D)} bytes of shared memory and the "
                     f"finish block {smem_finish}, over the {SMEM_LIMIT_BYTES} a block has")


def drop_route(T_c: int, T_q: int, D: int) -> str:
    """The route K7 and K8 take for one shape, forward and backward alike:
    ``"cluster"`` where :func:`drop_plan` holds, else ``"tiled"`` (K7 on
    K9's walk with S from cd and qd, K8 on ``csrc/bidaf_tiled_bwd.cu``)
    where both tiled plans hold. Raises ``ValueError`` where neither does
    (no plain fallback)."""
    try:
        drop_plan(T_c, T_q, D)
        return "cluster"
    except ValueError as cluster_refusal:
        try:
            tiled_plan(T_c, T_q, D, _DROP_TILE, drop=True)
            tiled_bwd_plan(T_c, T_q, D)
        except ValueError as e:
            raise ValueError(f"no K7/K8 route for T_c={T_c}, T_q={T_q}, D={D}: "
                             f"{cluster_refusal}; {e}") from None
        return "tiled"


_occupancy_checked: set = set()


def _check_occupancy(lib, entry: str, args: tuple, what: str) -> None:
    """Once per plan (``entry`` and its shape ``args``), that the card can
    hold one of the launch's clusters (``<entry>_occupancy(*args) > 0``,
    cudaOccupancyMaxActiveClusters); raises otherwise, before anything is
    launched. ``what`` describes the cluster for the message."""
    key = (entry, *args)
    if key not in _occupancy_checked:
        n = getattr(lib, f"{entry}_occupancy")(*args)
        if n <= 0:
            raise RuntimeError(f"{entry}: the card holds no cluster of {what} "
                               f"(cudaOccupancyMaxActiveClusters {n})")
        _occupancy_checked.add(key)


def _check_cluster(lib, entry: str, plan: DropPlan, T_c: int, T_q: int, D: int) -> None:
    """:func:`_check_occupancy` for K2's, K7's or K8's cluster plan."""
    _check_occupancy(lib, entry, (T_c, T_q, D),
                     f"{plan.C} blocks of this plan ({plan.smem_fwd} / {plan.smem_bwd} bytes of "
                     f"shared memory a block for the forward / K8)")


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
    _check_occupancy(lib, "mmb_bidaf_tiled_forward", (T_c, T_q, D, tq_blk),
                     f"{plan.C} blocks of {plan.smem} bytes of shared memory")
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


def bidaf_dropout_forward(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias,
                          with_stats: bool = False):
    """K7 (contract of :func:`bidaf_dropout_reference`) → f32 ``[B, T_c, 4D]``
    on the route :func:`drop_route` names: the cluster kernel, or K9's walk
    with S from ``cd``/``qd`` (``"tiled"``). ``with_stats``: return ``(out,
    stats)``, ``stats`` the tiled route's ``[B, 2, T_c]`` row maxima and
    sums of the row softmax (what K8's tiled route needs), ``None`` on the
    cluster route and on the CPU. ``bidaf_dropout_forward.launches`` counts
    kernel launches, ``.routes`` those of each route."""
    if c.device.type == "cpu":
        out = bidaf_dropout_reference(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
        return (out, None) if with_stats else out
    if c.device.type != "cuda":
        raise ValueError(f"bidaf_dropout_forward: unsupported device {c.device}")
    ops = (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
    B, T_c, T_q, D, dev = _check_drop_operands(*ops)
    route = drop_route(T_c, T_q, D)
    lib = build.library()
    out = torch.empty(B, T_c, 4 * D, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    stats = None
    if route == "cluster":
        _check_cluster(lib, "mmb_bidaf_forward_dropout", drop_plan(T_c, T_q, D), T_c, T_q, D)
        rc = lib.mmb_bidaf_forward_dropout(*(t.data_ptr() for t in ops), out.data_ptr(),
                                           B, T_c, T_q, D, stream)
        build.check_launch(lib, rc, "mmb_bidaf_forward_dropout")
    else:
        plan = tiled_plan(T_c, T_q, D, _DROP_TILE, drop=True)
        _check_occupancy(lib, "mmb_bidaf_tiled_forward_dropout", (T_c, T_q, D),
                         f"{plan.C} blocks of {plan.smem} bytes of shared memory")
        stats = torch.empty(B, 2, T_c, device=dev)
        work = torch.empty(B * plan.C * plan.work, device=dev) if plan.work else None
        rc = lib.mmb_bidaf_tiled_forward_dropout(
            *(t.data_ptr() for t in ops), out.data_ptr(), stats.data_ptr(),
            None if work is None else work.data_ptr(), B, T_c, T_q, D, stream)
        build.check_launch(lib, rc, "mmb_bidaf_tiled_forward_dropout")
    bidaf_dropout_forward.launches += 1
    bidaf_dropout_forward.routes[route] += 1
    return (out, stats) if with_stats else out


bidaf_dropout_forward.launches = 0
bidaf_dropout_forward.routes = {"cluster": 0, "tiled": 0}


@functools.lru_cache(maxsize=64)
def _tiled_bwd_work(T_c: int, T_q: int, D: int) -> int:
    """The workspace floats an example of K8's tiled route, as the C plan
    sizes it (``mmb_bidaf_tiled_bwd_plan``), checked against the mirror."""
    import ctypes

    out, out64 = (ctypes.c_int * 6)(), (ctypes.c_longlong * 1)()
    lib = build.library()
    build.check_launch(lib, lib.mmb_bidaf_tiled_bwd_plan(T_c, T_q, D, out, out64),
                       "mmb_bidaf_tiled_bwd_plan")
    plan = tiled_bwd_plan(T_c, T_q, D)
    if (tuple(out), out64[0]) != (plan[:6], plan.work):
        raise RuntimeError(f"K8's tiled plan differs from its mirror at T_c={T_c}, T_q={T_q}, "
                           f"D={D}: {tuple(out)} {out64[0]} vs {plan}")
    return out64[0]


def bidaf_dropout_backward(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, g, stats=None):
    """K8 (contract of :func:`bidaf_dropout_backward_reference`) → ``(d_c,
    d_q, d_cd, d_qd, dw_c, dw_q, dw_cq, dbias)`` on the route
    :func:`drop_route` names; the tiled route needs the forward's
    ``stats`` (``bidaf_dropout_forward(..., with_stats=True)``).
    ``bidaf_dropout_backward.launches`` counts calls that launched it (two
    kernels a call on the cluster route, five on the tiled), ``.routes``
    those of each route."""
    if c.device.type == "cpu":
        return bidaf_dropout_backward_reference(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq,
                                                bias, g)
    if c.device.type != "cuda":
        raise ValueError(f"bidaf_dropout_backward: unsupported device {c.device}")
    ops = (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
    B, T_c, T_q, D, dev = _check_drop_operands(*ops)
    build.check_tensor(g, "g", (B, T_c, 4 * D), dev)
    route = drop_route(T_c, T_q, D)
    lib = build.library()
    d_c, d_cd = torch.empty_like(c), torch.empty_like(c)
    d_q, d_qd = torch.empty_like(q), torch.empty_like(q)
    rows = B if route == "cluster" else B * tiled_bwd_plan(T_c, T_q, D).finish_blocks
    partial = torch.empty(rows, 3 * D + 1, device=dev)
    d_params = torch.empty(3 * D + 1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "cluster":
        _check_cluster(lib, "mmb_bidaf_backward", drop_plan(T_c, T_q, D), T_c, T_q, D)
        rc = lib.mmb_bidaf_backward(
            *(t.data_ptr() for t in ops), g.data_ptr(), d_c.data_ptr(), d_q.data_ptr(),
            d_cd.data_ptr(), d_qd.data_ptr(), partial.data_ptr(), d_params.data_ptr(),
            B, T_c, T_q, D, stream,
        )
        build.check_launch(lib, rc, "mmb_bidaf_backward")
    else:
        if stats is None:
            raise ValueError("bidaf_dropout_backward: the tiled route needs the forward's row "
                             "statistics (bidaf_dropout_forward(..., with_stats=True))")
        build.check_tensor(stats, "stats", (B, 2, T_c), dev)
        work = torch.empty(B * _tiled_bwd_work(T_c, T_q, D), device=dev)
        rc = lib.mmb_bidaf_tiled_backward(
            *(t.data_ptr() for t in ops), g.data_ptr(), stats.data_ptr(), d_c.data_ptr(),
            d_q.data_ptr(), d_cd.data_ptr(), d_qd.data_ptr(), work.data_ptr(),
            partial.data_ptr(), d_params.data_ptr(), B, T_c, T_q, D, stream,
        )
        build.check_launch(lib, rc, "mmb_bidaf_tiled_backward")
    bidaf_dropout_backward.launches += 1
    bidaf_dropout_backward.routes[route] += 1
    return (d_c, d_q, d_cd, d_qd, d_params[:D], d_params[D:2 * D], d_params[2 * D:3 * D],
            d_params[3 * D])


bidaf_dropout_backward.launches = 0
bidaf_dropout_backward.routes = {"cluster": 0, "tiled": 0}


class BiDAFDropoutFn(torch.autograd.Function):
    """The BiDAF block with similarity-only dropout operands: K7 forward, K8
    backward, on one route (:func:`drop_route`). All inputs f32 and
    contiguous; ``bias`` is a 0-d tensor. The tiled route's row statistics
    are saved for its backward; the cluster route saves none."""

    @staticmethod
    def forward(ctx, c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias):
        ops = (c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias)
        out, stats = bidaf_dropout_forward(*ops, with_stats=True)
        ctx.save_for_backward(*ops, *(() if stats is None else (stats,)))
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        d_c, d_q, d_cd, d_qd, dw_c, dw_q, dw_cq, dbias = bidaf_dropout_backward(
            *saved[:10], g.contiguous(), stats=saved[10] if len(saved) > 10 else None)
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
