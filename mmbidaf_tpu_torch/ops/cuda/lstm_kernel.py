"""K1, K5 and K6: the BiLSTM recurrence kernels (``csrc/lstm.cu``,
``csrc/lstm_bwd.cu``) and their plain versions.

K1 is the port of ``mmbidaf_tpu/ops/pallas/lstm_kernel.py::bilstm_pallas``.
As on the TPU, the input projection ``x @ W_x + b`` is one GEMM outside the
kernel (here for both directions at once), rounded in the operands' dtype
and then cast to f32; the kernel runs the recurrence of both directions in
f32 and writes the ``[B, T, 2h]`` output and the carried ``h``/``c``
directly. It has two routes, picked by :func:`serving_route` before any
launch: ``cluster``, K5's cluster body without the residual writes and
with its product's shared-memory loads issued 8 k ahead of their FMAs (the
same sums, so K1 and K5 give the same bits at equal gates), wherever
:func:`cluster_plan` has a plan; and ``l2``, one block a
row group reading ``W_h`` from L2 every step, for the widths with none (H
past 448, 432 or 384 at 4, 8 or 16 rows a cluster). ``bilstm_cuda.routes``
counts the launches of each.

K5 and K6 are the training pair, the port of ``bilstm_pallas_trainable``,
on K1's two routes, picked by :func:`train_route` (K1's rule) before any
launch and counted in ``.routes``: ``cluster``, thread-block clusters that
keep ``W_h`` in shared memory (``csrc/lstm_cluster.cuh``; :func:`cluster_plan`
mirrors its host-side plan), and ``l2``, one block a group of
:func:`l2_rows` rows reading ``W_h`` from L2 every step, for the widths with
no cluster plan (the JAX kernel trains to H = 699 through its kernel and
past that through a scan; the port has a route for every H to 9,685, past
which it raises before any launch). K5 is K1's recurrence that also
writes the carried ``h_seq``/``c_seq`` ``[2, T, rows, h]`` (per direction,
in processing order) as the BPTT residuals. K6 runs in three phases:
(a) the gate pre-activations ``z`` of every step at once, one product over
the residuals written into the ``dgates`` buffer, which has the gates'
layout and doubles as z's scratch; (b) the walk backwards from the saved
f32 gates and residuals, seeded with the cotangents of ``(h_last,
c_last)``, which overwrites each step's ``z`` with its ``dz`` and carries
``dh`` through the cluster's shared memory (on the ``l2`` route, through
the block's, with ``dz·W_hᵀ`` read from L2 every step); (c) ``dW_h``,
summed over rows and steps by a product over the residuals with partials
summed in a fixed order. (a) and (c) need no cluster plan and are the same
on every route. K6's walk has a third route, ``grid``, picked by
:func:`bptt_route`: at few rows past the cluster plan (at most 64, as in
the hidden-512 model's 32-row towers) the L2 walk would hold 16 of the
card's 132 SMs, so the grid walk spreads ``W_h`` over the whole card
instead, each SM keeping the gate columns of its slice of units in
registers (:func:`grid_plan`), and sums each step's ``dz·W_hᵀ`` over a
cluster's shared memory, then over the clusters through device memory in
words that carry the step's number. No phase uses atomics.
:class:`BiLSTMTrainableFn` ties them into one ``torch.autograd.Function``
per layer; ``dx``, ``dW_x`` and ``db`` come from autograd through the
projection, the plain GEMMs they are on the TPU too. The TPU recomputes
the gates in its backward; the Function keeps the f32 gates it was given.

Each wrapper (``bilstm_cuda`` K1, ``bilstm_train_forward`` K5,
``bilstm_bptt`` K6) runs its plain version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises; ``<wrapper>.launches`` counts launches.
K1's recurrence is the custom op ``torch.ops.mmbidaf.bilstm`` (CPU: the
plain version; CUDA: the launch, which alone moves the counters; fake: the
outputs' shapes), so ``torch.export`` keeps it as one node and a loaded
program launches the same kernel.

Tolerances of kernel vs plain on the card (``TOLERANCE``, ``BPTT_TOLERANCE``):
the kernels sum their products in their own order (K6's walk sums
``dz @ W_h^T`` per block over its gate columns, then over the cluster's
partials in rank order, on the grid walk then over the clusters in order)
and use CUDA's ``expf``/``tanhf``, so outputs differ by f32 rounding that
the recurrence carries forward. K1/K5 outputs
are below 1 in magnitude (``|h|, |c|`` stay small by construction); the
largest error measured at the five bench-shape towers (up to 512 steps) on
an H100 was 2.4e-7 (K1) and 3.6e-7 (K5, before and on a cluster), so
``atol = 1e-5`` leaves a 30x margin and still catches a wrong gate, step or
mask. K6's ``dgates`` carry the same rounding back through up to 512 steps,
and ``dW_h`` sums ~16k products per entry in another order than the plain
version's per-step matmuls, so K6 is held normwise: each output within
``atol + rtol·max|ref|`` of that output. With unit-normal cotangents at the
bench_train shapes (B=32) the largest errors measured on an H100 were
5.4e-7 on dgates up to 3.4 and 1.3e-5 on dW_h up to 13 (1.0e-6 of its
scale); on a cluster, 4.8e-7 on dgates up to 4.9 and 1.3e-5 on dW_h up to
13. So ``BPTT_TOLERANCE`` (``atol = 1e-5, rtol = 5e-6``, normwise) leaves
a 5x margin on dW_h and 50x on dgates. On the L2 routes (``chip_smoke.py``
16a: H 400–1024, 32–2048 rows, up to 512 steps) the largest errors measured
on an H100 were 1.5e-7 (K5) and 1.2e-5 on dW_h up to 10 (K6), within the
same bounds; on the grid walk (H 452–512, 4–64 rows, up to 512 steps)
1.1e-5 on dW_h up to 12 and 5.4e-7 on dgates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mmbidaf_tpu_torch.ops.common import mm
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.lstm import lstm_cell

TOLERANCE = {"atol": 1e-5, "rtol": 0.0}
# K6 vs its plain version on the card, per output: |err| <= atol + rtol·max|ref|.
BPTT_TOLERANCE = {"atol": 1e-5, "rtol": 5e-6}


# Hopper's opt-in shared memory of a block (bytes), the cluster plan's limit.
SMEM_LIMIT = 232448
_MAX_CLUSTER = 16
_TARGET_UNITS = 16


class ClusterPlan(NamedTuple):
    """How K1, K5 and K6 lay ``rows`` rows of width ``H`` over clusters: ``C``
    blocks a cluster, ``R`` rows a cluster, block ``c`` owning the units
    ``slices[c] = (begin, end)`` (``U`` the largest slice), ``clusters`` a
    direction, ``blocks`` in all, and each kernel's dynamic shared memory a
    block in bytes."""
    C: int
    R: int
    U: int
    slices: tuple
    clusters: int
    blocks: int
    smem_fwd: int
    smem_bwd: int


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _smem(H: int, C: int, R: int) -> tuple[int, int]:
    """K5's and K6's dynamic shared memory a block (``lstm_cluster.cuh``)."""
    U = -(-H // C)
    G4 = 4 * U
    w = _round4(H * (G4 + 1))
    fwd = _round4(2 * H * R) + w + _round4(R * G4) + _round4(2 * R * G4) + _round4(R * U) + _round4(2 * R)
    bwd = (_round4(G4 * R) + w + _round4(2 * C * U * R) + 2 * _round4(R * U) + _round4(2 * R * G4)
           + 2 * _round4(2 * R * U) + _round4(2 * R))
    return 4 * fwd, 4 * bwd


def cluster_plan(rows: int, H: int) -> ClusterPlan:
    """The cluster plan of K1, K5 and K6 (``lstm_cluster.cuh::plan``): ``R`` = 16
    rows a cluster from 512 rows, 8 from 128, else 4; ``C`` the smallest
    power of two giving at most 16 units a block, raised until both kernels'
    shared memory fits a block. Raises ``ValueError`` where no cluster of at
    most 16 blocks holds ``W_h``'s slice."""
    if rows <= 0 or H <= 0:
        raise ValueError(f"no LSTM cluster plan for rows={rows}, H={H}")
    R = 16 if rows >= 512 else 8 if rows >= 128 else 4
    C = 1
    while C < _MAX_CLUSTER and -(-H // C) > _TARGET_UNITS:
        C *= 2
    while C <= _MAX_CLUSTER and max(_smem(H, C, R)) > SMEM_LIMIT:
        C *= 2
    if C > _MAX_CLUSTER or C > H:
        raise ValueError(f"no LSTM cluster plan for H={H}: W_h's slice over {_MAX_CLUSTER} blocks "
                         f"needs more than {SMEM_LIMIT} bytes of shared memory a block")
    slices = tuple((c * H // C, (c + 1) * H // C) for c in range(C))
    clusters = -(-rows // R)
    return ClusterPlan(C, R, -(-H // C), slices, clusters, 2 * clusters * C, *_smem(H, C, R))


def l2_smem(H: int, R: int) -> int:
    """Shared memory a block of the L2 routes asks for (``lstm_cluster.cuh::
    l2_smem``): ``R`` rows of ``[h | c | z]`` (K1, K5) or ``[dh | dc | dz]``
    (K6's walk), 6H floats a row."""
    return 4 * R * 6 * H


def l2_rows(rows: int, H: int) -> int:
    """The L2 routes' rows a block (``lstm_cluster.cuh::l2_rows``): 16 from
    1024 rows, else 4, halved while :func:`l2_smem` exceeds a block's shared
    memory; 0 where not even one row fits (H past 9,685) or the shape is
    empty."""
    if rows <= 0 or H <= 0:
        return 0
    R = 16 if rows >= 1024 else 4
    while R >= 1 and l2_smem(H, R) > SMEM_LIMIT:
        R //= 2
    return max(R, 0)


GRID_BLOCKS, GRID_CLUSTER, GRID_MAX_ROWS, GRID_ROW_GROUP, GRID_PAIRS = 64, 8, 64, 8, 2


class GridPlan(NamedTuple):
    """How K6's grid walk lays ``rows`` rows of width ``H`` over the card
    (``lstm_cluster.cuh::grid_plan``): ``P`` blocks a direction in ``NQ``
    clusters of ``CS``, block ``b`` owning the units ``slices[b]`` for every
    row (``U`` the largest slice, ``UT`` the kernel instance's units), rank
    ``c`` of a cluster summing the outputs ``chunks[c]`` of the cluster's
    partials (``KC`` the largest), rows padded to ``Rp``, ``threads`` a block
    (two rows of ``W_h`` and up to two (unit, row) pairs of the gate math
    each), its dynamic shared memory ``smem`` in bytes
    (over half an SM's, so one block an SM) and ``work``, the exchange's
    4-byte words of device memory."""
    P: int
    CS: int
    NQ: int
    U: int
    UT: int
    Rp: int
    KC: int
    threads: int
    smem: int
    work: int
    slices: tuple
    chunks: tuple


def grid_plan(rows: int, H: int, P: int = GRID_BLOCKS) -> GridPlan:
    """K6's grid walk plan at ``P`` blocks a direction (``lstm_cluster.cuh::
    grid_plan``; the shape rule's ``P`` is 64, a card that cannot hold
    them all runs fewer). Raises ``ValueError`` past ``GRID_MAX_ROWS`` rows,
    where a block's slice needs more than 12 units (H past 768 at 64 blocks)
    or where the block does not fit."""
    CS = GRID_CLUSTER
    if not (0 < rows <= GRID_MAX_ROWS and H > 0 and 0 < P <= H and P % CS == 0):
        raise ValueError(f"no K6 grid plan for rows={rows}, H={H}")
    U = -(-H // P)
    UT = next((ut for ut in (8, 10, 12) if U <= ut), 0)
    Rp = -(-rows // GRID_ROW_GROUP) * GRID_ROW_GROUP
    KC = -(-H // CS)
    threads = 32 * max(-(-H // 64), -(-UT * Rp // (32 * GRID_PAIRS)))
    smem = 4 * Rp * (3 * 4 * UT + CS * KC + 6 * UT + 2)
    if UT == 0 or threads > 32 * UT or smem > SMEM_LIMIT:
        raise ValueError(f"no K6 grid plan for rows={rows}, H={H}: {U} units a block, "
                         f"{smem} bytes of shared memory")
    NQ = P // CS
    return GridPlan(P, CS, NQ, U, UT, Rp, KC, threads, max(smem, SMEM_LIMIT // 2 + 16),
                    8 * NQ * H * Rp,
                    tuple((b * H // P, (b + 1) * H // P) for b in range(P)),
                    tuple((c * H // CS, (c + 1) * H // CS) for c in range(CS)))


def bptt_route(rows: int, H: int) -> str:
    """K6's walk (``lstm_cluster.cuh::bptt_route``): ``"cluster"`` where
    :func:`cluster_plan` has a plan; ``"grid"`` where :func:`grid_plan` has
    one (no cluster plan, at most 64 rows, so that the L2 walk would hold at
    most 32 of the card's SMs); else ``"l2"``. Raises ``ValueError`` where no
    route takes the shape. On a card that cannot hold the grid walk's blocks
    at once the launch takes ``"l2"`` instead (``mmb_lstm_bptt_route``)."""
    route = serving_route(rows, H)
    if route == "l2":
        try:
            grid_plan(rows, H)
        except ValueError:
            return "l2"
        return "grid"
    return route


def serving_route(rows: int, H: int) -> str:
    """K1's route for ``rows`` rows of width ``H`` (``mmb_bilstm_forward``'s
    rule): ``"cluster"`` where :func:`cluster_plan` has a plan, else
    ``"l2"``. Raises ``ValueError`` where neither route takes the shape."""
    try:
        cluster_plan(rows, H)
    except ValueError:
        if l2_rows(rows, H) == 0:
            raise ValueError(f"no BiLSTM route for rows={rows}, H={H}: the L2 route's block of one "
                             f"row needs {l2_smem(H, 1)} bytes of shared memory, more than "
                             f"{SMEM_LIMIT}") from None
        return "l2"
    return "cluster"


def train_route(rows: int, H: int) -> str:
    """K5's route (``mmb_bilstm_forward_train``'s rule, K1's): ``"cluster"``
    where :func:`cluster_plan` has a plan, else ``"l2"``; raises where
    neither takes the shape. K6's walk follows :func:`bptt_route`."""
    return serving_route(rows, H)


_occupancy_checked: set = set()


def _check_route(lib, entry: str, rows: int, H: int, route: str | None = None) -> str:
    """This shape's route (``route``, else :func:`serving_route`'s) and, once
    per plan, that the card can hold one of its clusters
    (``cudaOccupancyMaxActiveClusters > 0``) or, on the L2 route, one of its
    blocks an SM; raises otherwise, before anything is launched. K6's grid
    walk checks the card itself (``mmb_bilstm_backward``)."""
    route = route or serving_route(rows, H)
    if route == "grid":
        return route
    if route == "cluster":
        plan = cluster_plan(rows, H)
        key = (entry, H, plan.R)  # the plan's only inputs
        if key not in _occupancy_checked:
            n = getattr(lib, f"{entry}_occupancy")(rows, H)
            if n <= 0:
                raise RuntimeError(f"{entry}: the card holds no cluster of {plan.C} blocks of this "
                                   f"plan ({plan.smem_fwd} / {plan.smem_bwd} bytes of shared memory "
                                   f"a block for K1 and K5 / K6; cudaOccupancyMaxActiveClusters {n})")
            _occupancy_checked.add(key)
        return route
    R = l2_rows(rows, H)
    key = (entry, "l2", H, R)
    if key not in _occupancy_checked:
        n = getattr(lib, f"{entry}_l2_occupancy")(rows, H)
        if n <= 0:
            raise RuntimeError(f"{entry}: an SM holds no block of the L2 route at H={H}, R={R} "
                               f"({l2_smem(H, R)} bytes of shared memory a block; "
                               f"cudaOccupancyMaxActiveBlocksPerMultiprocessor {n})")
        _occupancy_checked.add(key)
    return route


def _projection(params, x: torch.Tensor) -> torch.Tensor:
    """Both directions' ``x @ W_x + b`` → f32 ``[B, T, 8h]`` (fwd | bwd),
    computed in the operands' promoted dtype first, as
    ``(x @ w_x + b).astype(f32)`` is in ``lstm_pallas``."""
    w_x = torch.cat([params.fwd.w_x, params.bwd.w_x], dim=1)
    b = torch.cat([params.fwd.b, params.bwd.b])
    return (mm(x, w_x) + b).float()


def bilstm_train_forward_reference(gates: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor):
    """Plain version of the recurrence of both directions (K1's, and K5's
    with the residuals): f32 ``gates [B, T, 8H]`` (fwd | bwd), ``mask
    [B, T]``, ``w_h [2, H, 4H]`` → ``(out [B, T, 2H], h_last, c_last [B, 2H],
    h_seq, c_seq [2, T, B, H])``; ``h_seq[d, t]`` is the carried state after
    processing step ``t`` (position ``T-1-t`` in the reverse direction)."""
    B, T, _ = gates.shape
    H = w_h.shape[1]
    out = gates.new_zeros(B, T, 2 * H)
    h_seq = gates.new_zeros(2, T, B, H)
    c_seq = gates.new_zeros(2, T, B, H)
    for d in (0, 1):
        h = gates.new_zeros(B, H)
        c = torch.zeros_like(h)
        g_d = gates[..., d * 4 * H:(d + 1) * 4 * H]
        for t in range(T):
            tt = T - 1 - t if d else t
            h_new, c_new = lstm_cell(g_d[:, tt], h, c, w_h[d])
            m = mask[:, tt, None]
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            out[:, tt, d * H:(d + 1) * H] = h_new * m
            h_seq[d, t], c_seq[d, t] = h, c
    return out, h_seq[:, -1].transpose(0, 1).reshape(B, 2 * H), \
        c_seq[:, -1].transpose(0, 1).reshape(B, 2 * H), h_seq, c_seq


def bilstm_reference(params, x: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch version of K1's path: ``(out [B, T, 2h],
    (h_last, c_last) [B, 2h])`` in f32."""
    w_h = torch.stack([params.fwd.w_h, params.bwd.w_h]).float()
    out, h_last, c_last, _, _ = bilstm_train_forward_reference(_projection(params, x), mask.float(), w_h)
    return out, (h_last, c_last)


def bilstm_cuda(params, x: torch.Tensor, mask: torch.Tensor):
    """One BiLSTM layer through the hand kernel (``bilstm_pallas``'s
    contract), on the route :func:`serving_route` picks: the input
    projection here, the recurrence through the custom op
    ``torch.ops.mmbidaf.bilstm`` (one node in an exported program).
    ``bilstm_cuda.launches`` counts kernel launches, ``bilstm_cuda.routes``
    those of each route; both move only where the kernel launches."""
    build.check_device(x, "bilstm_cuda")
    gates = _projection(params, x).contiguous()
    w_h = torch.stack([params.fwd.w_h, params.bwd.w_h]).float().contiguous()
    out, h_last, c_last = torch.ops.mmbidaf.bilstm(gates, mask.float().contiguous(), w_h)
    return out, (h_last, c_last)


bilstm_cuda.launches = 0
bilstm_cuda.routes = {"cluster": 0, "l2": 0}


@torch.library.custom_op("mmbidaf::bilstm", mutates_args=(), device_types="cpu")
def bilstm_op(gates: torch.Tensor, mask: torch.Tensor,
              w_h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's recurrence as a custom op: f32 ``gates [B, T, 8H]``, ``mask
    [B, T]``, ``w_h [2, H, 4H]`` → ``(out [B, T, 2H], h_last, c_last
    [B, 2H])``. On the CPU, the plain version."""
    out, h_last, c_last, _, _ = bilstm_train_forward_reference(gates, mask, w_h)
    return out, h_last.contiguous(), c_last.contiguous()


@bilstm_op.register_kernel("cuda")
def _bilstm_launch(gates: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor):
    B, T, _ = gates.shape
    H = w_h.shape[1]
    dev = gates.device
    build.check_tensor(gates, "gates", (B, T, 8 * H), dev)
    build.check_tensor(mask, "mask", (B, T), dev)
    build.check_tensor(w_h, "w_h", (2, H, 4 * H), dev)
    out = torch.empty(B, T, 2 * H, device=dev)
    h_last = torch.empty(B, 2 * H, device=dev)
    c_last = torch.empty(B, 2 * H, device=dev)
    lib = build.library()
    route = _check_route(lib, "mmb_bilstm_forward", B, H)
    rc = lib.mmb_bilstm_forward(
        gates.data_ptr(), mask.data_ptr(), w_h.data_ptr(), out.data_ptr(),
        h_last.data_ptr(), c_last.data_ptr(), B, T, H,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bilstm_forward")
    bilstm_cuda.launches += 1
    bilstm_cuda.routes[route] += 1
    return out, h_last, c_last


@bilstm_op.register_fake
def _bilstm_fake(gates: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor):
    B, T, _ = gates.shape
    H = w_h.shape[1]
    f32 = torch.float32
    return gates.new_empty(B, T, 2 * H, dtype=f32), gates.new_empty(B, 2 * H, dtype=f32), \
        gates.new_empty(B, 2 * H, dtype=f32)


# ---------------------------------------------------------------------------
# K5 / K6: the training pair.
# ---------------------------------------------------------------------------


def bilstm_bptt_reference(gates, mask, w_h, h_seq, c_seq, dout, dh_last, dc_last):
    """Plain version of K6, step for step the TPU kernel's
    (``_lstm_bwd_kernel``): → ``(dgates [B, T, 8H], dw_h [2, H, 4H])``."""
    B, T, _ = gates.shape
    H = w_h.shape[1]
    dgates = torch.zeros_like(gates)
    dw_h = torch.zeros_like(w_h)
    for d in (0, 1):
        sl = slice(d * H, (d + 1) * H)
        dh, dc = dh_last[:, sl], dc_last[:, sl]
        for s in range(T - 1, -1, -1):
            tt = T - 1 - s if d else s
            h_prev = h_seq[d, s - 1] if s > 0 else gates.new_zeros(B, H)
            c_prev = c_seq[d, s - 1] if s > 0 else gates.new_zeros(B, H)
            z = gates[:, tt, d * 4 * H:(d + 1) * 4 * H] + h_prev @ w_h[d]
            i, f, g, o = z.chunk(4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            tanh_c = torch.tanh(f * c_prev + i * g)
            m = mask[:, tt, None]
            dh_new = m * (dout[:, tt, sl] + dh)
            dc_new = dh_new * o * (1.0 - tanh_c * tanh_c) + m * dc
            dz = torch.cat([dc_new * g * i * (1.0 - i), dc_new * c_prev * f * (1.0 - f),
                            dc_new * i * (1.0 - g * g), dh_new * tanh_c * o * (1.0 - o)], dim=-1)
            dgates[:, tt, d * 4 * H:(d + 1) * 4 * H] = dz
            dh = (1.0 - m) * dh + dz @ w_h[d].T
            dc = f * dc_new + (1.0 - m) * dc
            dw_h[d] += h_prev.T @ dz
    return dgates, dw_h


def _check_train_operands(gates, mask, w_h):
    B, T, _ = gates.shape
    H = w_h.shape[1]
    dev = gates.device
    build.check_tensor(gates, "gates", (B, T, 4 * H * 2), dev)
    build.check_tensor(mask, "mask", (B, T), dev)
    build.check_tensor(w_h, "w_h", (2, H, 4 * H), dev)
    return B, T, H, dev


def bilstm_train_forward(gates: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor):
    """K5: the training recurrence (contract of
    :func:`bilstm_train_forward_reference`) on the route :func:`train_route`
    picks. ``bilstm_train_forward.launches`` counts kernel launches,
    ``bilstm_train_forward.routes`` those of each route."""
    if gates.device.type == "cpu":
        return bilstm_train_forward_reference(gates, mask, w_h)
    if gates.device.type != "cuda":
        raise ValueError(f"bilstm_train_forward: unsupported device {gates.device}")
    B, T, H, dev = _check_train_operands(gates, mask, w_h)
    lib = build.library()
    route = _check_route(lib, "mmb_bilstm_forward_train", B, H)
    out = torch.empty(B, T, 2 * H, device=dev)
    h_last = torch.empty(B, 2 * H, device=dev)
    c_last = torch.empty(B, 2 * H, device=dev)
    h_seq = torch.empty(2, T, B, H, device=dev)
    c_seq = torch.empty(2, T, B, H, device=dev)
    rc = lib.mmb_bilstm_forward_train(
        gates.data_ptr(), mask.data_ptr(), w_h.data_ptr(), out.data_ptr(), h_last.data_ptr(),
        c_last.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(), B, T, H,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bilstm_forward_train")
    bilstm_train_forward.launches += 1
    bilstm_train_forward.routes[route] += 1
    return out, h_last, c_last, h_seq, c_seq


bilstm_train_forward.launches = 0
bilstm_train_forward.routes = {"cluster": 0, "l2": 0}


_BPTT_ROUTES = ("none", "cluster", "grid", "l2")  # lstm_cluster.cuh::BpttRoute


def bilstm_bptt(gates, mask, w_h, h_seq, c_seq, dout, dh_last, dc_last, route: str | None = None):
    """K6: backward through time (contract of :func:`bilstm_bptt_reference`)
    in three phases: (a) ``z = gates + h_seq[s-1]·W_h`` for every step
    ``s >= 1`` at once, written into ``dgates``, which has the gates' layout
    and doubles as its scratch; (b) the walk, which overwrites each step's
    ``z`` with its ``dz``, on the route :func:`bptt_route` names (a cluster;
    the whole card, ``W_h`` resident in its registers; or a block a row group
    by L2), or the L2 walk where the card cannot hold the grid walk's blocks
    at once; ``route`` names another route that takes the shape, to time or
    test one against another; (c) ``dW_h`` over the residuals, in per-slice
    partials (``partial``, which the grid walk borrows for its exchange
    first) summed in a fixed order. ``bilstm_bptt.launches`` counts calls
    that launched the three phases, ``bilstm_bptt.routes`` those of each
    route."""
    if gates.device.type == "cpu":
        return bilstm_bptt_reference(gates, mask, w_h, h_seq, c_seq, dout, dh_last, dc_last)
    if gates.device.type != "cuda":
        raise ValueError(f"bilstm_bptt: unsupported device {gates.device}")
    B, T, H, dev = _check_train_operands(gates, mask, w_h)
    for name, t, shape in (("h_seq", h_seq, (2, T, B, H)), ("c_seq", c_seq, (2, T, B, H)),
                           ("dout", dout, (B, T, 2 * H)), ("dh_last", dh_last, (B, 2 * H)),
                           ("dc_last", dc_last, (B, 2 * H))):
        build.check_tensor(t, name, shape, dev)
    lib = build.library()
    if route is None:
        bptt_route(B, H)  # raises where no route takes the shape
        route = _BPTT_ROUTES[lib.mmb_lstm_bptt_route(B, H, 1)]
    route = _check_route(lib, "mmb_bilstm_backward", B, H, route)
    num_splits = max(1, -(-((T - 1) * B) // lib.mmb_lstm_dwh_split(B, T)))
    dgates = torch.empty_like(gates)
    words = num_splits * 2 * H * 4 * H
    if route == "grid":  # the walk's exchange borrows the partials' buffer first
        words = max(words, grid_plan(B, H).work)
    partial = torch.empty(words, device=dev)
    dw_h = torch.empty(2, H, 4 * H, device=dev)
    rc = lib.mmb_bilstm_backward(
        gates.data_ptr(), mask.data_ptr(), w_h.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
        dout.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(), dgates.data_ptr(),
        partial.data_ptr(), dw_h.data_ptr(), num_splits, B, T, H, _BPTT_ROUTES.index(route),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bilstm_backward")
    bilstm_bptt.launches += 1
    bilstm_bptt.routes[route] += 1
    return dgates, dw_h


bilstm_bptt.launches = 0
bilstm_bptt.routes = {"cluster": 0, "grid": 0, "l2": 0}


class BiLSTMTrainableFn(torch.autograd.Function):
    """One BiLSTM layer's recurrence with its BPTT backward: K5 forward on the
    route :func:`train_route` names, K6 backward on the one
    :func:`bptt_route` names (the forward's, but the grid walk for a few
    rows past the cluster plan). Inputs f32 ``gates [B, T, 8H]``, ``mask [B, T]``,
    ``w_h [2, H, 4H]``; outputs ``(out [B, T, 2H], h_last, c_last [B, 2H])``."""

    @staticmethod
    def forward(ctx, gates, mask, w_h):
        out, h_last, c_last, h_seq, c_seq = bilstm_train_forward(gates, mask, w_h)
        ctx.save_for_backward(gates, mask, w_h, h_seq, c_seq)
        return out, h_last, c_last

    @staticmethod
    def backward(ctx, dout, dh_last, dc_last):
        gates, mask, w_h, h_seq, c_seq = ctx.saved_tensors
        dgates, dw_h = bilstm_bptt(gates, mask, w_h, h_seq, c_seq, dout.contiguous(),
                                   dh_last.contiguous(), dc_last.contiguous())
        return dgates, None, dw_h


def bilstm_cuda_trainable(params, x: torch.Tensor, mask: torch.Tensor):
    """One BiLSTM layer for training (``bilstm_pallas_trainable``'s contract):
    the input projection by autograd-tracked GEMM, the recurrence and its
    backward through K5 / K6 → ``(out [B, T, 2h], (h_last, c_last))`` in f32."""
    gates = _projection(params, x).contiguous()
    w_h = torch.stack([params.fwd.w_h, params.bwd.w_h]).float().contiguous()
    out, h_last, c_last = BiLSTMTrainableFn.apply(gates, mask.float().contiguous(), w_h)
    return out, (h_last, c_last)
