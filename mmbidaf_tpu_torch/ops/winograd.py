"""Winograd F(2x2, 3x3) convolution, the port of ``mmbidaf_tpu.ops.winograd``.

Each 2x2 output tile of a 3x3 / stride-1 / SAME conv costs 16 multiplies
instead of 36:

    Y = Aᵀ [ (G g Gᵀ) ⊙ (Bᵀ d B) ] A        per 4x4 input tile d,
                                             summed over C_in inside the ⊙

This is the plain version of K14 (``ops/cuda/winograd_kernel.py``), with
the JAX function's numerics: the input and weight transforms in f32; V and U
rounded to the compute dtype; the 16 transform-point products taken on those
rounded values and summed in f32 (bf16 operands are widened to f32 first, as
``jnp.dot(..., preferred_element_type=f32)`` does, rather than handed to a
bf16 ``matmul`` that rounds its output); the output transform and the bias
in f32; then one cast. The B transform runs along W and then along H, and
the A transform in the same order, each sum associated as in the JAX code.

Layouts are the JAX package's: ``x [N, H, W, C]``, ``w [3, 3, C, K]`` (HWIO).
The transform points are formed one at a time, so no ``[4, 4, ...]`` tile
tensor is ever held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bᵀ rows of F(2x2,3x3) as (index, sign) pairs: (d0 - d2, d1 + d2, d2 - d1, d1 - d3).
_BT = (((0, 1), (2, -1)), ((1, 1), (2, 1)), ((2, 1), (1, -1)), ((1, 1), (3, -1)))


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """``[3, 3, C, K]`` → ``U [4, 4, C, K]`` = G g Gᵀ in f32 (G rows: g0,
    (g0+g1+g2)/2, (g0-g1+g2)/2, g2, along both kernel axes; the first index
    is the H point)."""
    w = w.float()
    rows = [w[0], (w[0] + w[1] + w[2]) * 0.5, (w[0] - w[1] + w[2]) * 0.5, w[2]]
    return torch.stack([torch.stack([r[0], (r[0] + r[1] + r[2]) * 0.5,
                                     (r[0] - r[1] + r[2]) * 0.5, r[2]]) for r in rows])


def _combo(terms, pick):
    """``pick(i0) ± pick(i1)`` for one Bᵀ row ``terms``."""
    (i0, _), (i1, s1) = terms
    return pick(i0) + pick(i1) if s1 > 0 else pick(i0) - pick(i1)


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 / stride-1 / SAME conv via Winograd F(2x2, 3x3):
    ``x [N, H, W, C]``, ``w [3, 3, C, K]`` → ``[N, H, W, K]`` in ``x``'s dtype."""
    N, H, W, C = x.shape
    K = w.shape[-1]
    dtype = x.dtype
    U = transform_weights(w).to(dtype).float()
    nh, nw = -(-H // 2), -(-W // 2)
    # SAME halo (1 px) and H/W padded to even for whole 2x2 output tiles.
    xp = F.pad(x.float(), (0, 0, 1, 1 + W % 2, 1, 1 + H % 2))

    def d(i, j):  # element (i, j) of every 4x4 stride-2 tile: a strided view
        return xp[:, i:i + 2 * nh:2, j:j + 2 * nw:2, :]

    # M[p][q] = V[p][q] · U[p][q] over C; P[p] = A applied along W (the q
    # axis), then A along H, each sum associated as in the JAX code.
    P = []
    for p in range(4):
        M = [_combo(_BT[p], lambda i: _combo(_BT[q], lambda j: d(i, j))).to(dtype).float()
             .reshape(-1, C) @ U[p, q] for q in range(4)]
        P.append(((M[0] + M[1]) + M[2], (M[1] - M[2]) - M[3]))
    Y = [[(P[0][y1] + P[1][y1]) + P[2][y1] for y1 in (0, 1)],
         [(P[1][y1] - P[2][y1]) - P[3][y1] for y1 in (0, 1)]]
    out = torch.stack([torch.stack(Y[0], dim=-2), torch.stack(Y[1], dim=-2)], dim=-3)
    out = out.reshape(N, nh, nw, 2, 2, K).permute(0, 1, 3, 2, 4, 5).reshape(N, 2 * nh, 2 * nw, K)
    out = out[:, :H, :W, :]
    if b is not None:
        out = out + b.float()
    return out.to(dtype)
