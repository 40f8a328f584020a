"""The numbers that decide ``correct``: the timed path's outputs against the
plain reference (``port_bench/reference``), each held to its limit
(``port_bench/limits/<cell>.json``).

Serving — a sample of the batches the window served, drawn from the seed,
one for each batch of the pool; the reference runs each raw batch with the
served picks fed back (so its decoder walks the served path):

- ``pick_gap``: the widest gap by which a served pick's log-probability,
  in the reference, lies below the reference's best at that step;
- ``logp_err``: the largest distance between a served log-probability and
  the reference's, over the sentences still open at each step.

Training — the first ``check_steps`` steps of the state the window trains,
against the reference trained from the same weights, batches and dropout
draws, its loss and gradient computed in float64 (``reference.Prec("f64")``).
Norms are taken by leaf and compared as the gap between the two norms, over
the reference's norm of that leaf or of the median leaf, whichever is
larger; the median leaf's gap counts. (At initialisation the gradient is a
sum that nearly cancels, a global norm near 0.01, so on some seeds any
float32 computation of it, a plain float32 reference as much as the
program, lies up to ~1e-5 of the median leaf's norm from the float64 one,
and a few leaves' — the LSTM biases, the BiDAF ``w_q`` — up to ~1e-3.)

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer got it (worked out from
  the program's Adadelta state after one step: ``E[g²] = (1-ρ)·g²``);
- ``change_gap``: each parameter's change after the last checked step, and
  its EMA shadow's. Leaves whose reference gradient is under a thousandth
  of the median leaf's (the BiDAF biases, which a softmax cancels) move by
  round-off alone and are left out.
"""

from __future__ import annotations

import math
import statistics

import torch

ADADELTA_RHO = 0.9


def serve_numbers(served_logp: torch.Tensor, served_picks: torch.Tensor, ref_logp: torch.Tensor,
                  sent_mask: torch.Tensor, mask_selected: bool, fed: torch.Tensor | None = None) -> dict:
    """Both serving numbers of one batch (tensors ``[B, K, T_s]`` / ``[B, K]``).
    ``fed``: the picks both decoders were fed, where they are not the served
    ones (a control's argmax on the program's path)."""
    B, K, T_s = ref_logp.shape
    picks = served_picks.long().to(ref_logp.device)
    fed = picks if fed is None else fed.long().to(ref_logp.device)
    served_logp = served_logp.float().to(ref_logp.device)
    best = ref_logp.max(dim=-1).values
    at_pick = ref_logp.gather(-1, picks[..., None])[..., 0]
    opened = sent_mask.float().to(ref_logp.device)[:, None, :].repeat(1, K, 1)
    if mask_selected:
        for k in range(1, K):
            opened[:, k:] = opened[:, k:].scatter(-1, fed[:, k - 1, None, None].expand(B, K - k, 1), 0.0)
    err = ((served_logp - ref_logp).abs() * opened).amax()
    return {"pick_gap": float((best - at_pick).amax()), "logp_err": float(err)}


def worst(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, -math.inf), v) for k, v in b.items()}


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's ``|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = statistics.median(norms.values())
    return {n: abs(float(torch.linalg.vector_norm(prog[n].double())) - norms[n]) / max(norms[n], med)
            for n in names}


def adadelta_grads(opt_state: dict, names: list, shapes: dict) -> dict:
    """The first gradient by leaf, from the Adadelta state after one step
    (one flat vector of the trainable leaves in order, or one a leaf)."""
    e_g = opt_state["e_g"]
    parts = (torch.split(e_g[0], [math.prod(shapes[n]) for n in names]) if len(e_g) == 1 else e_g)
    return {n: torch.sqrt(p.clamp_min(0) / (1 - ADADELTA_RHO)).reshape(shapes[n])
            for n, p in zip(names, parts)}


def train_numbers(prog: dict, ref: dict, w0: dict, leaves: dict | None = None) -> dict:
    """``prog`` / ``ref``: ``losses``, ``grads`` (first, by leaf), ``params``
    and ``ema`` after the last checked step; ``w0`` the weights both began
    from. ``leaves``, where given, receives each number's gaps by leaf."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grads"])
    grads = leaf_gaps(prog["grads"], ref["grads"], names)
    g_norm = {n: float(torch.linalg.vector_norm(ref["grads"][n].double())) for n in names}
    med = statistics.median(g_norm.values())
    moved = [n for n in names if g_norm[n] >= 1e-3 * med]
    change = {}
    for side, out in (("prog", {}), ("ref", {})):
        src = prog if side == "prog" else ref
        for n in moved:
            out[n] = src["params"][n] - w0[n]
            out[f"ema.{n}"] = src["ema"][n] - w0[n]
        change[side] = out
    changes = leaf_gaps(change["prog"], change["ref"], list(change["ref"]))
    if leaves is not None:
        leaves.update(grad_gap=grads, change_gap=changes)
    return {"loss_gap": loss_gap, "grad_gap": statistics.median(grads.values()),
            "change_gap": statistics.median(changes.values())}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{number: {"value", "limit"}}``; a number that is not
    finite, or that has no limit, fails."""
    ok = set(numbers) == set(limits)
    out = {}
    for k in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(k, math.nan), limits.get(k, math.nan)
        ok = ok and math.isfinite(v) and v <= lim
        out[k] = {"value": v, "limit": lim}
    return ok, out
