"""The long-audio serving cell's yardsticks, beside the frozen ``counts.py``:
K9's least time a batch, and the device time of one kernel's launches inside
the program's spans.

K9 (``csrc/bidaf_tiled.cu``'s ``bidaf_tiled_cluster_kernel``, which K2's
wrapper hands a block past its cluster plan) computes the audio tower's
whole BiDAF block: ``counts.bidaf_flops(T_c, T_q, 2h)`` a video, with c, q
and the ``[T_c, 4·2h]`` output each read or written once in f32. Its bound
is the larger of those operations at the f32 peak and those bytes at HBM's
rate (operations at the cell's shapes).
"""

from __future__ import annotations

import types

from pbench import counts, spans

K9 = "bidaf_tiled_cluster_kernel"


def is_k9(name: str) -> bool:
    return K9 in name


def k9_bound_s(cfg: dict, batch: int, p: dict) -> float:
    """K9's least time for a batch's audio block."""
    d, h2 = cfg["data"], 2 * cfg["model"]["hidden_size"]
    T_c, T_q = d["max_sentences"], d["max_audio_frames"]
    flops = batch * counts.bidaf_flops(T_c, T_q, h2)
    nbytes = 4 * batch * (T_c * h2 + T_q * h2 + T_c * 4 * h2)
    return max(flops / p["f32"], nbytes / p["hbm"])


def kernel_in_spans(run, names, test) -> float | None:
    """Device seconds of the activities whose name passes ``test`` and whose
    launch lies inside one of ``names``' spans; ``None`` off the card or
    where no such span was recorded."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    only = types.SimpleNamespace(host=run.trace.host,
                                 device=[d for d in run.trace.device if test(d[0])])
    got = spans.device(only, names)
    return None if got is None else got[0]
