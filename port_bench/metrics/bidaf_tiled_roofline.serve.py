"""K9's share of its roofline: its least time a batch
(``audio_chain.k9_bound_s``) over its device time a batch, matched by
symbol."""

from pbench import audio_chain


def read(run):
    if run.program != "serve" or run.trace is None or run.peaks is None:
        return None
    spent = run.trace.kernel_s(audio_chain.is_k9)
    if spent <= 0:
        return None
    return 100.0 * audio_chain.k9_bound_s(run.cfg, run.batch, run.peaks) * run.window.units / spent
