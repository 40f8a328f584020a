"""K1's device microseconds a step of the audio tower's walk: K1's
activities (both routes, matched by symbol) launched inside the program's
``model.audio_tower`` span, over batches × ``max_audio_frames``. The walk
is a chain of dependent steps whose cost latency sets, not operations or
bytes."""

from pbench import audio_chain, counts


def read(run):
    if run.program != "serve":
        return None
    s = audio_chain.kernel_in_spans(run, ("model.audio_tower",), lambda n: counts.is_kernel(n, "K1"))
    if not s:
        return None
    return s / (run.window.units * run.cfg["data"]["max_audio_frames"]) * 1e6
