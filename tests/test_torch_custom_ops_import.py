"""The port's custom ops (``ops/cuda/registry.py``) dispatch the same whatever
``sys.path`` holds at their first call.

``torch.library`` wraps an op's implementations in ``torch._disable_dynamo``,
which imports ``torch._dynamo`` at the op's first call; ``torch._dynamo``
imports ``cProfile``, which imports ``profile``. A directory on ``sys.path``
holding a ``profile.py`` (a script directory, or ``tools/`` with the JAX
package's profiler CLI) then shadows the standard library's module, and
every kernel-flags-on call failed with ``AttributeError: module 'profile'
has no attribute 'run'``. The port imports ``torch._dynamo`` when its ops are
defined (``ops/cuda/__init__.py``), so the first call imports nothing.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import dataclasses, sys, tempfile
    import numpy as np
    import torch
    from mmbidaf_tpu_torch.config import tiny_test_config
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer, summary_from_picks

    shadow = tempfile.mkdtemp()
    open(shadow + "/profile.py", "w").close()  # an empty module named profile
    sys.path.insert(0, shadow)

    def summarizer(kernels):
        cfg = tiny_test_config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc,
            use_pallas_lstm=kernels, use_pallas_attention=kernels, use_pallas_melspec=kernels))
        return Summarizer.init_random(cfg, seed=3, vgg_spec=TINY_SPEC, device="cpu")

    def raw_batch(cfg, B=2):
        rng = np.random.default_rng(5)
        d = cfg.data
        lens = np.array([d.max_sentences, 3])
        sent = (np.arange(d.max_sentences)[None] < lens[:, None]).astype(np.float32)
        return {
            "text_ids": rng.integers(1, d.vocab_size, (B, d.max_sentences, d.max_words)).astype(np.int32),
            "word_mask": np.repeat(sent[:, :, None], d.max_words, 2),
            "sent_mask": sent,
            "frames": (rng.random((B, d.max_keyframes, 12, 16, 3)) * 255).astype(np.uint8),
            "img_mask": np.ones((B, d.max_keyframes), np.float32),
            "waveform": (rng.standard_normal((B, d.max_audio_frames * d.hop_length
                                              + d.win_length)) * 0.1).astype(np.float32),
            "aud_mask": np.ones((B, d.max_audio_frames), np.float32),
        }

    on, off = summarizer(True), summarizer(False)
    raw = raw_batch(on.cfg)
    before = set(sys.modules)
    picks_on = on._decode_batch(on._to_device(raw))  # the ops' first calls
    imported = sorted(set(sys.modules) - before)
    picks_off = off._decode_batch(off._to_device(raw))
    sents = [f"sentence {i}." for i in range(on.cfg.data.max_sentences)]
    assert [summary_from_picks(p, sents) for p in picks_on] == \\
        [summary_from_picks(p, sents) for p in picks_off], (picks_on, picks_off)
    assert all(m.startswith("mmbidaf_tpu_torch.") for m in imported), imported
    print("first-call imports:", imported)
    print("OK")
""")


def test_custom_ops_ignore_a_profile_module_on_sys_path(tmp_path):
    """In a fresh process: import the port, put a directory holding an empty
    ``profile.py`` first on ``sys.path``, then decode with the kernel flags
    on (the custom ops' first calls, on their CPU implementations): the
    summaries equal the flags-off ones, and the first calls import no module
    but the port's own kernel modules (``torch/_compile.py``'s wrapper was
    the only lazy import on the op path)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")
