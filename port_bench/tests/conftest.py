"""Shared set-up of the benchmark's own tests: the harness on the path, and
each kind of cell at widths a CPU run holds."""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_files(cell: str, program: str | None = None):
    """The cell's configuration file and traffic mix shrunk to CPU size (every
    width cut; the code paths and flags as the cell runs them)."""
    from pbench import spec

    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg = copy.deepcopy(spec.config_file(bench, w["config"]))
    cfg["model"].update(hidden_size=8, emb_dim=12, img_feat_dim=20, audio_feat_dim=8)
    cfg["data"].update(max_sentences=7, max_words=5, max_keyframes=3, max_audio_frames=9,
                       vocab_size=50, n_fft=64, hop_length=16, win_length=48, n_mels=12, n_mfcc=8,
                       image_size=32)
    mix = dict(spec.traffic(w["traffic"]), batch=4, pool=4)
    if mix["program"] == "serve":
        mix["frame_hw"] = [40, 48]
    return bench, cfg, mix


@pytest.fixture
def tiny():
    return tiny_files
