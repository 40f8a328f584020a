"""The port's demos (``mmbidaf_tpu_torch/examples/``) on the CPU: its own
synthetic-corpus writer against the JAX package's, the parity demo against
the JAX one, and the parallel demo on a gloo group of 8 processes
(2 data × 2 seq × 2 model).

- ``make_synthetic_corpus``: every file byte for byte the JAX script's for
  the same flags (two seeds, both cue modes, learnable and ragged, a
  train/dev split), through ``make_corpus`` and through the CLI;
- ``parity_demo``: the reference oracle's checkpoint through the port,
  greedy picks equal to the oracle's and to the JAX demo's (its own
  distance bound, 5e-5, holds inside ``main``);
- ``parallel_demo``: training, ``infer`` and DP × TP serving on the mesh
  end to end, the mesh artifact's summaries equal to the live ones on every
  rank (``main`` raises otherwise).

The demos raise without a card unless given ``--device cpu``.
"""

import ast
import contextlib
import io
import re
import sys
from pathlib import Path

import pytest
import torch

from mmbidaf_tpu_torch.examples import make_synthetic_corpus, parallel_demo, parity_demo

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from examples import make_synthetic_corpus as j_corpus  # noqa: E402
from examples import parity_demo as j_parity_demo  # noqa: E402

SMALL = dict(videos=3, sentences=6, frames=3, seconds=0.5, learnable=True, split=1, ragged=True)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cue_mode", ["all", "split"])
def test_corpus_writer_is_byte_equal_to_jax(tmp_path, seed, cue_mode):
    j_corpus.make_corpus(str(tmp_path / "jax"), seed=seed, cue_mode=cue_mode, **SMALL)
    make_synthetic_corpus.make_corpus(str(tmp_path / "port"), seed=seed, cue_mode=cue_mode,
                                      **SMALL)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 3 * (SMALL["frames"] + 4)  # frames, wav, transcript, summary, cues
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_corpus_writer_cli_is_byte_equal_to_jax(tmp_path):
    make_synthetic_corpus.main(["--out", str(tmp_path / "port"), "--videos", "2",
                                "--frames", "2", "--seconds", "0.25", "--seed", "3"])
    j_corpus.make_corpus(str(tmp_path / "jax"), videos=2, frames=2, seconds=0.25, seed=3)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_parity_demo_picks_equal_the_oracle_and_jax():
    res = parity_demo.main(["--device", "cpu"])
    assert res["picks_equal"] and res["max_abs_log_p"] < parity_demo.MAX_LOG_P_DISTANCE
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_parity_demo.main()
    j_picks = re.search(r"jax picks:\s+(\[.*\])", out.getvalue()).group(1)
    assert res["picks"] == ast.literal_eval(j_picks)


def test_parallel_demo_on_eight_gloo_processes(tmp_path):
    res = parallel_demo.main(["--device", "cpu", "--workdir", str(tmp_path), "--steps", "4"])
    assert res["world"] == 8 and res["mesh"] == {"data": 2, "seq": 2, "model": 2}
    assert res["serving"]["mesh_axes"] == {"data": 4, "model": 2} and res["serving"]["tp_vgg"]
    assert res["artifact_equal"] and res["videos"] == 6
    assert all(isinstance(s, str) and s for s in res["summaries"])


@pytest.mark.parametrize("demo", [parity_demo, parallel_demo], ids=["parity", "parallel"])
def test_demo_defaults_to_the_card(demo, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--workdir", str(tmp_path)] if demo is parallel_demo else [])
