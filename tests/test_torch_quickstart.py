"""The port's quickstart (``python -m mmbidaf_tpu_torch.examples.quickstart``,
the port of ``examples/quickstart.py``) end to end on the CPU at a tiny
size: a synthetic corpus, ``train.cli`` for 20 steps, ``infer`` with ROUGE,
then ``Summarizer.from_run`` answering ``summarize`` and
``summarize_long``. It must end in ``quickstart OK`` within its own time
limit (about 40 s on one core here)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_quickstart_runs_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "mmbidaf_tpu_torch.examples.quickstart", "--device", "cpu",
         "--workdir", str(tmp_path), "--steps", "20"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "quickstart OK", res.stdout[-2000:]
    assert any(line.startswith("summarize: ") and len(line) > len("summarize: ") for line in lines)
    assert any("ROUGE-L" in line for line in lines)
    assert (tmp_path / "runs" / "mmbidaf" / "config.json").exists()
