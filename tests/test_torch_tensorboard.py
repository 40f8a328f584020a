"""The port's tensorboard writer (``train/metrics.py::TensorboardWriter``)
against the JAX package's (tensorflow's ``tf.summary``): both event files
read back through tensorboard's own ``EventAccumulator`` give equal (tag,
step, value) triples; the port's reader checks the framing's CRCs;
``train.cli`` writes the scalars of ``log.jsonl`` under ``<run>/tb``.

Values are float32 in both files (``simple_value`` in the port's,
tensorflow's scalar tensor in JAX's), so they compare exactly.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from mmbidaf_tpu_torch.train import cli
from mmbidaf_tpu_torch.train.metrics import (TensorboardWriter, crc32c, encode_event,
                                             masked_crc32c, read_tensorboard_scalars, tfrecord)

REPO = Path(__file__).resolve().parents[1]
LOGS = [(1, {"loss": 2.5, "lr": 0.5, "grad_norm": 1.25}),
        (50, {"loss": 1.75, "lr": 0.5, "grad_norm": 3.0e-3}),
        (100, {"eval_loss": 1.5, "ROUGE-1": 0.3125, "ROUGE-2": 0.1, "ROUGE-L": 0.2}),
        (2**40, {"loss": -1e30, "steps_per_s": 12.3456789})]


def _accumulated(log_dir) -> list[tuple[str, int, float]]:
    """Every scalar of ``log_dir`` through tensorboard's plugin accumulator,
    which reads both the legacy ``simple_value`` and tensorflow's tensors."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing import plugin_event_accumulator as pea
    from tensorboard.util import tensor_util

    acc = pea.EventAccumulator(str(log_dir))
    acc.Reload()
    return sorted((tag, e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                  for tag in acc.Tags()["tensors"] for e in acc.Tensors(tag))


def test_crc32c_known_values():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert masked_crc32c(b"") == 0xA282EAD8


def test_event_file_equals_the_jax_writers(tmp_path):
    """The same logs through both writers: tensorboard reads equal triples;
    the port's scalars also read back through the legacy accumulator's
    ``Scalars`` and through the port's own reader, file order kept."""
    pytest.importorskip("tensorflow")
    from mmbidaf_tpu.train.metrics import TensorboardWriter as JaxWriter

    ours, theirs = TensorboardWriter(str(tmp_path / "ours")), JaxWriter(str(tmp_path / "theirs"))
    assert theirs.active
    for step, scalars in LOGS:
        ours.log(step, scalars)
        theirs.log(step, scalars)
    ours.close()
    got, want = _accumulated(tmp_path / "ours"), _accumulated(tmp_path / "theirs")
    assert len(got) == sum(len(s) for _, s in LOGS) and got == want

    from tensorboard.backend.event_processing import event_accumulator as ea

    acc = ea.EventAccumulator(str(tmp_path / "ours"))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [
        (s, float(np.float32(v["loss"]))) for s, v in LOGS if "loss" in v]
    version, triples = read_tensorboard_scalars(ours.path)
    assert version == "brain.Event:2"
    assert triples == [(k, s, float(np.float32(v))) for s, d in LOGS for k, v in d.items()]


def test_flushed_after_every_log_and_crcs_checked(tmp_path):
    w = TensorboardWriter(str(tmp_path))
    w.log(3, {"loss": 0.5})
    assert read_tensorboard_scalars(w.path)[1] == [("loss", 3, 0.5)]  # before close
    w.close()
    data = bytearray(Path(w.path).read_bytes())
    data[-6] ^= 1
    Path(w.path).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_tensorboard_scalars(w.path)


def test_record_framing():
    event = encode_event(1.5, 7, scalars={"a": 1.0})
    rec = tfrecord(event)
    assert len(rec) == len(event) + 16
    assert int.from_bytes(rec[:8], "little") == len(event)
    assert int.from_bytes(rec[8:12], "little") == masked_crc32c(rec[:8])
    assert rec[12:-4] == event
    assert int.from_bytes(rec[-4:], "little") == masked_crc32c(event)


def test_unwritable_directory_raises(tmp_path):
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        TensorboardWriter(str(tmp_path / "file"))


def test_trainer_writes_the_logged_scalars(tmp_path):
    """``train.cli`` logs each record of ``log.jsonl`` to ``<run>/tb`` too."""
    cli.main(["--config_json", str(REPO / "examples" / "tiny_config.json"), "--device", "cpu",
              "--num_steps", "4", "--eval_steps", "2", "--save_dir", str(tmp_path)])
    run = tmp_path / "mmbidaf"
    records = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    want = [(k, r["step"], float(np.float32(v))) for r in records
            for k, v in r.items() if k not in ("step", "time")]
    (path,) = [run / "tb" / f for f in os.listdir(run / "tb")]
    assert path.name.startswith("events.out.tfevents.")
    assert read_tensorboard_scalars(str(path))[1] == want
    assert {k for k, _, _ in want} >= {"loss", "grad_norm", "lr", "eval_loss", "ROUGE-L"}
