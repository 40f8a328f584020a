"""The reference's PyTorch checkpoint into the port: ``interop/torch_port.py``
against the JAX package's ``interop/torch_port.py`` and the torch oracle
(``tests/oracles/torch_model.py``), the ``export_mmbidaf`` round trip,
``Summarizer.from_torch_state_dict``, and the port's
``tools/convert_torch_checkpoint.py`` read back by ``Summarizer.from_run``
and ``infer --load_dir``.

Tolerances. The two ``port_mmbidaf``s do the same numpy transposes and
bias sums, so their trees are equal leaf for leaf. The port's forward on
the ported weights: greedy picks equal to the oracle's and to JAX's, and
log-probs within ``tests/test_model_parity.py``'s teacher-forcing bound
(``atol=5e-5``; the same f32 model, sums in other orders). Export then
port is the identity, exactly.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu.interop import torch_port as j_port
from mmbidaf_tpu.models.mmbidaf import mmbidaf_decode as j_decode
from mmbidaf_tpu_torch import infer
from mmbidaf_tpu_torch.config import config_to_dict, tiny_test_config
from mmbidaf_tpu_torch.data.vocab import save_vocab
from mmbidaf_tpu_torch.interop import torch_port
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_apply, mmbidaf_decode
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.serving import Summarizer
from mmbidaf_tpu_torch.tools import convert_torch_checkpoint
from tests.oracles import torch_model as oracle

ATOL = 5e-5
REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"trimodal": (True, True, 1), "text+image": (True, False, 1),
           "text+audio": (False, True, 1), "text-only": (False, False, 1),
           "stacked": (True, True, 2)}


def _configs(use_images, use_audio, layers, **model):
    out = []
    for make in (tiny_test_config, j_tiny_config):
        cfg = make(use_images=use_images, use_audio=use_audio)
        out.append(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_rnn_layers=layers, **model)))
    return out


def _oracle(cfg, seed=0):
    rng = np.random.default_rng(seed)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    torch.manual_seed(seed)
    m = cfg.model
    return oracle.MMBiDAF(
        torch.from_numpy(wv), m.hidden_size,
        img_feat_dim=m.img_feat_dim if m.use_images else None,
        audio_feat_dim=m.audio_feat_dim if m.use_audio else None,
        num_decode_steps=m.max_decode_steps, mask_selected=m.mask_selected,
        num_rnn_layers=m.num_rnn_layers,
    ).eval()


def _oracle_inputs(batch, cfg, targets=False):
    kw = {k: torch.from_numpy(batch[k]) for k in ("word_mask", "sent_mask")}
    kw["text_ids"] = torch.from_numpy(batch["text_ids"]).long()
    if targets:
        kw["targets"] = torch.from_numpy(batch["targets"]).long()
    if cfg.model.use_images:
        kw["images"], kw["img_mask"] = (torch.from_numpy(batch[k]) for k in ("images", "img_mask"))
    if cfg.model.use_audio:
        kw["audio"], kw["aud_mask"] = (torch.from_numpy(batch[k]) for k in ("audio", "aud_mask"))
    return kw


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_mmbidaf_matches_jax_and_oracle(name):
    """The oracle's state dict through both ``port_mmbidaf``s (tensors on
    the port's side, numpy on JAX's): equal leaf for leaf; the port's model
    on it picks as the oracle and JAX do, with log-probs within 5e-5, under
    greedy decode and teacher forcing."""
    cfg, j_cfg = _configs(*CONFIGS[name])
    tm = _oracle(cfg)
    sd = tm.state_dict()
    ours = flatten_pytree(torch_port.port_mmbidaf(sd, cfg.model.use_images, cfg.model.use_audio))
    theirs = flatten_pytree(j_port.port_mmbidaf({k: v.numpy() for k, v in sd.items()},
                                                cfg.model.use_images, cfg.model.use_audio))
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)

    model = torch_port.model_from_state_dict(sd, cfg, "cpu")
    batch = synthetic_batch(np.random.default_rng(3), j_cfg, batch_size=3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        lp, picks = mmbidaf_decode(model, tb, cfg)
        t_lp, t_picks = tm(**_oracle_inputs(batch, cfg))
        tf_lp = mmbidaf_apply(model, tb, cfg)
        t_tf_lp, _ = tm(**_oracle_inputs(batch, cfg, targets=True))
    params = j_port.port_mmbidaf({k: v.numpy() for k, v in sd.items()},
                                 cfg.model.use_images, cfg.model.use_audio)
    _, j_picks = j_decode(params, {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg)
    np.testing.assert_array_equal(picks.numpy(), t_picks.numpy())
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    valid = np.broadcast_to(batch["sent_mask"][:, None, :] > 0, t_lp.shape)
    np.testing.assert_allclose(lp.numpy()[valid], t_lp.numpy()[valid], atol=ATOL)
    np.testing.assert_allclose(tf_lp.numpy()[valid], t_tf_lp.numpy()[valid], atol=ATOL)


@pytest.mark.parametrize("name", ["trimodal", "text-only", "stacked"])
def test_export_round_trip(name):
    """``export_mmbidaf`` loads into the oracle strictly, equals JAX's
    export of the same weights, and ports back to the same model."""
    cfg, _ = _configs(*CONFIGS[name])
    tm = _oracle(cfg, seed=1)
    model = torch_port.model_from_state_dict(tm.state_dict(), cfg, "cpu")
    exported = torch_port.export_mmbidaf(model)
    fresh = _oracle(cfg, seed=2)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)
    j_exported = j_port.export_mmbidaf(
        j_port.port_mmbidaf({k: v.numpy() for k, v in tm.state_dict().items()},
                            cfg.model.use_images, cfg.model.use_audio))
    assert exported.keys() == j_exported.keys()
    for k, v in j_exported.items():
        np.testing.assert_array_equal(exported[k], np.asarray(v), err_msg=k)
    again = torch_port.model_from_state_dict(exported, cfg, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_missing_or_misshapen_weights_raise():
    cfg, _ = _configs(True, True, 1)
    sd = dict(_oracle(cfg).state_dict())
    with pytest.raises(KeyError):
        torch_port.model_from_state_dict({k: v for k, v in sd.items() if k != "fuse.bias"},
                                         cfg, "cpu")
    sd["fuse.bias"] = torch.zeros(3)
    with pytest.raises(RuntimeError):
        torch_port.model_from_state_dict(sd, cfg, "cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("corpus")
    mod.make_corpus(str(root), videos=3, sentences=6, ragged=True, frames=4, seconds=0.3, seed=5)
    return root


def test_convert_cli_then_from_run_and_infer(tmp_path, corpus, capsys):
    """The starter's ``{"model_state": …}`` wrapper through the convert CLI:
    ``config.json`` and step 0 with EMA = params; ``from_run`` serves the
    oracle's weights (summaries equal to ``from_torch_state_dict``'s with
    the same seed), and ``infer --load_dir`` restores it."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, audio_feat_dim=cfg.data.n_mfcc, vgg_variant="tiny"))
    tm = _oracle(cfg, seed=4)
    torch.save({"model_state": tm.state_dict(), "step": 1234}, tmp_path / "best.pth.tar")
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(config_to_dict(cfg), f)
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    save_vocab(w2i, tm.emb.embed.weight.detach().numpy(), str(tmp_path / "vocab.json"),
               str(tmp_path / "emb.npz"))
    out = tmp_path / "run"
    convert_torch_checkpoint.main(["--torch_ckpt", str(tmp_path / "best.pth.tar"),
                                   "--config_json", str(tmp_path / "cfg.json"), "--out", str(out),
                                   "--vocab", str(tmp_path / "vocab.json")])
    assert "step 0" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["ckpts", "config.json", "emb.npz",
                                                     "vocab.json"]
    index = json.loads((out / "ckpts" / "index.json").read_text())
    assert index == {"0": {"loss": 0.0}}
    blob = torch.load(out / "ckpts" / "step_0.pt", weights_only=True)
    for k, v in blob["ema_params"].items():
        assert torch.equal(v, blob["params"][k]), k

    served = Summarizer.from_run(str(out), seed=7, device="cpu")
    direct = Summarizer.from_torch_state_dict(tm.state_dict(), w2i, cfg, TINY_SPEC, seed=7,
                                              device="cpu")
    for k, v in direct.model.state_dict().items():
        assert torch.equal(served.model.state_dict()[k], v), k
    dirs = sorted(str(p) for p in corpus.iterdir() if p.is_dir())
    assert served.summarize_batch(dirs) == direct.summarize_batch(dirs)

    infer.main(["--device", "cpu", "--load_dir", str(out / "ckpts"), "--num_batches", "1",
                "--batch_size", "2"])
    assert "loaded step 0" in capsys.readouterr().out


def test_a_run_saved_on_another_device_serves(tmp_path, capsys):
    """A checkpoint's dropout-generator state is its device's: a CUDA
    generator's (16 bytes) cannot enter a CPU generator (nor a CPU one a
    CUDA generator, as a run converted on the host and served on the card
    would need). ``from_run`` and ``infer --load_dir`` load the weights
    alone, so such a run serves; a training resume still restores the
    generator."""
    cfg = tiny_test_config()
    tm = _oracle(cfg, seed=6)
    torch.save(tm.state_dict(), tmp_path / "bare.pt")  # a bare state_dict
    (tmp_path / "cfg.json").write_text(json.dumps(config_to_dict(cfg)))
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    save_vocab(w2i, tm.emb.embed.weight.detach().numpy(), str(tmp_path / "vocab.json"),
               str(tmp_path / "emb.npz"))
    out = tmp_path / "run"
    convert_torch_checkpoint.convert(str(tmp_path / "bare.pt"), str(tmp_path / "cfg.json"),
                                     str(out), str(tmp_path / "vocab.json"),
                                     str(tmp_path / "emb.npz"))
    path = out / "ckpts" / "step_0.pt"
    blob = torch.load(path, weights_only=True)
    blob["generator"] = torch.zeros(16, dtype=torch.uint8)  # the size of a CUDA generator's
    torch.save(blob, path)
    s = Summarizer.from_run(str(out), device="cpu")
    for k, v in torch_port.model_from_state_dict(tm.state_dict(), cfg, "cpu").state_dict().items():
        assert torch.equal(s.model.state_dict()[k], v), k
    infer.main(["--device", "cpu", "--load_dir", str(out / "ckpts"), "--num_batches", "1",
                "--batch_size", "2"])
    assert "loaded step 0" in capsys.readouterr().out
