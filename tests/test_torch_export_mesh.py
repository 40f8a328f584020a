"""Mesh artifacts of the port (``mmbidaf_tpu_torch/export.py`` on a mesh of
``parallel/``) on gloo process groups on the CPU, against the JAX package's
single-device ``ExportedDecoder`` on the same weights and numpy batch.

Groups of 2 and 4 processes spawned from this file (``tests/torch_group.py``;
torch and the port only) export data-parallel (2 and 4 ranks), DP × TP
(``data=2 × model=2``) and TP-only (B=1, the batch replicated) artifacts,
rank 0 writing the files; fresh groups of as many processes then load them,
one after making an extra process group first (the loader's groups then get
other names: no group name is inside a program). No run has a compilation
cache. The JAX side runs here.

Tolerances: the loaded artifact equals the live mesh ``Summarizer`` of the
exporting group bit for bit (the same ops on the same rows); against JAX's
program, picks exactly and log-probs within ``atol=rtol=1e-5``, the bound of
``tests/test_torch_export.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import torch_group
from torch_group import REPO

HW = (12, 16)


# ---------------------------------------------------------------------------
# The gloo side (no JAX here).
# ---------------------------------------------------------------------------


def _summarizer(inputs):
    from mmbidaf_tpu_torch.config import MeshConfig, config_from_dict
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = config_from_dict(inputs["cfg"])
    cfg = dataclasses.replace(cfg, mesh=MeshConfig(**inputs["mesh"]))
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    dp = inputs["dp"]
    return Summarizer.from_jax_params(inputs["params"], inputs["fe"], w2i, cfg, TINY_SPEC,
                                      device="cpu", data_parallel=dp,
                                      serve_batch_size=inputs["batch"] if dp else None)


def case_export(inputs):
    """Export the mesh summarizer (every rank; rank 0 writes), then its live
    decode of the batch; with ``bad_batch`` the export's error instead."""
    from mmbidaf_tpu_torch import export

    s = _summarizer(inputs)
    if "bad_batch" in inputs:
        try:
            export.export_summarizer(s, inputs["out"], batch_size=inputs["bad_batch"],
                                     frame_hw=HW)
        except ValueError as e:
            return {"error": np.array(str(e))}
        return {"error": np.array("")}
    m = export.export_summarizer(s, inputs["out"], batch_size=inputs["batch"], frame_hw=HW)
    log_p, picks = s._decode_batch_device(s._to_device(inputs["raw"]))
    return {"manifest": np.array(json.dumps(m)), "live.log_p": log_p.numpy(),
            "live.picks": picks.numpy()}


def case_load(inputs):
    """A fresh group loads the artifact (after an extra group, where asked)
    and decodes the batch."""
    import torch.distributed as dist

    from mmbidaf_tpu_torch.export import ExportedDecoder

    if inputs.get("extra_group"):
        dist.new_group(list(range(dist.get_world_size())))
    dec = ExportedDecoder(inputs["out"], device="cpu")
    log_p, picks = dec.decode_raw(inputs["raw"])
    leaked = sorted(m for m in sys.modules if m in ("jax", "mmbidaf_tpu") or m.startswith((
        "jax.", "mmbidaf_tpu.", "mmbidaf_tpu_torch.models", "mmbidaf_tpu_torch.serving",
        "mmbidaf_tpu_torch.data.frontend")))
    return {"log_p": log_p, "picks": picks, "leaked": np.array(leaked, dtype=str)}


CASES = {"export": case_export, "load": case_load}

if __name__ == "__main__":
    if len(sys.argv) == 7 and sys.argv[1] == "worker":
        sys.path.insert(0, REPO)
        torch_group.worker_main(CASES, sys.argv[2:])
        sys.exit(0)
    raise SystemExit("usage: test_torch_export_mesh.py worker RANK WORLD STORE PLAN OUT_DIR")


# ---------------------------------------------------------------------------
# The pytest side.
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

import jax  # noqa: E402

from mmbidaf_tpu import export as jexport  # noqa: E402
from mmbidaf_tpu import serving as jserving  # noqa: E402
from mmbidaf_tpu.config import tiny_test_config as j_tiny_config  # noqa: E402
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY  # noqa: E402
from mmbidaf_tpu_torch import export  # noqa: E402
from mmbidaf_tpu_torch.config import tiny_test_config  # noqa: E402
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC  # noqa: E402
from mmbidaf_tpu_torch.serving import Summarizer  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
# each layout: mesh, data_parallel, batch
LAYOUTS = {
    "dp2": (dict(num_data=2), True, 4),
    "dp4": (dict(num_data=4), True, 4),
    "dp_tp": (dict(num_data=2, num_model=2, tp_vgg=True), True, 4),
    "tp_b1": (dict(num_data=2, num_model=2, tp_vgg=True), False, 1),
}


def _cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))


def _jcfg():
    cfg = j_tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc))


def _raw(cfg, batch: int, seed: int = 5) -> dict:
    """A raw batch: ragged masks (row 1 half valid), a silent second waveform."""
    rng = np.random.default_rng(seed)
    raw = {}
    for k, s in export._raw_specs(cfg, batch, HW).items():
        if k == "text_ids":
            raw[k] = rng.integers(0, cfg.data.vocab_size, s.shape).astype(np.int32)
        elif k == "frames":
            raw[k] = (rng.random(s.shape) * 255).astype(np.uint8)
        elif k == "waveform":
            raw[k] = rng.standard_normal(s.shape).astype(np.float32)
            raw[k][min(1, batch - 1)] = 0.0
        else:
            m = np.ones(s.shape, np.float32)
            m[min(1, batch - 1), ..., max(1, s.shape[-1] // 2):] = 0.0
            raw[k] = m
    return raw


@pytest.fixture(scope="module")
def weights():
    base = jserving.Summarizer.init_random(_jcfg(), seed=3, vgg_spec=J_TINY)
    return base, jax.tree.map(np.asarray, base.params), jax.tree.map(np.asarray, base.fe_params)


def _inputs(name, weights, root):
    _, params, fe = weights
    mesh, dp, batch = LAYOUTS[name]
    return {"cfg": dataclasses.asdict(_cfg()), "mesh": mesh, "dp": dp, "batch": batch,
            "params": params, "fe": fe, "raw": _raw(_cfg(), batch), "out": str(root / name)}


@pytest.fixture(scope="module")
def groups(weights, tmp_path_factory):
    """Export in groups of 2 and 4, then load in fresh groups of 2 and 4;
    the case results by layout."""
    root = tmp_path_factory.mktemp("mesh_art")
    inp = {name: _inputs(name, weights, root) for name in LAYOUTS}
    out = {}
    for world, names in ((2, ["dp2"]), (4, ["dp4", "dp_tp", "tp_b1"])):
        plan = [("export", inp[n]) for n in names]
        if world == 2:  # a DP batch the data axes do not divide
            plan.append(("export", dict(inp["dp2"], bad_batch=3, out=str(root / "never"))))
        res = torch_group.spawn(__file__, str(root / f"export{world}"), world, plan)
        for n, r in zip(names, res):
            out[n] = {"export": r}
        if world == 2:
            out["bad_batch"] = res[-1]
        plan = [("load", dict(inp[n], extra_group=i == 0)) for i, n in enumerate(names)]
        res = torch_group.spawn(__file__, str(root / f"load{world}"), world, plan)
        for n, r in zip(names, res):
            out[n]["load"] = r
    return inp, out


@pytest.fixture(scope="module")
def jax_programs(weights, tmp_path_factory):
    """JAX's single-device ``ExportedDecoder`` of the same weights at B=4 and B=1."""
    root = tmp_path_factory.mktemp("jax_art")
    out = {}
    for batch in (4, 1):
        jexport.export_summarizer(weights[0], str(root / f"b{batch}"), batch_size=batch,
                                  frame_hw=HW)
        out[batch] = jexport.ExportedDecoder(str(root / f"b{batch}"))
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_mesh_artifact_matches_jax_and_the_live_mesh(name, groups, jax_programs):
    """Every rank of a fresh group answers the whole batch: picks equal to
    JAX's single-device program, log-probs within 1e-5, and bit for bit the
    live mesh summarizer's answer in the exporting group; the loading
    processes import none of the model's code."""
    inp, out = groups
    raw = inp[name]["raw"]
    j_lp, j_picks = jax_programs[LAYOUTS[name][2]].decode_raw(raw)
    for r, res in enumerate(out[name]["load"]):
        np.testing.assert_array_equal(res["picks"], j_picks, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(res["log_p"], j_lp, **F32, err_msg=f"{name} rank {r}")
        live = out[name]["export"][r]
        np.testing.assert_array_equal(res["picks"], live["live.picks"])
        np.testing.assert_array_equal(res["log_p"], live["live.log_p"])
        assert res["leaked"].size == 0, res["leaked"]


def test_mesh_manifests(groups):
    """The manifest records the mesh, the batch axes (none for the TP-only
    B=1 artifact) and the split classifier's leaves; the weights are whole."""
    inp, out = groups
    manifests = {n: json.loads(str(out[n]["export"][0]["manifest"])) for n in LAYOUTS}
    for r in range(1, 4):  # every rank returns the manifest rank 0 wrote
        assert json.loads(str(out["dp4"]["export"][r]["manifest"])) == manifests["dp4"]
    m = manifests["dp2"]
    assert m["format_version"] == 2 and m["mesh"] == {
        "axis_names": ["data"], "shape": [2], "batch_axes": ["data"]}
    assert m["head_file"] is None and not any(m["weight_shards"])
    assert manifests["dp4"]["mesh"]["shape"] == [4]
    for n, axes in (("dp_tp", ["data"]), ("tp_b1", [])):
        m = manifests[n]
        assert m["mesh"] == {"axis_names": ["data", "model"], "shape": [2, 2], "batch_axes": axes}
        assert m["head_file"] == "decode.head.pt2" and "decode.head.pt2" in m["sha256"]
        split = {w: s for w, s in zip(m["weight_names"], m["weight_shards"]) if s}
        assert split == {"frontend.vgg.fc1_w": {"dim": 1, "axis": "model"},
                         "frontend.vgg.fc1_b": {"dim": 0, "axis": "model"},
                         "frontend.vgg.fc2_w": {"dim": 0, "axis": "model"}}
        import torch

        w = torch.load(os.path.join(inp[n]["out"], "weights.pt"), weights_only=True)
        assert tuple(w["frontend.vgg.fc2_w"].shape) == (32, 32)  # whole, not a shard
    assert manifests["tp_b1"]["batch_size"] == 1
    msg = str(out["bad_batch"][0]["error"])
    assert "shards the batch over 2 devices" in msg and "got 3" in msg


def test_loader_checks_the_group_size_and_the_shard_specs(groups, tmp_path):
    """A world size other than the mesh's fails with both numbers; a shard
    list of the wrong length fails at load."""
    inp, _ = groups
    with pytest.raises(ValueError, match=r"mesh of 2 processes; this process group has 1"):
        export.ExportedDecoder(inp["dp2"]["out"], device="cpu")
    bad = tmp_path / "bad"
    shutil.copytree(inp["dp_tp"]["out"], bad)
    m = json.loads((bad / "manifest.json").read_text())
    m["weight_shards"] = m["weight_shards"][:-2]
    (bad / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="weight_shards has"):
        export.ExportedDecoder(str(bad), device="cpu")


# The keys of a single-device manifest as the first artifacts wrote them.
SINGLE_DEVICE_KEYS = {
    "format_version", "torch_version", "sha256", "device", "batch_size", "frame_hw",
    "compute_dtype", "n_weight_leaves", "weight_names", "weight_dtypes", "raw_inputs",
    "vgg_frame_chunk", "decode_mode", "beam_width", "outputs", "mesh", "bucket_programs"}


def test_single_device_artifacts_load_unchanged(weights, tmp_path):
    """A single-device export writes the first format, key for key, and the
    loader takes it as before: the live answer bit for bit."""
    _, params, fe = weights
    s = Summarizer.from_jax_params(params, fe, {f"w{i}": i for i in range(_cfg().data.vocab_size)},
                                   _cfg(), TINY_SPEC, device="cpu")
    m = export.export_summarizer(s, str(tmp_path / "one"), batch_size=2, frame_hw=HW)
    on_disk = json.loads((tmp_path / "one" / "manifest.json").read_text())
    assert m == on_disk and set(on_disk) == SINGLE_DEVICE_KEYS
    assert on_disk["format_version"] == 1 and on_disk["mesh"] is None
    dec = export.ExportedDecoder(str(tmp_path / "one"), device="cpu")
    assert dec.layout is None and export.ExportedSummarizer(
        str(tmp_path / "one"), device="cpu").parallelism() is None
    raw = _raw(_cfg(), 2)
    lp, picks = dec.decode_raw(raw)
    live_lp, live_picks = s._decode_batch_device(s._to_device(raw))
    np.testing.assert_array_equal(picks, live_picks.numpy())
    np.testing.assert_array_equal(lp, live_lp.numpy())


def test_layout_flags_against_the_manifest(groups):
    """The CLIs' mesh flags with ``--artifact``: a flag that matches the
    frozen layout passes, another names the conflict."""
    inp, out = groups
    man = {n: json.loads(str(out[n]["export"][0]["manifest"])) for n in LAYOUTS}
    ok = export.layout_flag_conflict
    assert ok(man["dp_tp"], data_parallel=True, tp_vgg=1, num_model=2) is None
    assert ok(man["dp2"], data_parallel=True, tp_vgg=0, num_model=1, sp_audio=0, num_seq=1) is None
    assert ok(man["tp_b1"], tp_vgg=1) is None
    for m, kw, flag in ((man["tp_b1"], dict(data_parallel=True), "--data_parallel"),
                        (man["dp2"], dict(tp_vgg=1), "--tp_vgg"),
                        (man["dp_tp"], dict(num_model=4), "--num_model"),
                        (man["dp2"], dict(sp_audio=1), "--sp_audio"),
                        (man["dp2"], dict(num_seq=2), "--num_seq")):
        msg = ok(m, **kw)
        assert msg is not None and msg.startswith(flag) and "fixed at export time" in msg
