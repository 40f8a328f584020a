"""The port's mesh layouts (``mmbidaf_tpu_torch/parallel``) on gloo process
groups on the CPU, held against the JAX package's ``mmbidaf_tpu.parallel``
on the 8 faked CPU devices of ``tests/conftest.py``.

The port runs in 2 or 4 processes spawned from this file (``python
tests/test_torch_parallel.py worker ...``: torch and the port only, never
``jax``; ``tests/torch_group.py``), which meet through a ``FileStore`` in
``tmp_path`` and run every case of their world size in one group; each case
writes its results as ``.npz``. Every ``join`` has a time limit, and all
processes are killed when one hangs. The JAX side runs here, on the same
seeded numpy inputs.

Tolerances. The SP chain and the DP / TP layouts compute the same f32
arithmetic in another order (the ring's flash softmax against JAX's ring and
its plain softmax; sums split across ranks): LSTM and attention outputs
``atol=1e-5``; audio features ``rtol=2e-5, atol=2e-4`` (MFCCs reach ~100, the
bound of ``tests/test_torch_ops.py``); gradients ``atol=1e-5, rtol=1e-4``; a train
step's loss and grad norm ``rtol=1e-5``, its parameters ``atol=1e-6``; greedy
and beam picks exactly, log-probs ``atol=1e-5``. At world size 1 without a
process group the layouts are the path without a mesh, bit for bit.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch_group
from torch_group import GROUP_TIMEOUT, REPO


# ---------------------------------------------------------------------------
# The gloo side: cases run by every rank of a spawned group (no JAX here).
# ---------------------------------------------------------------------------


def _port_cfg(d: dict):
    from mmbidaf_tpu_torch.config import config_from_dict

    return config_from_dict(d)


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def case_mesh(inputs):
    """Axis names, shape and coordinates, batch rows, for each mesh config."""
    from mmbidaf_tpu_torch.config import MeshConfig
    from mmbidaf_tpu_torch.parallel.mesh import (batch_rows, data_shard_count,
                                                 local_batch_rows, make_mesh)

    out = {}
    for i, kw in enumerate(inputs["meshes"]):
        mesh = make_mesh(MeshConfig(**kw), "cpu")
        out[f"{i}.names"] = np.array(mesh.axis_names)
        out[f"{i}.shape"] = np.array(list(mesh.shape.values()))
        out[f"{i}.coords"] = np.array(list(mesh.coords.values()))
        out[f"{i}.shards"] = np.array(data_shard_count(mesh))
        out[f"{i}.rows"] = np.array(batch_rows(mesh, 8) or (-1, -1))
        out[f"{i}.local"] = local_batch_rows(mesh, 8)
    return out


def case_sp_pieces(inputs):
    """SP frontend (both features, sharded and gathered), SP BiLSTM with its
    gradients, and the ring (lean and dropout) with its gradients, on a
    ``seq`` axis of the world's size."""
    import torch

    from mmbidaf_tpu_torch.config import MeshConfig
    from mmbidaf_tpu_torch.interop.from_jax import load_pytree
    from mmbidaf_tpu_torch.ops.audio import make_audio_frontend_consts
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams
    from mmbidaf_tpu_torch.parallel.audio_sp import make_sp_audio_frontend
    from mmbidaf_tpu_torch.parallel.mesh import make_mesh
    from mmbidaf_tpu_torch.parallel.ring_attention import make_ring_bidaf, shard_seq
    from mmbidaf_tpu_torch.parallel.sp_lstm import make_sp_bilstm

    mesh = make_mesh(MeshConfig(num_data=1, num_seq=inputs["n"]), "cpu")
    n, d = mesh.shape["seq"], mesh.coords["seq"]
    out = {}
    if "waveform" in inputs:
        a = inputs["audio"]
        consts = make_audio_frontend_consts(a["sample_rate"], a["n_fft"], a["win"], a["n_mels"],
                                            a["n_mfcc"], a["fmin"], a["fmax"], device="cpu")
        wav = _t(inputs["waveform"])
        for feature in ("mfcc", "logmel"):
            for gather in (False, True):
                fe = make_sp_audio_frontend(mesh, consts, a["win"], a["hop"], a["frames"],
                                            feature=feature, axis="seq", gather=gather)
                out[f"fe.{feature}.{int(gather)}"] = fe(wav).numpy()
    if "lstm" in inputs:
        gen = torch.Generator().manual_seed(0)
        x_full, m_full = inputs["x"], inputs["mask"]
        params = BiLSTMParams(x_full.shape[-1], inputs["hidden"], gen, "cpu")
        load_pytree(params, inputs["lstm"])
        for p in params.parameters():
            p.requires_grad_(True)
        tl = x_full.shape[1] // n
        x = _t(x_full[:, d * tl:(d + 1) * tl]).requires_grad_(True)
        m = _t(m_full[:, d * tl:(d + 1) * tl])
        y = make_sp_bilstm(mesh, axis="seq")(params, x, m)
        (y * _t(inputs["probe"][:, d * tl:(d + 1) * tl])).sum().backward()
        out["lstm.out"] = y.detach().numpy()
        out["lstm.dx"] = x.grad.numpy()
        for k, p in params.named_parameters():
            out[f"lstm.d.{k}"] = p.grad.numpy()
    if "ring" in inputs:
        gen = torch.Generator().manual_seed(0)
        att = BiDAFParams(inputs["c"].shape[-1], gen, "cpu")
        load_pytree(att, inputs["ring"])
        for drop in (False, True):
            for p in att.parameters():
                p.grad = None
                p.requires_grad_(True)
            c = _t(inputs["c"]).requires_grad_(True)
            q = _t(inputs["q"]).requires_grad_(True)
            shard = lambda t: shard_seq(t, mesh, "seq")  # noqa: E731
            args = [shard(c), shard(q)]
            if drop:
                args += [shard(c * _t(inputs["c_keep"])), shard(q * _t(inputs["q_keep"]))]
            args += [shard(_t(inputs["cm"])), shard(_t(inputs["qm"]))]
            g = make_ring_bidaf(mesh, axis="seq", dropout=drop)(att, *args)
            (g * shard(_t(inputs["probe_ring"]))).sum().backward()
            out[f"ring.{int(drop)}.out"] = g.detach().numpy()
            out[f"ring.{int(drop)}.dc"] = c.grad.numpy()  # the rank's share of the gradient
            out[f"ring.{int(drop)}.dq"] = q.grad.numpy()
            for k, p in att.named_parameters():
                out[f"ring.{int(drop)}.d.{k}"] = p.grad.numpy()
    return out


def case_tp_frontend(inputs):
    """``apply_frontend`` with the VGG classifier split over ``model``."""
    import torch

    from mmbidaf_tpu_torch.config import MeshConfig
    from mmbidaf_tpu_torch.data.frontend import apply_frontend
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.parallel.mesh import make_mesh, shard_frontend

    cfg = _port_cfg(inputs["cfg"])
    mesh = make_mesh(MeshConfig(**inputs["mesh"]), "cpu")
    fe = shard_frontend(frontend_from_jax(inputs["fe"], cfg, TINY_SPEC, "cpu"), mesh, True)
    raw = {k: _t(v) for k, v in inputs["raw"].items()}
    with torch.inference_mode():
        feats = apply_frontend(fe, raw, cfg, TINY_SPEC)
    return {"images": feats["images"].numpy(), "fc1_w": np.array(fe.vgg.fc1_w.shape),
            "fc2_w": np.array(fe.vgg.fc2_w.shape)}


def case_train(inputs):
    """Two train steps from the JAX weights on this rank's rows of the
    global batch (features, or raw with the frontend and the SP tower)."""
    from mmbidaf_tpu_torch.config import MeshConfig
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, train_state_from_jax
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_frontend
    from mmbidaf_tpu_torch.train import loop

    cfg = _port_cfg(inputs["cfg"])
    mesh = make_mesh(MeshConfig(**inputs["mesh"]), "cpu")
    state = train_state_from_jax(inputs["params"], inputs["params"], cfg, device="cpu")
    frontend = g_fn = None
    if "fe" in inputs:
        frontend = shard_frontend(frontend_from_jax(inputs["fe"], cfg, TINY_SPEC, "cpu"), mesh,
                                  cfg.mesh.tp_vgg)
    if cfg.mesh.sp_audio:
        from mmbidaf_tpu_torch.parallel.sp_tower import make_sp_audio_tower

        g_fn = make_sp_audio_tower(mesh, cfg)
    step = loop.make_train_step(cfg, frontend, TINY_SPEC, mesh=mesh, audio_g_fn=g_fn)
    batch = shard_batch(inputs["batch"], mesh)
    out = {}
    for i in range(2):
        state, m = step(state, batch)
        out[f"loss{i}"] = np.array(float(m["loss"]))
        out[f"grad_norm{i}"] = np.array(float(m["grad_norm"]))
    for k, v in state.params.state_dict().items():
        out[f"p.{k}"] = v.detach().numpy()
    return out


def case_serve(inputs):
    """Greedy (and, where asked, beam and top-k) picks of a ``Summarizer``
    under the mesh layout, on one global raw batch."""
    from mmbidaf_tpu_torch.config import MeshConfig
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = _port_cfg(inputs["cfg"])
    cfg = dataclasses.replace(cfg, mesh=MeshConfig(**inputs["mesh"]))
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    out = {}
    for mode in inputs["modes"]:
        s = Summarizer.from_jax_params(inputs["params"], inputs["fe"], w2i, cfg, TINY_SPEC,
                                       device="cpu", mode=mode, seed=3,
                                       data_parallel=inputs["dp"],
                                       serve_batch_size=len(inputs["raw"]["sent_mask"]))
        picks, scores = s._decode_batch(s._to_device(inputs["raw"]), with_scores=True)
        log_p, _ = s._decode_batch_device(s._to_device(inputs["raw"]))
        out[f"{mode}.picks"], out[f"{mode}.log_p"] = picks, log_p.numpy()
    return out


def case_cli(inputs):
    """``train.cli.main`` under the group (rank 0 writes the run)."""
    from mmbidaf_tpu_torch.train import cli

    cli.main(inputs["args"])
    return {}


CASES = {f.__name__[5:]: f for f in (case_mesh, case_sp_pieces, case_tp_frontend, case_train,
                                     case_serve, case_cli)}


def spawn(tmp_dir: str, world: int, plan: list, timeout: float = GROUP_TIMEOUT) -> list[list]:
    """Run ``plan`` in a gloo group of ``world`` processes of this file."""
    return torch_group.spawn(__file__, tmp_dir, world, plan, timeout)


if __name__ == "__main__":
    if len(sys.argv) == 7 and sys.argv[1] == "worker":
        sys.path.insert(0, REPO)
        torch_group.worker_main(CASES, sys.argv[2:])
        sys.exit(0)
    raise SystemExit("usage: test_torch_parallel.py worker RANK WORLD STORE PLAN OUT_DIR")


# ---------------------------------------------------------------------------
# The pytest side: inputs, the JAX references and the comparisons.
# ---------------------------------------------------------------------------

import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from mmbidaf_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from mmbidaf_tpu.config import tiny_test_config  # noqa: E402
from mmbidaf_tpu.data.frontend import apply_frontend as j_apply_frontend  # noqa: E402
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init  # noqa: E402
from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end  # noqa: E402
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch  # noqa: E402
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init  # noqa: E402
from mmbidaf_tpu.ops.audio import make_audio_frontend_consts as j_consts  # noqa: E402
from mmbidaf_tpu.ops.bidaf import bidaf_init as j_bidaf_init  # noqa: E402
from mmbidaf_tpu.ops.lstm import bilstm_init as j_bilstm_init  # noqa: E402
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY  # noqa: E402
from mmbidaf_tpu.parallel import mesh as j_mesh  # noqa: E402
from mmbidaf_tpu.parallel.audio_sp import make_sp_audio_frontend as j_sp_frontend  # noqa: E402
from mmbidaf_tpu.parallel.ring_attention import make_ring_bidaf as j_ring  # noqa: E402
from mmbidaf_tpu.parallel.sp_lstm import make_sp_bilstm as j_sp_lstm  # noqa: E402
from mmbidaf_tpu.train import loop as j_loop  # noqa: E402
from mmbidaf_tpu_torch.config import MeshConfig  # noqa: E402
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
FEAT = dict(rtol=2e-5, atol=2e-4)  # MFCCs reach ~100 (tests/test_torch_ops.py's bound)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(kernels=False, mesh=None, **model):
    """The tiny config (11 audio frames padded to 12 so 2 and 4 divide them)."""
    cfg = tiny_test_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc,
            use_pallas_lstm=kernels, use_pallas_attention=kernels, use_pallas_melspec=kernels,
            **model),
        data=dataclasses.replace(cfg.data, max_audio_frames=12),
        mesh=mesh or JMeshConfig())


def _cfg_dict(cfg):
    return dataclasses.asdict(cfg)


def _jmesh(n, names):
    return JMesh(np.asarray(jax.devices()[:int(np.prod(n))]).reshape(n), names)


def _raw_batch(cfg, B, seed=5, frame_hw=(12, 16)):
    rng = np.random.default_rng(seed)
    d = cfg.data
    base = synthetic_batch(rng, cfg, batch_size=B)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask",
                                "targets", "target_mask")}
    raw["frames"] = (rng.random((B, d.max_keyframes, *frame_hw, 3)) * 255).astype(np.uint8)
    n = d.max_audio_frames * d.hop_length + d.win_length
    raw["waveform"] = (rng.standard_normal((B, n)) * 0.1).astype(np.float32)
    raw["waveform"][1] = 0.0  # a silent track
    raw["aud_mask"][2 % B, 5:] = 0.0  # a short one
    return raw


def _weights(cfg, seed=2):
    rng = np.random.default_rng(seed)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(seed), cfg, jnp.asarray(wv))
    fe = j_frontend_init(jax.random.key(seed + 1), cfg, vgg_spec=J_TINY)
    return params, fe


def _ragged(rng, B, T):
    lens = rng.integers(1, T + 1, size=B)
    lens[0], lens[-1] = T, 0  # a full row and a zero-length row
    return (np.arange(T)[None] < lens[:, None]).astype(np.float32)


def _sp_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    d = cfg.data
    B, T, Din, H = 3, 8, 6, 5
    inp = {"n": n}
    n_samples = d.max_audio_frames * d.hop_length + d.win_length
    inp["waveform"] = (rng.standard_normal((B, n_samples)) * 0.1).astype(np.float32)
    inp["waveform"][1] = 0.0
    inp["audio"] = dict(sample_rate=d.sample_rate, n_fft=d.n_fft, win=d.win_length,
                        hop=d.hop_length, n_mels=d.n_mels, n_mfcc=d.n_mfcc, fmin=d.fmin,
                        fmax=d.fmax, frames=d.max_audio_frames)
    inp["lstm"] = _np(j_bilstm_init(jax.random.key(3), Din, H))
    inp["hidden"] = H
    inp["x"] = rng.standard_normal((B, T, Din)).astype(np.float32)
    inp["mask"] = _ragged(rng, B, T)
    inp["probe"] = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    Tc, Tq, D = 7, 8, 4
    inp["ring"] = _np(j_bidaf_init(jax.random.key(4), D))
    inp["c"] = rng.standard_normal((B, Tc, D)).astype(np.float32)
    inp["q"] = rng.standard_normal((B, Tq, D)).astype(np.float32)
    inp["cm"], inp["qm"] = _ragged(rng, B, Tc), _ragged(rng, B, Tq)
    inp["c_keep"] = ((rng.random((B, Tc, D)) < 0.8) / 0.8).astype(np.float32)
    inp["q_keep"] = ((rng.random((B, Tq, D)) < 0.8) / 0.8).astype(np.float32)
    inp["probe_ring"] = rng.standard_normal((B, Tc, 4 * D)).astype(np.float32)
    return inp


def _ring_only(inp):
    return {k: v for k, v in inp.items() if k not in ("waveform", "audio", "lstm")}


MESHES_2 = [dict(num_data=2), dict(num_dcn=2, num_data=1), dict(num_data=1, num_seq=2),
            dict(num_data=1, num_model=2, tp_vgg=True), dict()]
MESHES_4 = [dict(num_data=4), dict(num_dcn=2, num_data=2), dict(num_data=2, num_seq=2),
            dict(num_data=2, num_model=2), dict(num_seq=2, num_model=2), dict(num_seq=4)]


@pytest.fixture(scope="module")
def weights():
    cfg = _cfg()
    return _weights(cfg)


def _train_inputs(mesh_kw, raw: bool, weights, B=4):
    cfg = _cfg(mesh=JMeshConfig(**mesh_kw))
    params, fe = weights
    if raw:
        batch = _raw_batch(cfg, B)
    else:
        batch = synthetic_batch(np.random.default_rng(7), cfg, batch_size=B)
    batch["target_mask"][1, -1] = 0.0  # unequal valid-step counts across ranks
    inp = {"cfg": _cfg_dict(cfg), "mesh": mesh_kw, "params": _np(params), "batch": batch}
    if raw:
        inp["fe"] = _np(fe)
    return inp


def _serve_inputs(mesh_kw, dp, weights, modes=("greedy",), B=4):
    cfg = _cfg(mesh=JMeshConfig(**mesh_kw))
    params, fe = weights
    raw = _raw_batch(cfg, B, seed=9)
    raw = {k: v for k, v in raw.items() if k not in ("targets", "target_mask")}
    return {"cfg": _cfg_dict(cfg), "mesh": mesh_kw, "params": _np(params), "fe": _np(fe),
            "raw": raw, "dp": dp, "modes": list(modes)}


@pytest.fixture(scope="module")
def group2(tmp_path_factory, weights):
    """Every world-size-2 case, in one gloo group."""
    cfg = _cfg()
    params, fe = weights
    plan = [
        ("mesh", {"meshes": MESHES_2}),
        ("sp_pieces", _sp_inputs(2)),
        ("tp_frontend", {"cfg": _cfg_dict(cfg), "mesh": dict(num_data=1, num_model=2,
                                                             tp_vgg=True),
                         "fe": _np(fe), "raw": _raw_batch(cfg, 3)}),
        ("train", _train_inputs(dict(num_data=2), False, weights)),
        ("serve", _serve_inputs(dict(num_data=2), True, weights, ("greedy", "beam", "topk"))),
    ]
    return plan, spawn(str(tmp_path_factory.mktemp("group2")), 2, plan)


@pytest.fixture(scope="module")
def group4(tmp_path_factory, weights):
    """Every world-size-4 case, in one gloo group."""
    plan = [
        ("mesh", {"meshes": MESHES_4}),
        ("sp_pieces", _ring_only(_sp_inputs(4))),
        ("train", _train_inputs(dict(num_dcn=2, num_data=2), False, weights)),
        ("train", _train_inputs(dict(num_data=2, num_seq=2, sp_audio=True), True, weights)),
        ("serve", _serve_inputs(dict(num_data=2, num_seq=2, sp_audio=True), True, weights)),
        ("serve", _serve_inputs(dict(num_data=1, num_seq=2, sp_audio=True, num_model=2,
                                     tp_vgg=True), False, weights)),
        ("serve", _serve_inputs(dict(num_data=2, num_model=2, tp_vgg=True), True, weights)),
    ]
    return plan, spawn(str(tmp_path_factory.mktemp("group4")), 4, plan)


# -- the mesh ---------------------------------------------------------------


def _check_mesh(meshes, ranks, world):
    for i, kw in enumerate(meshes):
        jm = j_mesh.make_mesh(JMeshConfig(**kw), jax.devices()[:world])
        for r, res in enumerate(ranks):
            assert tuple(res[f"{i}.names"]) == tuple(jm.axis_names), kw
            assert tuple(res[f"{i}.shape"]) == tuple(jm.shape[a] for a in jm.axis_names), kw
            # rank r is device r of the JAX mesh, row-major
            coords = np.argwhere(np.asarray(jm.devices) == jax.devices()[r])[0]
            np.testing.assert_array_equal(res[f"{i}.coords"], coords, err_msg=str(kw))
            assert int(res[f"{i}.shards"]) == j_mesh.data_shard_count(jm)
        # each rank's rows are the rows its JAX device holds of a batch of 8
        sh = j_mesh.batch_sharding(jm)
        idx = sh.devices_indices_map((8,))
        for r, res in enumerate(ranks):
            sl = idx[jax.devices()[r]][0]
            start, stop, _ = sl.indices(8)
            np.testing.assert_array_equal(res[f"{i}.rows"], (start, stop), err_msg=str(kw))
            np.testing.assert_array_equal(res[f"{i}.local"], np.arange(start, stop))


def test_mesh_axes_coords_and_rows_match_jax_at_2(group2):
    """``make_mesh`` names, shapes and rank coordinates, the data shard count
    and each rank's batch rows, against ``mmbidaf_tpu.parallel.mesh`` on the
    same number of devices (rank r = device r)."""
    plan, res = group2
    _check_mesh(MESHES_2, res[0], 2)


def test_mesh_axes_coords_and_rows_match_jax_at_4(group4):
    plan, res = group4
    _check_mesh(MESHES_4, res[0], 4)


def test_make_mesh_errors_match_jax():
    """The JAX package's checks, at world size 1 (no process group)."""
    from mmbidaf_tpu_torch.parallel.mesh import make_mesh

    for kw, match in ((dict(seq_axis="frames"), "seq_axis"), (dict(model_axis="tp"), "model_axis"),
                      (dict(num_data=2), "needs 2 devices, have 1"),
                      (dict(num_seq=2), "num_dcn\\*num_seq\\*num_model = 2")):
        with pytest.raises(ValueError, match=match):
            make_mesh(MeshConfig(**kw), "cpu")
        with pytest.raises(ValueError, match=match):
            j_mesh.make_mesh(JMeshConfig(**kw), jax.devices()[:1])
    mesh = make_mesh(MeshConfig(), "cpu")
    assert mesh.axis_names == ("data",) and mesh.group("data") is None
    from mmbidaf_tpu_torch.parallel.mesh import local_batch_rows

    assert local_batch_rows(mesh, 8) is None  # one process holds every row


def test_shard_batch_rows_and_replication():
    from mmbidaf_tpu_torch.parallel.mesh import Mesh, shard_batch

    # rank 3 of a 2 x 2 (data x seq) mesh: data index 1, rows [2, 4) of 4
    mesh = Mesh(("data", "seq"), (2, 2), 3, torch.device("cpu"))
    batch = {"a": np.arange(8).reshape(4, 2), "b": np.arange(3)}
    with pytest.warns(UserWarning, match="does not divide"):
        out = shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["a"].numpy(), batch["a"][2:4])
    np.testing.assert_array_equal(out["b"].numpy(), batch["b"])  # kept whole


def test_shard_frontend_errors_match_jax(weights):
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.parallel.mesh import Mesh, shard_frontend

    cfg = _cfg()
    fe = frontend_from_jax(_np(weights[1]), cfg, TINY_SPEC, "cpu")
    with pytest.raises(ValueError, match="num_model > 1"):
        shard_frontend(fe, Mesh(("data",), (2,), 0, torch.device("cpu")), tp_vgg=True)
    with pytest.raises(ValueError, match="must divide fc_dim 32"):
        shard_frontend(fe, Mesh(("data", "model"), (1, 3), 0, torch.device("cpu")), tp_vgg=True)
    from mmbidaf_tpu_torch.data.frontend import frontend_init

    no_img = _port_cfg(_cfg_dict(_cfg(use_images=False)))
    with pytest.raises(ValueError, match="no 'vgg' params"):
        shard_frontend(frontend_init(no_img, TINY_SPEC, "cpu"),
                       Mesh(("data", "model"), (1, 2), 0, torch.device("cpu")), tp_vgg=True)


# -- the SP pieces ----------------------------------------------------------


def _gather(ranks, key, axis=1):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _check_sp_frontend(inp, ranks):
    a, n = inp["audio"], inp["n"]
    consts = j_consts(a["sample_rate"], a["n_fft"], a["win"], a["n_mels"], a["n_mfcc"],
                      a["fmin"], a["fmax"])
    jm = _jmesh((n,), ("seq",))
    wav = jnp.asarray(inp["waveform"])
    for feature in ("mfcc", "logmel"):
        ref = np.asarray(j_sp_frontend(jm, consts, a["win"], a["hop"], a["frames"],
                                       feature=feature, axis="seq", gather=False)(wav))
        np.testing.assert_allclose(_gather(ranks, f"fe.{feature}.0"), ref, **FEAT)
        for r in ranks:  # gathered: every rank holds the whole axis
            np.testing.assert_allclose(r[f"fe.{feature}.1"], ref, **FEAT)


def _check_sp_lstm(inp, ranks):
    n = inp["n"]
    jm = _jmesh((n,), ("seq",))
    sp = j_sp_lstm(jm, axis="seq")
    x, mask, probe = (jnp.asarray(inp[k]) for k in ("x", "mask", "probe"))

    def loss(p, x):
        return jnp.sum(sp(p, x, mask) * probe)

    ref = np.asarray(sp(inp["lstm"], x, mask))
    np.testing.assert_allclose(_gather(ranks, "lstm.out"), ref, **F32)
    assert not np.any(_gather(ranks, "lstm.out")[-1])  # the zero-length row
    gp, gx = jax.grad(loss, argnums=(0, 1))(inp["lstm"], x)
    np.testing.assert_allclose(_gather(ranks, "lstm.dx"), np.asarray(gx), **GRAD)
    for k, g in flatten_pytree(_np(gp)).items():
        np.testing.assert_allclose(sum(r[f"lstm.d.{k}"] for r in ranks), g, **GRAD, err_msg=k)


def _check_ring(inp, ranks, grads=True):
    n = inp["n"]
    jm = _jmesh((n,), ("seq",))
    Tc = inp["c"].shape[1]
    c, q, cm, qm, probe = (jnp.asarray(inp[k]) for k in ("c", "q", "cm", "qm", "probe_ring"))
    for drop in (False, True):
        ring = j_ring(jm, axis="seq", dropout=drop)
        keep_c, keep_q = jnp.asarray(inp["c_keep"]), jnp.asarray(inp["q_keep"])

        def fn(p, c, q):
            if drop:
                return ring(p, c, q, c * keep_c, q * keep_q, cm, qm)
            return ring(p, c, q, cm, qm)

        ref = np.asarray(fn(inp["ring"], c, q))
        out = _gather(ranks, f"ring.{int(drop)}.out")[:, :Tc]
        np.testing.assert_allclose(out, ref, **F32)
        if not grads:
            continue
        gp, gc, gq = jax.grad(lambda p, c, q: jnp.sum(fn(p, c, q) * probe),
                              argnums=(0, 1, 2))(inp["ring"], c, q)
        np.testing.assert_allclose(sum(r[f"ring.{int(drop)}.dc"] for r in ranks), np.asarray(gc),
                                   **GRAD)
        np.testing.assert_allclose(sum(r[f"ring.{int(drop)}.dq"] for r in ranks), np.asarray(gq),
                                   **GRAD)
        for k, g in flatten_pytree(_np(gp)).items():
            got = sum(r[f"ring.{int(drop)}.d.{k}"] for r in ranks)
            np.testing.assert_allclose(got, g, atol=1e-4, rtol=1e-4, err_msg=k)


def test_sp_frontend_matches_jax_at_2(group2):
    """Frame-sharded MFCC and log-mel (the dB reference a max over the
    ranks) and the gathered variant against JAX's ``make_sp_audio_frontend``."""
    plan, res = group2
    _check_sp_frontend(plan[1][1], res[1])


def test_sp_bilstm_matches_jax_at_2(group2):
    """The wavefront's outputs (ragged rows, a zero-length row) and the
    gradients of its custom backward against JAX's ``make_sp_bilstm``."""
    plan, res = group2
    _check_sp_lstm(plan[1][1], res[1])


@pytest.mark.parametrize("world", [2, 4])
def test_ring_bidaf_matches_jax(world, group2, group4):
    """Both ring passes, lean and dropout, against JAX's ``make_ring_bidaf``
    (T_c=7 padded to the ring, ragged masks and a fully masked row): the
    outputs at 2 and 4 ranks, the gradients of the hops' backward at 2."""
    plan, res = group2 if world == 2 else group4
    _check_ring(plan[1][1], res[1], grads=world == 2)


# -- tensor parallelism -----------------------------------------------------


def test_tp_frontend_matches_replicated_jax(group2, weights):
    """fc1 column- / fc2 row-parallel over ``model`` (each rank holds half)
    against JAX's replicated ``apply_frontend``."""
    plan, res = group2
    inp = plan[2][1]
    cfg = _cfg()
    ref = j_apply_frontend(weights[1], {k: jnp.asarray(v) for k, v in inp["raw"].items()}, cfg,
                           J_TINY)["images"]
    for r in res[2]:
        np.testing.assert_allclose(r["images"], np.asarray(ref), **F32)
        assert tuple(r["fc1_w"]) == (weights[1]["vgg"]["fc1_w"].shape[0], 16)
        assert tuple(r["fc2_w"]) == (16, 32)


# -- data-parallel training ---------------------------------------------------


_JAX_CACHE: dict = {}


def _jax_train(inp, raw):
    """JAX's two steps on the global batch (cached: cases share inputs)."""
    key = ("train", raw)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = _jax_train_uncached(inp, raw)
    return _JAX_CACHE[key]


def _jax_train_uncached(inp, raw):
    cfg = _cfg(mesh=JMeshConfig())
    params = jax.tree.map(jnp.asarray, inp["params"])
    fe = jax.tree.map(jnp.asarray, inp["fe"]) if raw else None
    state = j_loop.init_train_state(jax.random.key(1), params, cfg)
    step = j_loop.make_train_step(cfg, fe_params=fe, vgg_spec=J_TINY if raw else None)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    losses = []
    for i in range(2):
        state, m = step(state, batch)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return losses, flatten_pytree(_np(state.params))


def _check_train(inp, ranks, raw):
    losses, flat = _jax_train(inp, raw)
    for r in ranks:
        for i, (loss, gn) in enumerate(losses):
            np.testing.assert_allclose(float(r[f"loss{i}"]), loss, rtol=1e-5)
            np.testing.assert_allclose(float(r[f"grad_norm{i}"]), gn, rtol=1e-5)
        for k, v in flat.items():
            np.testing.assert_allclose(r[f"p.{k}"], v, atol=1e-6, err_msg=k)


def test_dp_train_step_matches_jax_at_data2(group2):
    """Two drop-0 steps at ``data=2`` (unequal valid-step counts across the
    ranks) against JAX's step on the global batch: loss, grad norm, every
    parameter."""
    plan, res = group2
    _check_train(plan[3][1], res[3], raw=False)


def test_dp_train_step_matches_jax_at_dcn2_data2(group4):
    """The multi-host layout: ``dcn=2 × data=2``."""
    plan, res = group4
    _check_train(plan[2][1], res[2], raw=False)


def test_dp_sp_train_step_matches_jax(group4):
    """DP × SP (``data=2 × seq=2``, ``sp_audio``) on a raw batch through the
    frozen frontend, against JAX's step on the global batch without a mesh
    (the plain chain, whose MFCC is the SP frontend's matmul DFT)."""
    plan, res = group4
    _check_train(plan[3][1], res[3], raw=True)


# -- serving ------------------------------------------------------------------


def _jax_greedy(inp, weights):
    """JAX's greedy decode of the whole batch (cached: cases share inputs)."""
    if "greedy" not in _JAX_CACHE:
        cfg = _cfg(mesh=JMeshConfig())
        params, fe = weights
        raw = {k: jnp.asarray(v) for k, v in inp["raw"].items()}
        _JAX_CACHE["greedy"] = _np(j_end_to_end(cfg, vgg_spec=J_TINY)(params, fe, raw))
    return _JAX_CACHE["greedy"]


def _check_serve(inp, ranks, weights):
    log_p, picks = _jax_greedy(inp, weights)
    for r in ranks:  # every rank holds every row's answer
        np.testing.assert_array_equal(r["greedy.picks"], picks)
        np.testing.assert_allclose(r["greedy.log_p"], log_p, **F32)


def test_dp_serving_matches_jax_at_data2(group2, weights):
    """``Summarizer(data_parallel=True)``: greedy picks against JAX's decode
    of the whole batch."""
    plan, res = group2
    _check_serve(plan[4][1], res[4], weights)


@pytest.mark.parametrize("mode", ["beam", "topk"])
def test_dp_beam_and_topk_match_single_process(mode, group2, weights):
    """Beam and top-k under DP equal one process's decode of the whole batch
    (beam is held to JAX's in ``tests/test_torch_decode_modes.py``); top-k
    draws its noise for the whole batch and keeps its rows."""
    plan, res = group2
    out = case_serve(dict(plan[4][1], dp=False, modes=[mode]))
    for r in res[4]:
        np.testing.assert_array_equal(r[f"{mode}.picks"], out[f"{mode}.picks"])
        np.testing.assert_allclose(r[f"{mode}.log_p"], out[f"{mode}.log_p"], **F32)


@pytest.mark.parametrize("layout", ["dp_sp", "sp_tp", "dp_tp"])
def test_mesh_serving_matches_jax_at_4(layout, group4, weights):
    """Greedy picks under DP × SP (``data=2 × seq=2``), SP × TP (``seq=2 ×
    model=2``) and DP × TP (``data=2 × model=2``) against JAX's decode."""
    plan, res = group4
    i = {"dp_sp": 4, "sp_tp": 5, "dp_tp": 6}[layout]
    _check_serve(plan[i][1], res[i], weights)


# -- world size 1, no process group -------------------------------------------


def test_world1_dp_and_tp_serving_equal_the_path_without_a_mesh(weights):
    """At world size 1 without a process group, ``data_parallel`` and
    ``tp_vgg`` at ``num_model=1`` run the same code with their collectives
    skipped: log-probs and picks bit for bit those of the plain Summarizer."""
    inp = _serve_inputs(dict(), False, weights, ("greedy", "topk"))
    plain = case_serve(inp)
    for mesh_kw, dp in ((dict(num_data=1), True), (dict(num_data=1, num_model=1, tp_vgg=True),
                                                   True)):
        out = case_serve(dict(inp, mesh=mesh_kw, dp=dp))
        for k, v in plain.items():
            np.testing.assert_array_equal(out[k], v, err_msg=f"{mesh_kw} {k}")


def test_world1_train_step_equals_the_step_without_a_mesh(weights):
    """A mesh at world size 1: two steps at drop 0.2 bit for bit the steps
    without one (the dropout masks drawn alike)."""
    from mmbidaf_tpu_torch.interop.from_jax import train_state_from_jax
    from mmbidaf_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from mmbidaf_tpu_torch.train import loop

    cfg = _port_cfg(_cfg_dict(_cfg(drop_prob=0.2)))
    batch = synthetic_batch(np.random.default_rng(7), _cfg(), batch_size=4)
    params = {}
    for mesh in (None, make_mesh(MeshConfig(num_data=1), "cpu")):
        state = train_state_from_jax(_np(weights[0]), _np(weights[0]), cfg, device="cpu", seed=4)
        step = loop.make_train_step(cfg, mesh=mesh)
        tb = shard_batch(batch, mesh) if mesh else {k: _t(v) for k, v in batch.items()}
        for _ in range(2):
            state, _ = step(state, tb)
        params[mesh is None] = state.params.state_dict()
    for k, v in params[True].items():
        assert torch.equal(params[False][k], v), k


def test_world1_sp_tower_at_num_seq_1(weights):
    """``sp_audio`` at ``num_seq=1`` on one process: the SP BiLSTM is the plain
    scan bit for bit, and the tower's decode picks equal the path without a
    mesh (the ring's flash softmax sums in another order: log-probs to
    ``atol=1e-5``)."""
    from mmbidaf_tpu_torch.interop.from_jax import load_pytree
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams, bilstm_apply
    from mmbidaf_tpu_torch.parallel.mesh import make_mesh
    from mmbidaf_tpu_torch.parallel.sp_lstm import make_sp_bilstm

    inp = _sp_inputs(1)
    params = BiLSTMParams(6, 5, torch.Generator().manual_seed(0), "cpu")
    load_pytree(params, inp["lstm"])
    mesh = make_mesh(MeshConfig(num_data=1, num_seq=1, sp_audio=True), "cpu")
    x, m = _t(inp["x"]), _t(inp["mask"])
    assert torch.equal(make_sp_bilstm(mesh, axis="seq")(params, x, m), bilstm_apply(params, x, m)[0])
    serve = _serve_inputs(dict(), False, weights)
    plain = case_serve(serve)
    sp = case_serve(dict(serve, mesh=dict(num_seq=1, sp_audio=True)))
    np.testing.assert_array_equal(sp["greedy.picks"], plain["greedy.picks"])
    np.testing.assert_allclose(sp["greedy.log_p"], plain["greedy.log_p"], **F32)
