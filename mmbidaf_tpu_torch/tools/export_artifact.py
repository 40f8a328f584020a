"""Export a run as a frozen serving artifact (``mmbidaf_tpu_torch.export``) —
the port's counterpart of the repository's ``tools/export_artifact.py``.

    python -m mmbidaf_tpu_torch.tools.export_artifact --run_dir runs/NAME --out artifact/
    python -m mmbidaf_tpu_torch.tools.export_artifact --run_dir ... --out ... --batch 8 --buckets
    python -m mmbidaf_tpu_torch.tools.export_artifact --random --vgg tiny --out artifact/ \\
        --verify --device cpu

The artifact directory then serves without the model-building code:

    from mmbidaf_tpu_torch.export import ExportedSummarizer
    print(ExportedSummarizer("artifact/").summarize(video_dir))

``--device`` (default ``cuda``) is the device the program is traced on and
the only one it loads on (the graph fixes it). ``--random`` builds random
weights from seed 0 at the default widths (``--vgg tiny``: the tiny test
config) with the three serving kernel flags on, so the program runs the
hand kernels; a run keeps its own config and serves its trainer's frozen
frontend (seeded from the run's ``train.seed``). ``--verify``
reloads the artifact and checks every program's picks against the live
``Summarizer`` at that program's shapes. The mesh flags
(``--data_parallel``, ``--tp_vgg``, ``--num_model``) raise
``NotImplementedError``: the port has no mesh layouts yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run_dir", help="a train.cli run directory (config, vocab, ckpts)")
    src.add_argument("--random", action="store_true", help="seeded random weights (smoke, demo)")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--batch", type=int, default=1, help="serving batch fixed in the program")
    ap.add_argument("--mode", choices=["greedy", "beam"], default="greedy",
                    help="decode program to freeze (top-k sampling is interactive only)")
    ap.add_argument("--topk", type=int, default=4, help="beam width for --mode beam")
    ap.add_argument("--frame_hw", default="240x320", help="decoded frame HxW fixed in the program")
    ap.add_argument("--vgg", choices=["vgg16", "vgg19", "tiny"], default=None,
                    help="frontend variant for --random (a run uses its saved one)")
    ap.add_argument("--buckets", action="store_true",
                    help="also freeze one program per quarter/half/full rung level; the loader "
                         "trims short batches to the smallest covering level")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and compare every program's picks with the live "
                         "Summarizer's")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--data_parallel", action="store_true", help="not ported: raises")
    ap.add_argument("--tp_vgg", type=int, choices=[0, 1], default=None, help="not ported: raises")
    ap.add_argument("--num_model", type=int, default=None, help="not ported: raises")
    return ap.parse_args(argv)


def build_summarizer(a):
    """The live Summarizer the artifact freezes."""
    from mmbidaf_tpu_torch.serving import Summarizer

    kw = {"mode": a.mode, "topk": a.topk, "device": a.device}
    if a.run_dir:
        from mmbidaf_tpu_torch.train.checkpoint import load_config

        return Summarizer.from_run(a.run_dir, seed=load_config(a.run_dir).train.seed, **kw)
    from mmbidaf_tpu_torch.config import Config, tiny_test_config
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, spec_for_variant

    flags = dict(use_pallas_lstm=True, use_pallas_attention=True, use_pallas_melspec=True)
    if a.vgg == "tiny":
        cfg = tiny_test_config()
        # the tiny VGG's flattened feature width, and raw audio's MFCC width
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, vgg_variant="tiny", **flags))
        spec = TINY_SPEC
    else:
        variant = a.vgg or "vgg16"
        cfg = Config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vgg_variant=variant,
                                                                 **flags))
        spec = spec_for_variant(variant)
    return Summarizer.init_random(cfg, seed=0, vgg_spec=spec, **kw)


def verify(summ, out: str, batch: int, frame_hw: tuple[int, int]) -> int:
    """Every program of the artifact against the live decode at its shapes,
    on a zero batch with full masks; returns the number of programs."""
    from mmbidaf_tpu_torch.export import ExportedDecoder, _raw_specs

    dec = ExportedDecoder(out, device=summ.device)
    for rungs in [None] + list(dec.bucket_levels):
        raw = {k: (np.ones if k.endswith("_mask") else np.zeros)(s.shape, s.dtype)
               for k, s in _raw_specs(summ.cfg, batch, frame_hw, rungs=rungs).items()}
        _, picks = dec.decode_raw(raw)
        _, live = summ._decode_batch_device(summ._to_device(raw))
        level = "full-cap" if rungs is None else f"rungs {rungs}"
        if not np.array_equal(picks, live.cpu().numpy()):
            raise SystemExit(f"verify FAILED at {level}: exported picks != live picks")
    return 1 + len(dec.bucket_levels)


def main(argv=None) -> None:
    a = parse_args(argv)
    if a.data_parallel or a.tp_vgg is not None or a.num_model is not None:
        raise NotImplementedError("--data_parallel, --tp_vgg and --num_model: the mesh layouts "
                                  "are not ported yet (ROADMAP Queue 1)")
    try:
        h, w = (int(x) for x in a.frame_hw.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--frame_hw wants HxW (e.g. 240x320), got {a.frame_hw!r}") from None
    from mmbidaf_tpu_torch.export import export_summarizer

    summ = build_summarizer(a)
    t0 = time.perf_counter()
    manifest = export_summarizer(summ, a.out, batch_size=a.batch, frame_hw=(h, w),
                                 buckets=a.buckets or None)
    dt = time.perf_counter() - t0
    total = sum(os.path.getsize(os.path.join(a.out, f)) for f in os.listdir(a.out))
    mode_note = f" mode={a.mode}" + (f" (width {a.topk})" if a.mode == "beam" else "")
    n_prog = 1 + len(manifest["bucket_programs"] or [])
    print(f"exported {a.out} ({total / 1e6:.1f} MB, {n_prog} program(s)) in {dt:.1f} s for "
          f"device={manifest['device']} batch={a.batch} frames={h}x{w}{mode_note}", flush=True)
    if a.verify:
        n = verify(summ, a.out, a.batch, (h, w))
        print(f"verify ok: exported picks == live picks ({n} program(s))", flush=True)


if __name__ == "__main__":
    main()
