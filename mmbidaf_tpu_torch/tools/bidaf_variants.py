"""K7 and K8 (the cluster-split training BiDAF pair) against variants of
their design, on one card: the evidence behind the choices of
``csrc/bidaf_cluster.cuh`` and ``csrc/bidaf_bwd.cu``.

Variants, each built from a copy of ``csrc/`` with one change
(``bidaf.cu`` and ``bidaf_bwd.cu`` only, with ``nvcc`` into
``mmbidaf_tpu_torch/_build/variants/``):

- ``threads``: K7 at 512 threads a block and K8 at 256 (the sources use
  256 and 512);
- ``tile64``: q tiles of 64 columns where T_q allows (the sources: 32), so
  clusters of 8 blocks at T_q=512;
- ``rs_identity``: K8 takes rs = rowsum(d_s_row∘s_row) from the identity
  ``rowsum(d_a∘a) + rowsum(E∘P)`` (d_a·a over each rank's D columns, summed
  in rank order) instead of from the tiles' row sums of d_s_row∘s_row.

Each runs at the ``bench_train.py --pallas`` attention shapes (B=32,
T_c=32, D=256, T_q=16 and 512) on unit-normal inputs with drop 0.2,
against the plain versions: max abs error per output and the CUDA-event
time of one call (the median of five means of 20 calls).

    python -m mmbidaf_tpu_torch.tools.bidaf_variants [--out F]

Needs an NVIDIA GPU with ``nvcc``; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from mmbidaf_tpu_torch.ops.common import dropout_mask
from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
from mmbidaf_tpu_torch.ops.cuda import build

SHAPES = ((32, 32, 16, 256), (32, 32, 512, 256))  # (B, T_c, T_q, D)

# rs by the identity: d_a·a on this rank's D columns in place of the tile's
# row sums of d_s_row∘s_row, and rowsum(E∘P) added once the ranks' parts
# are summed.
_RS_TILE = """  for (int i = warp; i < Tc; i += nwarps) {
    float v = 0.0f;
    for (int j = lane; j < nj; j += 32) v = fmaf(ss[i * LQ + j], sr[i * LQ + j], v);
    v = mmb::warp_sum(v);
    if (lane == 0) rsq[i] = v;
  }"""
_RS_IDENTITY = """  for (int i = warp; i < Tc; i += nwarps) {
    float v = 0.0f;
    for (int dd = lane; dd < nd; dd += 32) {
      float a = 0.0f;
      for (int J = 0; J < C; ++J)
        a = fmaf(wts[J * Tc + i], cluster.map_shared_rank(x, J)[i * LD + d0 + dd], a);
      v = fmaf(da[i * LD + d0 + dd], a, v);
    }
    v = mmb::warp_sum(v);
    if (lane == 0) rsq[i] = v;
  }"""
_RS_SUM = """    for (int J = 0; J < C; ++J) v += cluster.map_shared_rank(rsq, J)[i];
    rs[i] = v;"""
_RS_SUM_IDENTITY = """    for (int J = 0; J < C; ++J) v += cluster.map_shared_rank(rsq, J)[i];
    for (int k = 0; k < Tc; ++k) v = fmaf(e_s[i * LT + k], pf[i * LT + k], v);
    rs[i] = v;"""

VARIANTS = {
    "threads": {"bidaf_cluster.cuh": [("kThreadsFwd = 256", "kThreadsFwd = 512"),
                                      ("kThreadsBwd = 512", "kThreadsBwd = 256")]},
    "tile64": {"bidaf_cluster.cuh": [("kTargetTile = 32", "kTargetTile = 64")]},
    "rs_identity": {"bidaf_bwd.cu": [(_RS_TILE, _RS_IDENTITY), (_RS_SUM, _RS_SUM_IDENTITY)]},
}
_ENTRIES = ("mmb_bidaf_forward_dropout", "mmb_bidaf_backward")


def build_variant(name: str) -> ctypes.CDLL:
    """The variant's K7 and K8 in a library of their own."""
    out = build.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for fname, edits in VARIANTS[name].items():
        text = (out / fname).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {fname} does not hold the text to replace once")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    lib_path = out / "lib.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
           str(out / "bidaf.cu"), str(out / "bidaf_bwd.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for entry in _ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = list(build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
    return lib


def _events_ms(fn, iters: int = 20, reps: int = 5) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _operands(shape, rng, gen, dev):
    B, T_c, T_q, D = shape

    def normal(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

    def mask(n, t):
        lengths = rng.integers(0, t + 1, size=n)
        lengths[0], lengths[1] = t, 0
        return torch.from_numpy((np.arange(t)[None] < lengths[:, None]).astype(np.float32)).to(dev)

    c, q = normal(B, T_c, D), normal(B, T_q, D)
    cd = c * dropout_mask(c.shape, 0.2, gen, dev)
    qd = q * dropout_mask(q.shape, 0.2, gen, dev)
    ops = (c, q, cd, qd, mask(B, T_c), mask(B, T_q), normal(D) * 0.1, normal(D) * 0.1,
           normal(D) * 0.1, torch.tensor(0.25, device=dev))
    return ops, normal(B, T_c, 4 * D)


def measure(name: str, lib, shape, ops, g) -> dict:
    """One variant (``lib`` None: the checkout's kernels through their
    wrappers) at one shape: max abs error per output and the times."""
    B, T_c, T_q, D = shape
    dev = g.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lib is None:
        fwd = lambda: bk.bidaf_dropout_forward(*ops)  # noqa: E731
        bwd = lambda: bk.bidaf_dropout_backward(*ops, g)  # noqa: E731
    else:
        out = torch.empty(B, T_c, 4 * D, device=dev)
        grads = [torch.empty_like(ops[0]), torch.empty_like(ops[1]), torch.empty_like(ops[0]),
                 torch.empty_like(ops[1])]
        partial = torch.empty(B, 3 * D + 1, device=dev)
        d_params = torch.empty(3 * D + 1, device=dev)
        ptrs = [t.data_ptr() for t in ops]

        def fwd():
            build.check_launch(build.library(), lib.mmb_bidaf_forward_dropout(
                *ptrs, out.data_ptr(), B, T_c, T_q, D, stream), name)
            return out

        def bwd():
            build.check_launch(build.library(), lib.mmb_bidaf_backward(
                *ptrs, g.data_ptr(), *(t.data_ptr() for t in grads), partial.data_ptr(),
                d_params.data_ptr(), B, T_c, T_q, D, stream), name)
            return (*grads, d_params[:D], d_params[D:2 * D], d_params[2 * D:3 * D], d_params[3 * D])

    ref7 = bk.bidaf_dropout_reference(*ops)
    ref8 = bk.bidaf_dropout_backward_reference(*ops, g)
    err7 = (fwd() - ref7).abs().max().item()
    err8 = [(o - r).abs().max().item() for o, r in zip(bwd(), ref8)]
    row = {"variant": name, "T_q": T_q, "k7_max_abs_err": err7,
           "k8_max_abs_err": dict(zip(("d_c", "d_q", "d_cd", "d_qd", "dw_c", "dw_q", "dw_cq",
                                       "dbias"), err8)),
           "k7_ms": _events_ms(fwd), "k8_ms": _events_ms(bwd)}
    print(f"{name:12s} T_q={T_q:4d}: K7 {row['k7_ms']:.4f} ms, K8 {row['k8_ms']:.4f} ms; max abs err "
          f"K7 {err7:.2e}, K8 " + " ".join(f"{k}={v:.2e}" for k, v in row["k8_max_abs_err"].items()),
          flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bidaf_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = {"sources": None, **{name: build_variant(name) for name in VARIANTS}}
    rows = []
    for shape in SHAPES:
        rng = np.random.default_rng(21)
        gen = torch.Generator(device=dev).manual_seed(21)
        ops, g = _operands(shape, rng, gen, dev)
        rows += [measure(name, lib, shape, ops, g) for name, lib in libs.items()]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
