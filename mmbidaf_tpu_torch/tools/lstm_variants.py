"""K1 (the serving BiLSTM recurrence) against variants of its design, on one
card: the evidence behind the choices of ``csrc/lstm.cu`` and
``csrc/lstm_cluster.cuh`` for serving.

Variants, each built from a copy of ``csrc/`` with one change (compiling
``lstm.cu`` alone, with ``nvcc``, into ``mmbidaf_tpu_torch/_build/variants/``):

- ``k5loop``: K1's product as K5's loop (``#pragma unroll 4`` over k, the
  loads of each k beside its FMAs; the sources issue the loads of 8 k
  ahead of their FMAs; the same sums and bits);
- ``ksplit``: K1's product with each column's k sum split over 4 lanes (8
  apart in the warp, each summing a quarter of k from its own starting
  point, so that the lanes of a warp read 32 banks), joined by two
  shuffles: every thread busy at R = 4, and a chain a quarter as long (the
  sources: one thread a column and four rows, the whole k sum);
- ``pre``: the prefetch's source offsets computed once before the walk
  (the sources: recomputed with two integer divisions each step);
- ``c16``: 8 units a block where the sources take 16, so clusters of 16
  blocks at H = 128 (the whole card's SMs at B = 16);
- ``r8``: 8 rows a cluster below 128 rows (the sources: 4);
- ``stages4``: the gates and mask of a step fetched three steps ahead, in
  four stages (the sources: one step ahead, in two);
- ``l2``: every shape on the L2 route (the design before the cluster);
- ``nosync`` (timing only, wrong by design): the step's cluster barrier
  replaced by a block barrier, so h is read before its writers reach it;
  its time a step against the sources' bounds what the barrier costs;
- ``stamps`` (the sources' arithmetic, instrumented): thread 0 of every
  block reads ``clock64`` at the phases of each step (prefetch issue,
  product, block barrier, gate math and exchange, wait for the prefetch,
  cluster barrier) and the tool prints each phase's mean cycles and
  microseconds a step (at the SM clock ``cudaDevAttrClockRate`` reports).

Each runs on the kernel's own gates (the projection is outside it) at the
serving towers' shapes, H = 128 with unit-normal inputs and ragged rows
(word 2048 x 16, audio 64 x 512, long-audio 16 x 4096): the CUDA-event
time of one call (the median of five means), the time a step, the max abs
error against the plain version and whether it gives the sources' bits.

    python -m mmbidaf_tpu_torch.tools.lstm_variants [--out F] [--only ksplit,stamps] [--gate-scale S]

``--gate-scale`` multiplies the unit-normal gates (default 1), to see
whether the step's time depends on the magnitude of what the gate math
takes.

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

from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk

SHAPES = (("word", 2048, 16), ("audio", 64, 512), ("long-audio", 16, 4096))  # (tag, rows, steps)
H = 128

_K5_LOOP = """#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = w_s[k * ldw + jl];
        const float4 hv = *reinterpret_cast<const float4*>(hb + k * R + r0);
        acc[0] = fmaf(hv.x, w, acc[0]);
        acc[1] = fmaf(hv.y, w, acc[1]);
        acc[2] = fmaf(hv.z, w, acc[2]);
        acc[3] = fmaf(hv.w, w, acc[3]);
      }"""
_K5_PRODUCT = """    // z[:, this block's columns] = gates + h_prev · W_h[:, those columns]
    for (int q = threadIdx.x; q < G4 * (R / lc::kRC); q += blockDim.x) {
      const int jl = q % G4, r0 = (q / G4) * lc::kRC;
      float acc[lc::kRC] = {};
""" + _K5_LOOP + """
#pragma unroll
      for (int i = 0; i < lc::kRC; ++i) z_s[(r0 + i) * G4 + jl] = gs[(r0 + i) * G4 + jl] + acc[i];
    }
"""
# The sources' product: K5's loop, with K1's loads of 8 k issued ahead.
_PRODUCT = """    // z[:, this block's columns] = gates + h_prev · W_h[:, those columns],
    // k ascending. K1 first issues the loads of 8 k at a time ahead of
    // their FMAs (one shared-memory latency per 8 k, not per k or two); the
    // sums are K5's, so are the bits.
    for (int q = threadIdx.x; q < G4 * (R / lc::kRC); q += blockDim.x) {
      const int jl = q % G4, r0 = (q / G4) * lc::kRC;
      float acc[lc::kRC] = {};
      int k = 0;
      if constexpr (!kTrain) {
        for (; k + 8 <= H; k += 8) {
          float w[8];
          float4 hv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            w[i] = w_s[(k + i) * ldw + jl];
            hv[i] = *reinterpret_cast<const float4*>(hb + (k + i) * R + r0);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[0] = fmaf(hv[i].x, w[i], acc[0]);
            acc[1] = fmaf(hv[i].y, w[i], acc[1]);
            acc[2] = fmaf(hv[i].z, w[i], acc[2]);
            acc[3] = fmaf(hv[i].w, w[i], acc[3]);
          }
        }
      }
#pragma unroll 4
      for (; k < H; ++k) {
        const float w = w_s[k * ldw + jl];
        const float4 hv = *reinterpret_cast<const float4*>(hb + k * R + r0);
        acc[0] = fmaf(hv.x, w, acc[0]);
        acc[1] = fmaf(hv.y, w, acc[1]);
        acc[2] = fmaf(hv.z, w, acc[2]);
        acc[3] = fmaf(hv.w, w, acc[3]);
      }
#pragma unroll
      for (int i = 0; i < lc::kRC; ++i) z_s[(r0 + i) * G4 + jl] = gs[(r0 + i) * G4 + jl] + acc[i];
    }
"""
_KSPLIT = """    // z[:, this block's columns] = gates + h_prev · W_h[:, those columns];
    // K1: each column's k sum over 4 lanes 8 apart, each from its own start.
    if (!kTrain) {
      const int L = (H + 3) / 4, NC = (G4 + 7) / 8;
      for (int q = threadIdx.x; q < NC * (R / lc::kRC) * 32; q += blockDim.x) {
        const int lane = q & 31, ks = lane >> 3, wq = q >> 5;
        const int jl = (wq % NC) * 8 + (lane & 7), r0 = (wq / NC) * lc::kRC;
        const int jc = jl < G4 ? jl : G4 - 1, kb = ks * L, off = (8 * ks) % L;
        float acc[lc::kRC] = {};
#pragma unroll 4
        for (int i = 0; i < L; ++i) {
          const int kk = i + off < L ? i + off : i + off - L, k = kb + kk;
          if (k < H) {
            const float w = w_s[k * ldw + jc];
            const float4 hv = *reinterpret_cast<const float4*>(hb + k * R + r0);
            acc[0] = fmaf(hv.x, w, acc[0]);
            acc[1] = fmaf(hv.y, w, acc[1]);
            acc[2] = fmaf(hv.z, w, acc[2]);
            acc[3] = fmaf(hv.w, w, acc[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < lc::kRC; ++i) {
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
        }
        if (ks == 0 && jl < G4) {
#pragma unroll
          for (int i = 0; i < lc::kRC; ++i)
            z_s[(r0 + i) * G4 + jl] = gs[(r0 + i) * G4 + jl] + acc[i];
        }
      }
    } else
""" + _K5_PRODUCT.split("\n", 1)[1]

_WAIT = """    lc::cp_async_wait_all();
    cluster.sync();
  }
"""
_STAGES = [
    ("[2][R][4U] gates stage", "[4][R][4U] gates stage"),
    ("g_st + lc::round4(2 * R * G4)", "g_st + lc::round4(4 * R * G4)"),
    ("(t & 1) * R * G4;", "(t & 3) * R * G4;"),
    ("m_st + (t & 1) * R + r", "m_st + (t & 3) * R + r"),
    ("""  prefetch(0);
  lc::cp_async_wait_all();""", """  for (int t = 0; t < 3; ++t) {
    if (t < T) prefetch(t);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 2;\\n" ::: "memory");"""),
    ("    if (t + 1 < T) prefetch(t + 1);", """    if (t + 3 < T) prefetch(t + 3);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");"""),
    ("g_st + par * R * G4;", "g_st + (t & 3) * R * G4;"),
    ("m_st[par * R + r]", "m_st[(t & 3) * R + r]"),
    (_WAIT, _WAIT.replace("lc::cp_async_wait_all();",
                          'asm volatile("cp.async.wait_group 2;\\n" ::: "memory");')),
]

TIMING_ONLY = ("nosync",)
PHASES = ("prefetch issue", "product", "block barrier", "gate math + exchange", "prefetch wait",
          "cluster barrier")

_STAMP_DECL = "  cluster.sync();  // every block of the cluster has started and is initialised\n"
_STAMP_TOP = "    if (t + 1 < T) prefetch(t + 1);\n"
_STAMP_MID = "    __syncthreads();\n    // The gate math of this block's units;"
_STAMP_END = "  const float* hb = h_b + (T & 1) * H * R;\n"
_STAMPS = [
    (_STAMP_DECL, _STAMP_DECL + "  long long ph[6] = {}, s0 = clock64(), s1;\n"),
    (_STAMP_TOP, "    s0 = clock64();\n" + _STAMP_TOP + "    s1 = clock64(); ph[0] += s1 - s0; s0 = s1;\n"),
    (_STAMP_MID, "    s1 = clock64(); ph[1] += s1 - s0; s0 = s1;\n    __syncthreads();\n"
                 "    s1 = clock64(); ph[2] += s1 - s0; s0 = s1;\n    // The gate math of this block's units;"),
    (_WAIT, "    s1 = clock64(); ph[3] += s1 - s0; s0 = s1;\n    lc::cp_async_wait_all();\n"
            "    s1 = clock64(); ph[4] += s1 - s0; s0 = s1;\n    cluster.sync();\n"
            "    s1 = clock64(); ph[5] += s1 - s0;\n  }\n"),
    (_STAMP_END, "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 6; ++i) atomicAdd(&g_stamps[i], "
                 "(unsigned long long)ph[i]);\n    atomicAdd(&g_stamps[6], (unsigned long long)T);\n  }\n"
                 + _STAMP_END),
    ("namespace lc = mmb::lstmc;\n", "namespace lc = mmb::lstmc;\n__device__ unsigned long long g_stamps[7];\n"),
]
_STAMPS_API = """
// The stamps of every block's thread 0 since the last call, summed: six
// phases in cycles, then the steps; out[7] the SM clock in kHz. Resets them.
MMB_API int mmb_lstm_stamps(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, 7 * sizeof(unsigned long long));
  const unsigned long long zero[7] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
  int khz = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  out[7] = (unsigned long long)khz;
  return (int)e;
}
"""

_PREFETCH = """  auto prefetch = [&](int t) {
    const int tt = dir ? T - 1 - t : t;
    float* gs = g_st + (t & 1) * R * G4;
    for (int e = threadIdx.x; e < R * G4 + R; e += blockDim.x) {
      if (e < R * G4) {
        const int r = e / G4, jl = e - r * G4, g = jl / U, ul = jl - g * U;
        const int row = row0 + r;
        const bool ok = row < B && ul < nu;
        lc::cp_async4(gs + e,
                      ok ? gates + ((size_t)row * T + tt) * 2 * G + (size_t)dir * G + g * H + u0 + ul
                         : gates,
                      ok);
      } else {
        const int r = e - R * G4, row = row0 + r;
        lc::cp_async4(m_st + (t & 1) * R + r, row < B ? mask + (size_t)row * T + tt : mask,
                      row < B);
      }
    }
  };
"""
_PRE = """  // This thread's prefetch slots (element threadIdx.x + i * blockDim.x of a
  // stage: the gates, then the mask) and where each reads, less the step's
  // offset, computed once (-1: zero-filled).
  constexpr int kSlots = (R * (4 * 32 + 1) + lc::kThreads - 1) / lc::kThreads;
  long long src[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int e = threadIdx.x + i * lc::kThreads;
    src[i] = -1;
    if (e < R * G4) {
      const int r = e / G4, jl = e - r * G4, g = jl / U, ul = jl - g * U, row = row0 + r;
      if (row < B && ul < nu)
        src[i] = (long long)row * T * 2 * G + (long long)dir * G + g * H + u0 + ul;
    } else if (e < R * G4 + R && row0 + e - R * G4 < B) {
      src[i] = (long long)(row0 + e - R * G4) * T;
    }
  }
  auto prefetch = [&](int t) {
    const int tt = dir ? T - 1 - t : t;
    float* gs = g_st + (t & 1) * R * G4;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int e = threadIdx.x + i * lc::kThreads;
      const bool ok = src[i] >= 0;
      if (e < R * G4)
        lc::cp_async4(gs + e, ok ? gates + src[i] + (long long)tt * 2 * G : gates, ok);
      else if (e < R * G4 + R)
        lc::cp_async4(m_st + (t & 1) * R + e - R * G4, ok ? mask + src[i] + tt : mask, ok);
    }
  };
"""

VARIANTS = {
    "k5loop": {"lstm.cu": [(_PRODUCT, _K5_PRODUCT)]},
    "pre": {"lstm.cu": [(_PREFETCH, _PRE)]},
    "ksplit": {"lstm.cu": [(_PRODUCT, _KSPLIT)]},
    "c16": {"lstm_cluster.cuh": [("kTargetUnits = 16", "kTargetUnits = 8")]},
    "r8": {"lstm_cluster.cuh": [("B >= 128 ? 8 : 4", "8")]},
    "stages4": {"lstm.cu": _STAGES,
                "lstm_cluster.cuh": [("round4(2 * R * G4) + round4(R * U) + round4(2 * (size_t)R))",
                                      "round4(4 * R * G4) + round4(R * U) + round4(4 * (size_t)R))")]},
    "nosync": {"lstm.cu": [(_WAIT, _WAIT.replace("cluster.sync();", "__syncthreads();")
                            + "  cluster.sync();  // no block leaves while others write to it\n")]},
    "stamps": {"lstm.cu": _STAMPS},
    "l2": {"lstm.cu": [("if (lc::plan(B, H, &p))\n    return bilstm_cluster<false>",
                        "if (false && lc::plan(B, H, &p))\n    return bilstm_cluster<false>")]},
}


def variant_dir(name: str):
    return build.BUILD_DIR / "variants" / f"lstm_{name}"


def start_build(name: str) -> subprocess.Popen:
    """Copy ``csrc/`` with the variant's edits and start its ``nvcc``."""
    out = variant_dir(name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for fname, edits in VARIANTS[name].items():
        text = (out / fname).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {fname} does not hold the text to replace once")
            text = text.replace(old, new)
        if name == "stamps" and fname == "lstm.cu":
            text += _STAMPS_API
        (out / fname).write_text(text)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
           str(out / "lstm.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_variant(name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    (variant_dir(name) / "lib.log").write_text(log)
    lib = ctypes.CDLL(str(variant_dir(name) / "lib.so"))
    lib.mmb_bilstm_forward.argtypes = list(build.SIGNATURES["mmb_bilstm_forward"])
    lib.mmb_bilstm_forward.restype = ctypes.c_int
    return lib


def phases_us(lib) -> dict:
    """The stamps variant's phases, microseconds a step (its counters hold
    every call since the last read: the timing runs' mean)."""
    lib.mmb_lstm_stamps.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * 8)()
    build.check_launch(build.library(), lib.mmb_lstm_stamps(ctypes.addressof(out)), "mmb_lstm_stamps")
    steps, khz = out[6], out[7]
    us = {ph: out[i] / steps / khz * 1e3 for i, ph in enumerate(PHASES)}
    print("         stamps a step: " + ", ".join(f"{ph} {v:.3f} us" for ph, v in us.items())
          + f" ({sum(out[:6]) / steps:.0f} cycles at {khz / 1e3:.0f} MHz)", flush=True)
    return us


def events_ms(fn, iters: int, reps: int = 5) -> float:
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


def operands(rows: int, steps: int, dev, scale: float = 1.0, seed: int = 31):
    """f32 gates ``[rows, steps, 8H]`` (both directions; unit-normal times
    ``scale``), a ragged mask with a row of length 0, ``w_h [2, H, 4H]``, as
    K1's wrapper hands them over."""
    rng = np.random.default_rng(seed)
    gates = torch.from_numpy((rng.standard_normal((rows, steps, 8 * H)) * scale)
                             .astype(np.float32)).to(dev)
    w_h = torch.from_numpy((rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)).to(dev)
    lengths = rng.integers(1, steps + 1, size=rows)
    lengths[0], lengths[-1] = steps, 0
    mask = torch.from_numpy((np.arange(steps)[None] < lengths[:, None]).astype(np.float32)).to(dev)
    return gates, mask, w_h


def run_k1(lib, gates, mask, w_h):
    """One call of ``lib``'s K1 entry point → ``(out, h_last, c_last)``."""
    B, T, _ = gates.shape
    dev = gates.device
    out = torch.empty(B, T, 2 * H, device=dev)
    h_last = torch.empty(B, 2 * H, device=dev)
    c_last = torch.empty(B, 2 * H, device=dev)
    rc = lib.mmb_bilstm_forward(gates.data_ptr(), mask.data_ptr(), w_h.data_ptr(), out.data_ptr(),
                                h_last.data_ptr(), c_last.data_ptr(), B, T, H,
                                torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(build.library(), rc, "mmb_bilstm_forward")
    return out, h_last, c_last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    ap.add_argument("--only", help="comma-separated variants to build and run (default: all)")
    ap.add_argument("--gate-scale", type=float, default=1.0, help="scale of the unit-normal gates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    names = args.only.split(",") if args.only else list(VARIANTS)
    procs = {name: start_build(name) for name in names}
    libs = {"sources": build.library(), **{n: load_variant(n, p) for n, p in procs.items()}}
    rows = []
    for tag, n, steps in SHAPES:
        gates, mask, w_h = operands(n, steps, dev, args.gate_scale)
        ref = lk.bilstm_train_forward_reference(gates, mask, w_h)[:3]
        mine = run_k1(libs["sources"], gates, mask, w_h)
        for name, lib in libs.items():
            got = run_k1(lib, gates, mask, w_h)
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            same = all(torch.equal(a, b) for a, b in zip(got, mine))
            ms = events_ms(lambda: run_k1(lib, gates, mask, w_h), iters=max(2, 20480 // steps // 4))
            rows.append({"variant": name, "tower": tag, "rows": n, "steps": steps,
                         "gate_scale": args.gate_scale, "ms": ms,
                         "us_a_step": ms * 1e3 / steps, "max_abs_err": err, "sources_bits": same})
            print(f"{name:8s} {tag:10s} rows={n:5d} T={steps:5d}: {ms:.4f} ms, "
                  f"{ms * 1e3 / steps:.3f} us a step; max abs err {err:.2e} (bound "
                  f"{lk.TOLERANCE['atol']:.0e}); the sources' bits: {same}", flush=True)
            if name == "stamps":
                rows[-1]["phases_us"] = phases_us(lib)
            if err > lk.TOLERANCE["atol"] and name not in TIMING_ONLY:
                print(f"lstm_variants: {name} at {tag} is over the bound", file=sys.stderr)
                return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
