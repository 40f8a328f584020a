"""The frozen arithmetic: FLOP counts, kernel bounds and the trace reduction."""

import pytest

from pbench import counts, spec, trace

H100 = counts.PEAKS["h100 80gb hbm3"]


def cfg(name, program):
    bench = spec.load_benchmark()
    return spec.program_config(spec.config_file(bench, name), program)


@pytest.mark.parametrize("name, gflop", [("mmbidaf_h128", 499.14), ("mmbidaf_h512", 508.35)])
def test_serving_flops_a_video(name, gflop):
    assert counts.serve_flops_per_video(cfg(name, "serve"), (240, 320)) / 1e9 == pytest.approx(gflop, abs=0.005)


def test_train_step_flops_h512():
    c = cfg("mmbidaf_h512", "train")
    assert counts.train_step_flops(c, 32, counts.n_params(c)) / 1e9 == pytest.approx(962.0, abs=0.05)


@pytest.mark.parametrize("name, k1_ms, k56_ms", [("mmbidaf_h128", 0.2764, 0.5529),
                                                 ("mmbidaf_h512", 4.4232, 8.8464)])
def test_lstm_bounds(name, k1_ms, k56_ms):
    assert counts.k1_bound_s(cfg(name, "serve"), 64, H100) * 1e3 == pytest.approx(k1_ms, abs=1e-4)
    assert counts.k5_k6_bound_s(cfg(name, "train"), 32, H100) * 1e3 == pytest.approx(k56_ms, abs=1e-4)


@pytest.mark.parametrize("symbol, kernel", [
    ("void bilstm_cluster_kernel<4, false>(float const*)", "K1"),
    ("void bilstm_kernel<16, true>(float const*)", "K5"),
    ("void bilstm_bptt_l2_kernel<4>(float const*)", "K6"),
    ("void lstm_dwh_partial_kernel(float const*)", "K6"),
    ("void bidaf_tiled_bwd_pass_kernel(float const*)", "K8"),
])
def test_kernel_names(symbol, kernel):
    assert counts.is_kernel(symbol, kernel)
    assert not counts.is_kernel("void bilstm_bptt_l2_kernel<4>(float const*)", "K1")


def make_trace():
    # device: two overlapping kernels launched in "frontend", one in "model"
    device = [("void a<1>(int)", 100, 300, 50), ("void b(int)", 200, 400, 60),
              ("void c(int)", 600, 700, 520), ("Memcpy DtoH", 20_000, 20_100, None)]
    host = [("frontend", 40, 500), ("aten::conv", 45, 70), ("model", 510, 40_000),
            ("cudaStreamSynchronize", 700, 19_990)]
    spans = {"frontend": [(40, 500)], "model": [(510, 40_000)]}
    return trace.Trace(device, host, spans, (0, 40_000))


def test_union_and_spans():
    t = make_trace()
    assert t.busy_s == pytest.approx((300 + 100 + 100) / 1e9)
    assert t.window_s == pytest.approx(40_000 / 1e9)
    assert t.span_device_s("frontend") == pytest.approx(400 / 1e9)
    assert t.span_device_s("model") == pytest.approx(100 / 1e9)
    assert t.kernel_s(lambda n: "a<" in n) == pytest.approx(200 / 1e9)


def test_breakdown_groups_idle_by_host_event():
    b = make_trace().breakdown()
    assert b["device_ops"][0] == ["a<1>", pytest.approx(200 / 1e9)]
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx((20_000 - 700) / 1e9)
    assert gaps["model"] == pytest.approx((40_000 - 20_100) / 1e9)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
