"""The benchmark's own arithmetic: FLOP counts against hand counts, the
parameter counts of the configurations, the kernel classes, the rate and
percentile over every sample, and the device trace's busy time and gaps."""

from __future__ import annotations

import json
import math

import pytest

from port_bench import inputs, yardstick
from port_bench.devtrace import Spans, breakdown, summarize

from conftest import ROOT


def _config(name):
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())["model"]


def test_one_conv_by_hand():
    inc2 = next(c for c in yardstick.model_convs(_config("unet_carvana"), 640, 959)
                if c["name"] == "inc.conv2")
    # 640·959 output pixels, each 64 outputs of 9·64 multiply-adds.
    assert yardstick.conv_flops(inc2["px_out"], 3, 64, 64) == 2 * 9 * 64 * 64 * 640 * 959


def test_unet_flops_by_hand():
    levels = [(640, 959), (320, 479), (160, 239), (80, 119), (40, 59)]
    px = [h * w for h, w in levels]
    fwd = 2 * 9 * px[0] * (3 * 64 + 64 * 64)
    for i, c in enumerate((64, 128, 256, 512), start=1):
        fwd += 2 * 9 * px[i] * (c * 2 * c + 2 * c * 2 * c)
    for i, (cin, out) in enumerate(((1024, 512), (512, 256), (256, 128), (128, 64)), start=1):
        lvl = 4 - i
        up_px = 4 * px[lvl + 1]  # ConvTranspose k2 s2: one tap an output pixel
        fwd += 2 * up_px * cin * (cin // 2)
        fwd += 2 * 9 * px[lvl] * (cin * out + out * out)
    fwd += 2 * px[0] * 64 * 1
    cfg = _config("unet_carvana")
    assert yardstick.forward_flops(cfg, 640, 959) == fwd == 898_527_723_520
    first = 2 * 9 * px[0] * 3 * 64
    assert yardstick.train_flops(cfg, 640, 959) == 3 * fwd - first


@pytest.mark.parametrize("name,count", [("unet_carvana", 31_037_633),
                                        ("attention_carvana", 31_388_201)])
def test_parameter_counts(name, count):
    cfg = _config(name)
    assert yardstick.param_count(cfg) == count
    assert sum(math.prod(s) for _, s, _ in inputs.layout(cfg)) == count


@pytest.mark.parametrize("name,conv", [
    ("void tuk::tc::tc_dw_kernel<false>(CUtensorMap_st)", True),
    ("tuk::reduce_rows_kernel(float const*, float*, int)", True),
    ("void tuk::tc::dc::tc_double_conv_kernel<tuk::tc::Bf16Op, 4, 3>(CUtensorMap_st)", True),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", True),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", True),
    ("a_kernel_nobody_named_yet", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", False),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>", False),
    ("Memcpy HtoD (Pageable -> Device)", False),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<float, int>", False),
])
def test_kernel_classes(name, conv):
    assert yardstick.is_conv_kernel(name) is conv


def test_rate_and_p95_count_every_request_and_a_stall():
    # 10 s: 1880 fast requests and, early in the window, a stall of 120
    # requests (6%) that waited 2 s each.
    recs = [(0.1, 2.1, True)] * 120 + [(2.0 + i * 0.004, 2.0 + i * 0.004 + 0.05, True)
                                      for i in range(1880)]
    st = yardstick.request_stats(recs, t_end=10.0, seconds=10.0, failed_ms=60e3)
    assert st["rate"] == 200.0 and st["attempted"] == 2000 and st["failed"] == 0
    assert st["p95_ms"] == pytest.approx(2000.0)
    # A failed request waited its whole timeout; one that ends after the
    # window counts in the tail but not in the rate.
    recs2 = recs[:-2] + [(9.9, 10.5, True), (9.9, 9.95, False)]
    st2 = yardstick.request_stats(recs2, t_end=10.0, seconds=10.0, failed_ms=60e3)
    assert st2["rate"] == pytest.approx(199.8) and st2["failed"] == 1
    assert st2["p95_ms"] == pytest.approx(2000.0)


def test_percentile_nearest_rank():
    assert yardstick.percentile(range(1, 101), 0.95) == 95
    assert yardstick.percentile([5.0], 0.95) == 5.0


def test_trace_busy_union_gaps_and_anchor():
    # Device clock 1000 ns ahead of the host: the anchor starts at 1000.
    ops = [("at::cuda::spin_kernel(long)", 1000, 1010),
           ("conv_a", 1020, 1100), ("elementwise add", 1050, 1120),  # overlapping: counted once
           ("conv_b", 1300, 1400), ("late", 2500, 2600)]  # after the window: left out
    s = summarize(ops, host0=0, host1=1500)
    assert s["busy_s"] == pytest.approx((10 + 100 + 100) / 1e9)
    assert s["window_s"] == pytest.approx(1500 / 1e9)
    assert [g[1] for g in s["gaps"]] == [10, 180, 1100]
    assert s["gaps"][1][0] == 120  # on the host clock
    spans = Spans(True)
    spans.done += [("train.step", 1, 100, 200), ("outer", 1, 0, 1000)]
    assert spans.label_at(150) == "train.step" and spans.label_at(500) == "outer"
    b = breakdown(s, spans)
    assert b["idle_gaps"][:2] == [["outer", 1100e-9], ["train.step", 180e-9]]
    assert b["device_ops"][0][0] in ("conv_a", "conv_b")
    conv, glue = yardstick.split_device_time(s["ops"])
    assert glue == pytest.approx(70e-9) and conv == pytest.approx(190e-9)


def test_metric_readers_never_read_zero_or_over_100(bench_root):
    man = bench_root.manifest()
    cfg = json.loads((ROOT / "port_bench/configs/unet_carvana.json").read_text())
    r = {"kind": "train", "config": cfg, "dtype": "bf16", "steps": 10, "images": 40,
         "window_s": 1.0, "height": 640, "width": 959, "trace": None}
    assert man.metric_reader("conv_roofline.train").read(r) is None
    assert man.metric_reader("mfu.train").read(r) == pytest.approx(
        100 * 2_693_462_016_000 * 40 / 989e12)
    r["trace"] = {"ops": [("glue add elementwise", 0.5)], "busy_s": 0.5, "window_s": 1.0,
                  "gaps": []}
    assert man.metric_reader("conv_roofline.train").read(r) is None  # no conv time: silent
    assert man.metric_reader("device_idle_pct.train").read(r) == pytest.approx(50.0)
