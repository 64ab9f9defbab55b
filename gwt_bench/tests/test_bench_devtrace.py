"""The trace reduction on events made by hand."""

from pytest import approx

from gwt_bench import devtrace
from gwt_bench.devtrace import Trace

K = "void (anonymous namespace)::decode_split_kernel<__nv_bfloat16, 64, 1>(x)"
TR = Trace(
    device=[("kernel", K, 0, 10), ("kernel", "gemm_a", 5, 20),
            ("gpu_memcpy", "Memcpy DtoH", 30, 35),
            ("kernel", "gwt_tc::enc_attn_tc_kernel<64, true>(y)", 50, 60)],
    host=[("aten::mm", 18, 40), ("cudaLaunchKernel", 21, 29),
          ("aten::add", 36, 48)],
    launches=3)


def test_busy_is_the_union_of_device_intervals():
    assert devtrace.busy_s(TR) == approx((20 + 5 + 10) * 1e-9)


def test_idle_share_of_the_traced_window():
    class Run:
        trace, trace_window_s = TR, 70e-9
    assert devtrace.idle_share(Run) == approx(50.0)
    Run.trace = None
    assert devtrace.idle_share(Run) is None


def test_kernel_time_by_pattern():
    assert devtrace.kernel_s(TR, ["decode_split_kernel"]) == approx(10e-9)
    assert devtrace.kernel_s(TR, ["enc_attn(_tc)?_kernel"]) == approx(10e-9)
    assert devtrace.kernel_s(TR, ["no_such_kernel"]) is None


def test_idle_gaps_named_by_the_innermost_host_op():
    gaps = dict(devtrace.idle_gaps(TR))
    assert gaps == approx({"cudaLaunchKernel": 10e-9, "aten::add": 15e-9})


def test_top_ops_and_short_names():
    top = devtrace.top_device_ops(TR)
    names = {k: v for k, v in top}
    assert top[0][0] == "gemm_a"
    assert names == approx({"gemm_a": 15e-9, "Memcpy DtoH": 5e-9,
                            "decode_split_kernel<__nv_bfloat16, 64, 1>": 10e-9,
                            "gwt_tc::enc_attn_tc_kernel<64, true>": 10e-9})


def test_launch_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC_v11060",
                 "cuLaunchKernel", "cudaGraphLaunch"):
        assert devtrace.LAUNCH.match(name)
    assert not devtrace.LAUNCH.match("cudaMemcpyAsync")
