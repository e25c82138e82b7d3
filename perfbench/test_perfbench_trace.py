"""Reading a profiler trace, and the per-layer metrics on a record."""

from __future__ import annotations

import pytest

from perfbench.harness.cell import Cell
from perfbench.harness.trace import read_trace

TRACE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": "perfbench.window", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 1, "dur": 30},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 3,
     "args": {"correlation": 7}},
    {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 6, "dur": 2,
     "args": {"correlation": 8}},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm", "ts": 10, "dur": 20,
     "args": {"correlation": 7}},
    {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>",
     "ts": 25, "dur": 20, "args": {"correlation": 8}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 50, "dur": 40},
]}


def test_read_trace_busy_window_launches_and_gaps():
    rec = read_trace(TRACE)
    assert rec["window_s"] == pytest.approx(100e-6) and rec["busy_s"] == pytest.approx(35e-6)
    assert rec["launches"] == 2 and rec["launched"] == 2
    gaps = dict(rec["idle_gaps"])
    assert gaps["aten::sum"] == pytest.approx(55e-6)
    assert gaps["aten::conv2d"] == pytest.approx(10e-6)


def test_detect_metrics_read_the_record():
    cell = Cell("mobilenet-voc416.detect-b128")
    seg = read_trace(TRACE)
    seg["kernels"].append(["void (anonymous namespace)::dwsep_wgmma_kernel<128>", 1e-3])
    record = {"segment": seg, "segment_calls": 1, "counters": {"dwsep": 1, "dwconv": 0},
              "routed": {"dwsep": 1, "dwconv": 4}, "kernel_work": {"dwsep": (989e9, 1.0)},
              "window_s": 1.0, "window_images": 1000, "forward_flops": 1e9}
    read = lambda name: cell.metric_reader(name)(record)
    assert read("conv_ms.detect") == pytest.approx(0.02)
    assert read("epilogue_ms.detect") == pytest.approx(0.02)
    assert read("dwsep_roofline.detect") == pytest.approx(100.0)
    # the port counted one launch, the routed layers ask for four: not read
    assert read("dwconv_roofline.detect") is None
    assert read("mfu.detect") == pytest.approx(100 * 1e12 / 989e12)
    assert read("device_idle.detect") == pytest.approx(65.0)
    seg["launched"] = 1            # a dropped device event: no device time is read
    assert read("conv_ms.detect") is None


@pytest.mark.parametrize("workload", ["darknet19-voc416.detect-b128", "darknet19-voc416.train-b16",
                                      "darknet19-voc416.cameras-under-knee"])
def test_imports_reader_reads_the_first_setup_phase(workload):
    read = Cell(workload).metric_reader("imports_s.setup")
    assert read({"phases": {"imports": 8.25, "cuda_context": 0.3}}) == 8.25
    assert read({"segment": {}}) is None and read(None) is None
