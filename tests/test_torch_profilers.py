"""The six profilers of the JAX package's tools/ in the port
(gsjax_torch.tools.{bench_fps, bench_trained, profile_kernels, trace_step,
trace_binning, bench_sweep}) on the CPU: each refuses to run without a
card; their pure parts run here: bench_sweep's configurations (and
argument errors for the ones the port refuses), the op-family grouping
of a made-up trace, idle gaps, makespans and the split of a trace into
calls."""

from __future__ import annotations

import argparse

import pytest
import torch

from gsjax_torch.tools import (
    bench_fps,
    bench_sweep,
    bench_trained,
    profile_kernels,
    trace,
    trace_binning,
    trace_step,
)

TOOLS = {"bench_fps": bench_fps, "bench_trained": bench_trained,
         "profile_kernels": profile_kernels, "trace_step": trace_step,
         "trace_binning": trace_binning, "bench_sweep": bench_sweep}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_without_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        TOOLS[name].main([])
    assert "no CUDA device" in str(e.value.code) and name in str(e.value.code)


def test_trace_step_sharded_names_the_mesh_item():
    with pytest.raises(NotImplementedError, match="queue item 6"):
        trace_step.main(["--sharded"])


def test_bench_sweep_configs():
    cfg = bench_sweep.parse_cfg("64x32c256s2f")
    assert (cfg.tw, cfg.th, cfg.chunk, cfg.strips, cfg.fast_fwd) == (64, 32, 256, 2, True)
    assert (cfg.max_instances, cfg.max_rows) == (1 << 20, 1 << 19)
    cfg = bench_sweep.parse_cfg("16x16c384s1")  # budgets rounded up to the chunk
    assert cfg.max_instances % 384 == 0 and cfg.max_instances >= 3 << 20
    assert cfg.max_rows % 384 == 0 and cfg.max_rows >= 1 << 20
    assert not cfg.fast_fwd
    names = [n for n, _ in bench_sweep.parse_configs(",".join(bench_sweep.DEFAULT_CONFIGS))]
    assert names == list(bench_sweep.DEFAULT_CONFIGS)


@pytest.mark.parametrize("bad", ["128x64c128s1", "32x32", "32x32c128s3", "8x8c128s1"])
def test_bench_sweep_refused_config_is_an_argument_error(bad, capsys):
    with pytest.raises(argparse.ArgumentTypeError):
        bench_sweep.parse_configs(f"32x32c128s1,{bad}")
    with pytest.raises(SystemExit) as e:
        bench_sweep.main(["--configs", bad])
    assert e.value.code == 2 and "--configs" in capsys.readouterr().err


def _op(name, start, end, *chain):
    return trace.DeviceOp(name, float(start), float(end), tuple(chain))


def test_op_families_of_a_made_up_trace():
    fwd = ("aten::mul", "gsjt:preprocess", "gsjt:render")
    ops = [
        _op("void elementwise_kernel<mul>", 0, 10, *fwd),
        # The autograd engine's op inherits its forward op's chain.
        _op("void elementwise_kernel<mul>", 10, 14, "aten::mul",
            "autograd::engine::evaluate_function: MulBackward0", *fwd),
        _op("composite_forward_kernel", 20, 60),
        _op("composite_backward_kernel", 60, 160, "gsjt:composite other"),
        _op("row_engine_kernel", 160, 163),
        _op("void indexSelectLargeIndex", 170, 190, "aten::index_select",
            "gsjt:binning"),
        _op("void index_elementwise_kernel", 190, 200, "aten::index", "aten::__getitem__"),
        _op("void radixSort", 200, 230, "aten::sort", "gsjt:binning"),
        _op("void ssim_kernel", 230, 250, "aten::conv2d", "gsjt:SSIM"),
        _op("Memset (Device)", 250, 251),
    ]
    assert [trace.family(op) for op in ops] == [
        "preprocess", "preprocess", "composite kernels", "composite kernels", "binning",
        "gathers", "gathers", "binning", "SSIM", trace.OTHER]
    fam = trace.by_family(ops, per=2)
    assert fam["composite kernels"] == pytest.approx(0.07)
    assert fam["binning"] == pytest.approx(0.0165)
    assert list(fam)[0] == "composite kernels"
    names = trace.by_name(ops, per=2)
    assert names[0] == {"name": "composite_backward_kernel", "ms": 0.05, "count": 0.5}
    assert sum(r["count"] for r in names) == len(ops) / 2


def test_idle_gaps_and_makespan():
    spans = [(10, 20), (15, 30), (40, 50), (49, 55), (100, 101)]
    assert trace.busy_intervals(spans) == [(10, 30), (40, 55), (100, 101)]
    assert trace.makespan(spans) == 91
    assert trace.makespan([]) == 0.0
    gaps = trace.idle_gaps(spans, top=1)
    assert (gaps["makespan"], gaps["busy"], gaps["idle"], gaps["gaps"]) == (91, 36, 55, 2)
    assert gaps["idle_share"] == pytest.approx(55 / 91)
    assert gaps["largest"] == [{"gap": 45, "after": 55}]


def test_split_calls_at_the_pauses():
    # Three calls, each of ops with small gaps inside, long pauses between.
    ops = [_op(f"k{i}{j}", 1000 * i + 10 * j, 1000 * i + 10 * j + 8)
           for i in range(3) for j in range(4)]
    calls = trace.split_calls(list(reversed(ops)), 3)
    assert [[op.name for op in c] for c in calls] == [
        [f"k{i}{j}" for j in range(4)] for i in range(3)]
    rows = trace_binning.per_call(ops, 3)
    assert [r["ops"] for r in rows] == [4, 4, 4]
    assert rows[1]["makespan_ms"] == pytest.approx(0.038)
    assert rows[1]["busy_ms"] == pytest.approx(0.032)
    assert trace.split_calls(ops, 1) == [sorted(ops, key=lambda op: op.start_us)]


def test_marked_wraps_and_restores():
    import types

    from torch.profiler import ProfilerActivity, profile

    mod = types.SimpleNamespace(f=lambda x: x + 1)
    original = mod.f
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.marked([(mod, "f", "Adam")]):
            assert mod.f is not original and mod.f(1) == 2
    assert mod.f is original
    assert any(e.name == "gsjt:Adam" for e in prof.events())
