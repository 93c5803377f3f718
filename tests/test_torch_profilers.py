"""The six profilers of the JAX package's tools/ in the port
(gsjax_torch.tools.{bench_fps, bench_trained, profile_kernels, trace_step,
trace_binning, bench_sweep}) on the CPU: each refuses to run without a
card; their pure parts run here: bench_sweep's configurations (and
argument errors for the ones the port refuses), the op-family grouping
of a made-up trace, idle gaps, makespans and the split of a trace into
calls, and the check that holds a profiler session (or an exported Chrome
trace) to the kernel launches the port counted."""

from __future__ import annotations

import argparse
import json
import types

import pytest
import torch

from gsjax_torch.tools import (
    bench_fps,
    common,
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


def test_trace_step_sharded_names_the_mesh_item(monkeypatch):
    """--sharded (the mesh step, ROADMAP queue item 6, now ported) traces
    the sharded step's own functions, and refuses without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="trace_step: no CUDA device"):
        trace_step.main(["--sharded"])
    marked = {(m.__name__, attr) for m, attr, _ in trace_step.SHARDED_MARKS}
    assert {("gsjax_torch.parallel.step", "halo_exchange"),
            ("torch.distributed", "all_reduce")} <= marked
    assert all(callable(getattr(m, attr)) for m, attr, _ in trace_step.SHARDED_MARKS)


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


def _kernel(name):
    return f"void {name}<1, true>(float const*, int const*, int, int, int, int, float*)"


FORWARD = _kernel("composite_forward_kernel")
BACKWARD = _kernel("composite_backward_kernel")
OTHER_OPS = ["Memset (Device)", "void at::native::vectorized_elementwise_kernel<4>()"]


def test_a_whole_session_is_taken():
    names = [FORWARD] * 3 + [BACKWARD, _kernel("row_engine_kernel")] + OTHER_OPS
    launched = {"composite_forward": 3, "composite_backward": 1, "row_engine": 1,
                "segment_sum": 0}
    assert common.session_gaps(names, launched) == {}
    common.check_whole(names, launched)
    assert common.kernel_events(names)["composite_forward"] == 3
    # Events of no kernel of the port are whole when it launched none.
    common.check_whole(OTHER_OPS, dict.fromkeys(common.DEVICE_KERNELS, 0))
    # Ranges and the session's lead-in are not operations of the work.
    assert [trace.is_marker(n) for n in ("ProfilerStep#1", "gsjt:SSIM",
                                         "spin_kernel(long)", FORWARD)] == [
        True, True, True, False]


def test_a_session_missing_one_launch_raises():
    names = [FORWARD] * 2 + [BACKWARD] + OTHER_OPS
    launched = {"composite_forward": 3, "composite_backward": 1}
    assert common.session_gaps(names, launched) == {"composite_forward": (2, 3)}
    with pytest.raises(common.IncompleteSession,
                       match=r"2 events of composite_forward .* launched 3$"):
        common.check_whole(names, launched)
    # An event of a kernel the port did not count is no more whole.
    with pytest.raises(common.IncompleteSession, match="1 events of segment_sum"):
        common.check_whole(names + [_kernel("segment_sum_kernel")],
                           {"composite_forward": 2, "composite_backward": 1})
    with pytest.raises(common.IncompleteSession, match="no device event"):
        common.check_whole([], {})


def test_incomplete_sessions_are_retried_and_reported(monkeypatch):
    """whole_profile takes an incomplete session again, at most
    PROFILE_TRIES in all, and with_refused puts each refused session's
    error into the next reported line (then forgets it)."""
    import contextlib

    outcomes = []

    @contextlib.contextmanager
    def session(cpu=False):
        yield "profiler"
        if outcomes.pop(0):
            raise common.IncompleteSession(f"refused {len(outcomes)}")

    monkeypatch.setattr(common, "whole_session", session)
    ran = []
    outcomes[:] = [True, False]
    assert common.whole_profile(lambda: ran.append(1)) == "profiler" and len(ran) == 2
    assert common.with_refused({"ms": 1.0}) == {
        "ms": 1.0, "profiler_sessions_refused": ["refused 1"]}
    assert common.with_refused({"ms": 2.0}) == {"ms": 2.0}
    outcomes[:] = [True] * common.PROFILE_TRIES
    with pytest.raises(common.IncompleteSession, match="refused 0"):
        common.whole_profile(lambda: None)
    assert len(common.with_refused({})["profiler_sessions_refused"]) == common.PROFILE_TRIES


def test_device_ops_counts_each_call_exactly(monkeypatch):
    events = [types.SimpleNamespace(name=n)
              for n in [FORWARD, "Memset (Device)", OTHER_OPS[1]] * 5]
    monkeypatch.setattr(common, "_profiled", lambda fn, reps: events[:3 * reps])
    assert common.device_ops(None, "composite_forward_kernel", calls=5) == {
        "kernels": 2, "memsets": 1, "named": 1}
    monkeypatch.setattr(common, "_profiled", lambda fn, reps: events[:3 * reps - 1])
    with pytest.raises(AssertionError, match="over 5 calls"):
        common.device_ops(None, "composite_forward_kernel", calls=5)


def test_profile_dir_trace_kernels_of_a_made_up_chrome_trace(tmp_path):
    """The trainer's --profile_dir trace as torch.profiler exports it: the
    kernel events (category "kernel") alone, the session's lead-in left
    out, held to the launches the trainer recorded for its windows."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 1},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1,
               "dur": 1},
              {"ph": "X", "cat": "gpu_user_annotation", "name": FORWARD, "ts": 2, "dur": 1},
              {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 3,
               "dur": 1},
              {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 4}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": 10 + i, "dur": 1}
               for i, n in enumerate(["spin_kernel(long)"] * 3 + [FORWARD] * 4
                                     + [BACKWARD] * 4 + [OTHER_OPS[1]])]
    path = tmp_path / "trace_100_110.json"
    path.write_text(json.dumps({"traceEvents": events}))
    names = trace.chrome_trace_kernels(str(path))
    assert names == [FORWARD] * 4 + [BACKWARD] * 4 + [OTHER_OPS[1]]
    common.check_whole(names, {"composite_forward": 4, "composite_backward": 4})
    with pytest.raises(common.IncompleteSession, match="4 events of composite_backward"):
        common.check_whole(names, {"composite_forward": 4, "composite_backward": 5})


# --- the card ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsjax_torch.render import kernels

    kernels.build()
    return torch.device("cuda")


@pytest.mark.cuda
def test_sessions_whole_after_a_training_run_on_card(card, tmp_path, monkeypatch):
    """A run of cli.train (120 iterations on a small synthetic dataset, its
    --profile_dir trace of steps 100-110), then profiler sessions as the
    port takes them in the same process: the trace holds each main kernel
    exactly as often as the trainer launched it in the windows it covered,
    and ten sessions of twenty composite_forward launches are each whole
    (tools/common.whole_profile raises after PROFILE_TRIES incomplete
    ones)."""
    import sys

    from gsjax_torch.cli import train as train_cli
    from gsjax_torch.config import RasterConfig
    from gsjax_torch.render import kernels
    from gsjax_torch.synthetic import look_at_origin_camera, random_scene
    from gsjax_torch.tools.synthetic_scene import generate

    data = generate(str(tmp_path / "data"), res=96, n_train=8, n_test=2, n_spheres=8,
                    n_seed_points=2000)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # --quiet replaces it
    trainer = train_cli.main([
        "-s", data, "-m", str(tmp_path / "model"), "--quiet", "--iterations", "120",
        "--test_iterations", "121", "--save_iterations", "120", "--port", "0",
        "--profile_dir", str(tmp_path / "profile")])
    rec = next(e for e in trainer.events if "profile" in e)
    assert rec["profile"] == [100, 110] and rec["launches"]["composite_backward"] > 0
    common.check_whole(trace.chrome_trace_kernels(rec["trace"]), rec["launches"],
                       "the --profile_dir trace")

    params, aux = random_scene(5000, sh_degree=1, seed=3, spread=1.5, device=card)
    stream = common.instance_stream(
        params, look_at_origin_camera(320, 240, device=card),
        RasterConfig(tile_size=16, max_instances=1 << 17, max_rows=1 << 16), aux.alive,
        sh_degree=1)
    for _ in range(10):
        common.whole_profile(lambda: [kernels.composite_forward(
            stream.inst, stream.tile_start, **stream.geometry) for _ in range(20)])
    assert common.device_ms(
        lambda: kernels.composite_forward(stream.inst, stream.tile_start, **stream.geometry),
        common.DEVICE_KERNELS["composite_forward"]) > 0
