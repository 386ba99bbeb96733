"""CPU tests of the harness: finding files by name, the traffic's
determinism, the statistics, the metric readers, what the run imports and
reads, and its exits without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.harness import cell as cellmod
from portbench.harness import registry, stats, traffic
from portbench.harness.trace import DeviceOp, StageCall, TraceData, reduce
from portbench.tests.support import CHECKOUT, PORTBENCH, checkout


def test_everything_in_benchmark_json_is_found_by_name():
    bench = registry.load_benchmark()
    for entry in bench["workloads"]:
        cell = registry.Cell(entry["name"], bench=bench)
        assert cell.config["name"] == entry["config"]
        assert cell.traffic["name"] == entry["traffic"]
        assert cell.workload["name"] == entry["name"]
        registry.reference_model(cell.config["model"])
        for section in ("end_to_end", "per_layer"):
            assert cell.metrics(section)
    for c in bench["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert json.loads((CHECKOUT / c["file"]).read_text())["name"] == \
            c["name"]


def test_metric_files_declare_what_benchmark_json_says():
    bench = registry.load_benchmark()
    for m in bench["per_layer"]:
        reader = registry.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == \
            (m["layer"], m["unit"], m["source"], m["moves"])


def test_additions_need_no_edit(tmp_path):
    """A copy with one more configuration, traffic mix, cell and metric,
    each a new file plus its BENCHMARK.json entry, is found; no file that
    was there changes."""
    root = checkout(tmp_path, with_program=False)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "tiny.json").write_text(json.dumps(
        {**json.loads((root / "configs" / "unicycle_t100.json").read_text()),
         "name": "tiny", "T": 5, "params": {"N": 5, "dt": 0.1,
                                           "noise": 1e-3,
                                           "goal": [5.0, 5.0]}}))
    (root / "traffic" / "bursty.json").write_text(json.dumps(
        {**json.loads((root / "traffic" / "closed_loop_warm.json")
                      .read_text()), "name": "bursty",
         "judged_lanes_per_replan": 2}))
    (root / "workloads" / "tiny_cell.json").write_text(json.dumps(
        {"name": "tiny_cell", "B": 4, "x_mpc": [0.0, 0.0, 0.0],
         "limits": {"l_gap": 1.0, "L_gap": 1.0}}))
    (root / "metrics" / "lanes_per_replan.py").write_text(
        "LAYER = 'Device'\nUNIT = 'count'\nSOURCE = 'device_trace'\n"
        "MOVES = 'solves_per_s'\n\n\ndef read(trace):\n"
        "    return 7.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_cell", "config": "tiny",
                               "traffic": "bursty", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "lanes_per_replan", "unit": "count",
                               "better": "lower", "source": "device_trace",
                               "layer": "Device", "moves": "solves_per_s",
                               "workloads": ["tiny_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.Cell("tiny_cell", root=root)
    assert cell.config["T"] == 5 and cell.traffic["name"] == "bursty"
    assert [m["name"] for m in cell.metrics("per_layer")] == \
        ["lanes_per_replan"]
    assert registry.metric_reader("lanes_per_replan", root).read(None) == 7.0
    assert {p: p.read_bytes() for p in before} == before


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_traffic_is_a_function_of_the_seed(seed):
    t = json.loads((PORTBENCH / "traffic" / "closed_loop_warm.json")
                   .read_text())
    a = traffic.plan(seed, t, 12, 262144, 50)
    b = traffic.plan(seed, t, 12, 262144, 50)
    c = traffic.plan(seed + 1, t, 12, 262144, 50)
    assert torch.equal(a.deltas, b.deltas) and torch.equal(a.lanes, b.lanes)
    assert not torch.equal(a.deltas, c.deltas)
    assert float(a.deltas.abs().max()) <= t["delta_scale"]
    assert a.lanes.shape == (50, t["judged_lanes_per_replan"])
    assert a.lanes[0, :3].tolist() == [0, 1, 262143]
    assert int(a.lanes.max()) < 262144
    assert torch.equal(a.cold_lanes, b.cold_lanes)
    assert not torch.equal(a.cold_lanes, c.cold_lanes)
    assert a.cold_lanes.shape == (t["cold_lanes"],)
    assert a.cold_lanes[:3].tolist() == [0, 1, 262143]
    assert a.cold_lanes.unique().numel() == t["cold_lanes"]
    assert int(a.cold_lanes.max()) < 262144
    small = traffic.plan(seed, t, 12, 5, 2)
    assert sorted(small.cold_lanes.tolist()) == [0, 1, 2, 3, 4]


def test_percentile_and_rate():
    lat = [float(i) for i in range(1, 101)]
    assert stats.percentile(lat, 90) == 90.0
    assert stats.percentile(lat[::-1], 90) == 90.0
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.rate(1000, 4.0) == 250.0


class _Res:
    def __init__(self, B):
        self.value = torch.ones(B)
        self.failed = torch.zeros(B, dtype=torch.bool)
        self.failed[0] = True
        self.l = torch.zeros(B, 2, 1)
        self.L = torch.zeros(B, 2, 1, 1)
        self.iterations = torch.ones(B, dtype=torch.int32)


def test_window_takes_all_work_over_all_time(monkeypatch):
    """Every re-plan issued before the deadline counts, the window ends when
    the last one is on the host, and the rate and p90 are over all of
    them."""
    B = 6
    clock = iter(range(1000))
    monkeypatch.setattr(cellmod.time, "perf_counter",
                        lambda: float(next(clock)))
    prog = cellmod.Program(
        bank=lambda x, u, th: _Res(B), module=None, thetas=torch.zeros(B),
        x0=torch.zeros(1), u0=torch.zeros(2, 1), xs=torch.zeros(100, 1),
        x_mpc=torch.zeros(1),
        plan=traffic.Plan(torch.zeros(100, 1),
                          torch.zeros(100, 2, dtype=torch.long),
                          torch.zeros(1, dtype=torch.long)),
        u_warm=torch.zeros(2, 1))
    # the clock ticks once a read: the window opens at 0, the loop checks
    # at 1, 4, 7 and 10, each re-plan is issued and done a tick apart
    win = cellmod.measure(prog, seconds=10)
    assert len(win.latencies) == 3
    assert all(lat == 1.0 for lat in win.latencies)
    assert win.seconds == 9.0               # 0 .. the last one done
    assert win.lanes_done == 3 * B and win.failed == 3
    assert stats.rate(win.lanes_done, win.seconds) == 2.0


def test_forbidden_modules_compare_whole_names(monkeypatch):
    fake = {"ratilqr_tpu_torch": 1, "ratilqr_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1}
    monkeypatch.setattr(run.sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake.update({"ratilqr_tpu.ops": 1, "jax.numpy": 1, "flax": 1})
    assert run.forbidden_modules() == ["flax", "jax.numpy", "ratilqr_tpu.ops"]


def test_harness_imports_no_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.run, portbench.calibrate;"
            "from portbench.harness import cell, judge, registry, spans, "
            "stats, trace, traffic;"
            "import ratilqr_tpu_torch.models, ratilqr_tpu_torch.config, "
            "ratilqr_tpu_torch.solvers.ileqg, "
            "ratilqr_tpu_torch.utils.profiling;"
            "[registry.metric_reader(m['name']) for m in "
            "registry.load_benchmark()['per_layer']];"
            "print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(CHECKOUT)],
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_nothing_reads_the_jax_benchmarks():
    for path in PORTBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks" not in text and "bench.py" not in text, path


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this sandbox's check: a card is present")
    rc = run.main(["--workload", "quadrotor_fused_warm_262k", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder the run exits non-zero and prints no result."""
    checkout(tmp_path, with_program=False)
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "quadrotor_fused_warm_262k", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout == ""


def _trace_events():
    """A synthetic Chrome trace: a window of 100 µs, a stage span between
    two markers with two device ops in it, one plain op outside."""
    X = "X"
    return [
        {"ph": X, "cat": "user_annotation", "name": "pb.window", "ts": 0,
         "dur": 100},
        {"ph": X, "cat": "user_annotation", "name": "pb.replan", "ts": 0,
         "dur": 100},
        {"ph": X, "cat": "user_annotation", "name": "pb.step_optimize",
         "ts": 5, "dur": 40},
        {"ph": X, "cat": "kernel", "name": "at::cuda::spin_kernel(long)",
         "ts": 10, "dur": 1},
        {"ph": X, "cat": "kernel", "name": "void step_team_kernel<float>()",
         "ts": 12, "dur": 20},
        {"ph": X, "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 33,
         "dur": 5},
        {"ph": X, "cat": "kernel", "name": "at::cuda::spin_kernel(long)",
         "ts": 40, "dur": 1},
        {"ph": X, "cat": "kernel", "name": "elementwise_kernel", "ts": 60,
         "dur": 10},
    ]


def test_trace_reduction_and_readers():
    data, brk = reduce(_trace_events(), [("step", (12, 4, 50, 1000))],
                       replans=1, host_syncs=[7], dtype="float32")
    assert data.window_s == pytest.approx(1e-4)
    assert data.busy_s == pytest.approx(35e-6)
    assert data.stage_calls == [StageCall("step", (12, 4, 50, 1000),
                                          pytest.approx(25e-6))]
    read = {m: registry.metric_reader(m).read(data) for m in
            ("host_syncs_per_replan", "plain_device_ms_per_replan",
             "device_idle_pct", "step_roofline", "trial_roofline")}
    assert read["host_syncs_per_replan"] == 7
    assert read["plain_device_ms_per_replan"] == pytest.approx(0.015)
    assert read["device_idle_pct"] == pytest.approx(65.0)
    assert read["trial_roofline"] is None       # no trial in the window
    from portbench.metrics.work import bound_s
    assert read["step_roofline"] == pytest.approx(
        100 * bound_s("step", 12, 4, 50, 1000)[0] / 25e-6)
    names = [n for n, _ in brk["device_ops"]]
    assert names[0].startswith("void step_team_kernel")
    assert "spin_kernel" not in " ".join(names)
    # gaps 0-12 and 32-33 inside the step's span, 38-60 and 70-100 in
    # the re-plan's
    idle = dict(brk["idle_gaps"])
    assert idle == {"step_optimize": pytest.approx(13e-6),
                    "replan": pytest.approx(52e-6)}


def test_unpaired_markers_give_no_roofline():
    events = [e for e in _trace_events() if e["ts"] != 40]
    data, _ = reduce(events, [("step", (12, 4, 50, 1000))], replans=1,
                     host_syncs=[], dtype="float32")
    assert data.stage_calls is None
    assert registry.metric_reader("step_roofline").read(data) is None
    assert registry.metric_reader("host_syncs_per_replan").read(data) is None


def test_empty_trace_reads_nothing():
    data = TraceData(replans=1, window_s=1.0, busy_s=0.0, device_ops=[],
                     stage_calls=[], host_syncs=[], dtype="float32")
    for m in registry.load_benchmark()["per_layer"]:
        assert registry.metric_reader(m["name"]).read(data) is None, m


def test_device_op_fields():
    op = DeviceOp("k", 1.0, 2.0)
    assert (op.name, op.start_us, op.dur_us) == ("k", 1.0, 2.0)
    assert Path(run.__file__).parent == PORTBENCH


def test_every_judged_lane_is_held_to_its_l_L_flag_and_count():
    from portbench.harness import judge
    J, T, m, n = 3, 2, 1, 1
    ref = judge.Lanes(torch.ones(J, T, m), torch.ones(J, T, m, n),
                      torch.ones(J), torch.ones(J, dtype=torch.int32),
                      torch.zeros(J, dtype=torch.bool))
    out = judge.Lanes(ref.l * torch.tensor([1.0, 1.5, 1.0])[:, None, None],
                      ref.L.clone(), ref.value.clone(), ref.iterations.clone(),
                      ref.failed.clone())
    nums = judge.numbers(out, ref)
    assert nums["l_gap"] == pytest.approx(0.5) and nums["L_gap"] == 0.0
    assert nums["worst_position"] == 1
    flipped = out._replace(failed=torch.tensor([False, False, True]))
    assert judge.numbers(flipped, ref)["L_gap"] == float("inf")
    other_count = out._replace(iterations=torch.tensor([1, 1, 2],
                                                       dtype=torch.int32))
    assert judge.numbers(other_count, ref)["L_gap"] == float("inf")
