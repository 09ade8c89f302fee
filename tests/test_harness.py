"""Harness + observability subsystem tests (the reference had none of
these: SURVEY.md SS4 'no unit tests for parser/report/hws analysis')."""
import json
import os

import numpy as np
import pytest

from geosongpu_tpu.benchmark.timing import BenchmarkRecord, compare, report
from geosongpu_tpu.harness.exceptions import CICheckException
from geosongpu_tpu.harness.registry import Registry
from geosongpu_tpu.harness.task import PipelineAction, dispatch, get_config


def test_registry_roundtrip():
    @Registry.register
    class _TestTaskXyz:
        pass

    assert Registry.get("_TestTaskXyz") is _TestTaskXyz
    with pytest.raises(KeyError):
        Registry.get("definitely_not_registered")


def test_experiment_lookup():
    cfg = get_config("held_suarez_c12")
    assert cfg["tasks"] == ["HeldSuarez"]
    with pytest.raises(KeyError):
        get_config("nope")


def test_heartbeat_dispatch(tmp_path):
    env = dispatch("ci-heartbeat", PipelineAction.All,
                   artifact_directory=str(tmp_path / "art"),
                   workspace=str(tmp_path / "ws"))
    assert os.path.isfile(tmp_path / "ws" / "ci_metadata")
    assert os.path.isfile(tmp_path / "art" / "ci_metadata")


def test_benchmark_record_roundtrip(tmp_path):
    rec = BenchmarkRecord(experiment="x", backend="cpu",
                          grid={"npx": 48, "npz": 32},
                          step_time_s=[0.1, 0.2, 0.15])
    assert rec.median_step_s == 0.15
    assert rec.grid_points == 6 * 48 * 48 * 32
    p = str(tmp_path / "r.json")
    rec.save(p)
    back = BenchmarkRecord.load(p)
    assert back.median_step_s == rec.median_step_s
    txt = report([rec, back])
    assert "median step" in txt
    c = compare(rec, back)
    assert abs(c["speedup_total_run"] - 1.0) < 1e-9


# nvidia-smi --query-gpu=power.draw,memory.used,utilization.gpu
#            --format=csv,noheader,nounits   on one H100, idle then loaded
_SMI_LINES = [["71.23, 0, 0"], ["402.87, 61234, 97"], ["398.10, 61234, 100"]]


def test_hws_sampler_and_energy(tmp_path):
    from geosongpu_tpu.hws.analysis import energy_envelope, load_data
    from geosongpu_tpu.hws.server import Sampler

    ticks = iter(_SMI_LINES * 7)
    s = Sampler(rate_s=0.01, reader=lambda: next(ticks))
    for _ in range(20):
        s.sample_once()
    s.tick()
    path = s.dump(str(tmp_path))
    data = load_data(path)
    assert len(data["cpu_psu"]) == 20
    assert data["gpu_psu"][1] == np.float64(402.87)
    rep = energy_envelope(data)
    assert rep.cpu_joules > 0
    # measured power integrated over 19 intervals of 0.01 s
    assert abs(rep.gpu_joules - np.trapezoid(data["gpu_psu"], dx=0.01)) \
        < 1e-9
    assert rep.gpu_joules > 0.19 * 71.0
    assert rep.total_kwh >= rep.cpu_kwh + rep.gpu_kwh - 1e-15


def test_parse_recorded_nvidia_smi_lines():
    from geosongpu_tpu.hws.server import parse_nvidia_smi

    # four cards of one host: power and memory add, utilization averages
    lines = ["402.87, 61234, 97", "398.10, 61000, 100",
             "101.50, 1024, 3", "[N/A], 0, 0"]
    power, mem, util = parse_nvidia_smi(lines[:3])
    assert abs(power - 902.47) < 1e-9
    assert mem == 61234 + 61000 + 1024
    assert abs(util - 200.0 / 3) < 1e-9
    assert np.isnan(parse_nvidia_smi(lines[3:])[0])
    with pytest.raises(ValueError):
        parse_nvidia_smi(["No devices were found"])


def test_validation_analysis(tmp_path):
    from geosongpu_tpu.validation.analysis import analysis, check_tolerance

    rng = np.random.default_rng(0)
    a = {"t": rng.standard_normal((6, 8, 8)).astype(np.float32)}
    b = {"t": a["t"] + 1e-6}
    rep = analysis(a, b, "t")
    assert rep.rel_rms < 1e-4
    assert check_tolerance(a, b, ["t"], rel_tol=1e-4)
    bad = {"t": a["t"] + 0.5}
    assert not check_tolerance(a, bad, ["t"], rel_tol=1e-4)


def test_plot_field(tmp_path):
    from geosongpu_tpu.plots.plot_field import plot

    a = np.random.default_rng(0).standard_normal((6, 8, 8, 4))
    out = plot(a, "testvar", out_png=str(tmp_path / "f.png"))
    assert os.path.isfile(out)
    out2 = plot(a, "testvar", diff_with=a, out_png=str(tmp_path / "d.png"))
    assert os.path.isfile(out2)


def test_run_status():
    from geosongpu_tpu.validation.run_status import capture

    st = capture({"a": 1}, repo_dir="/root/repo")
    assert st.git_sha and len(st.git_sha) >= 7
    st2 = capture({"a": 1}, repo_dir="/root/repo")
    assert st.config_hash == st2.config_hash


def test_sharded_experiment_dispatch(tmp_path):
    """MeshConfig is honored by the pipeline: the held_suarez_c16_sharded
    experiment declares a (2, 4) faces-local mesh and dispatch must run it
    SPMD over the 8 virtual devices end-to-end - the layout is part of the
    experiment, as in the reference's per-resolution rank layouts
    (/root/reference/src/tcn/ci/pipeline/held_suarez.py:272-377)."""
    env = dispatch("held_suarez_c16_sharded", PipelineAction.Validation,
                   artifact_directory=str(tmp_path / "art"),
                   workspace=str(tmp_path / "ws"))
    rec = env.get("hs.record")
    assert rec.extra["mesh"] == "subtile faces-local (2,4), 8 devices"
    # gates ran on the recovered global state
    state = env.get("hs.final_state")
    assert np.asarray(state.u).shape[0] == 6
    assert np.isfinite(np.asarray(state.u)).all()


def test_device_busy_share_of_synthetic_trace():
    """The trace reduction on a hand-made plane list: union of the GPU
    stream intervals (overlaps across streams counted once), host planes
    and non-stream lines ignored; no device lane is an error."""
    from types import SimpleNamespace as NS

    from geosongpu_tpu.hws.xprof_util import busy_share, device_intervals

    ev = lambda start, dur: NS(start_ns=start, duration_ns=dur)
    planes = [
        NS(name="/host:CPU", lines=[
            NS(name="python", events=[ev(0, 10_000)])]),
        NS(name="/device:GPU:0", lines=[
            NS(name="Stream #13(Compute)",
               events=[ev(1_000, 2_000), ev(5_000, 1_000)]),
            NS(name="Stream #14(MemcpyD2H)", events=[ev(2_500, 1_000)]),
            NS(name="XLA Modules", events=[ev(1_000, 8_000)]),
        ]),
    ]
    iv = device_intervals(planes)
    assert iv == [(1_000, 3_000), (2_500, 3_500), (5_000, 6_000)]
    got = busy_share(iv)
    assert got["busy_s"] == 3_500 / 1e9      # [1000,3500] + [5000,6000]
    assert got["span_s"] == 5_000 / 1e9
    assert got["busy_share"] == 0.7
    with pytest.raises(ValueError):
        busy_share(device_intervals(planes[:1]))
