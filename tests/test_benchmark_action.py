"""Benchmark-action pipeline tests (one gated run + its phase tree).

Round-2 verdict: the Benchmark branch of the tasks and measure_phases were
untested in the suite.  These run the full dispatch at smoke size on the
CPU lane.  Reference roles:
held_suarez.py:314-377 (benchmark matrix) and aquaplanet.py:99-178
(action-branched validation vs benchmark).
"""
import json
import os

import numpy as np
import pytest

from geosongpu_tpu.harness.task import dispatch


@pytest.mark.slow
def test_held_suarez_benchmark_action(tmp_path):
    env = dispatch("held_suarez_bench_smoke", "Benchmark",
                   artifact_directory=str(tmp_path / "art"),
                   workspace=str(tmp_path / "ws"))
    records = env.get("hs.records")
    assert len(records) == 1
    rec = records[0]
    assert rec.backend == "cpu"
    assert rec.phase_tree and "phases_ms" in rec.phase_tree
    assert rec.phase_tree["full_step_ms"] > 0
    # the substep stage split is part of the tree
    assert any(k.startswith("substep:")
               for k in rec.phase_tree["phases_ms"])
    assert (tmp_path / "art" / "report_benchmark.out").exists()


@pytest.mark.slow
def test_aquaplanet_benchmark_action(tmp_path):
    env = dispatch("aquaplanet_bench_smoke", "Benchmark",
                   artifact_directory=str(tmp_path / "art"),
                   workspace=str(tmp_path / "ws"))
    records = env.get("aq.records")
    assert len(records) == 1
    assert records[0].backend == "cpu"
    for r in records:
        assert r.phase_tree and r.phase_tree["full_step_ms"] > 0
        # the moist physics chain is its own measured leaf
        assert "forcing/physics" in r.phase_tree["phases_ms"]
    assert (tmp_path / "art" / "report_benchmark.out").exists()


def test_aquaplanet_validation_action(tmp_path):
    env = dispatch("aquaplanet_bench_smoke", "Validation",
                   artifact_directory=str(tmp_path / "art"),
                   workspace=str(tmp_path / "ws"))
    records = env.get("aq.records")
    assert len(records) == 1
    assert records[0].phase_tree is None
