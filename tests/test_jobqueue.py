"""Managed-job submission/polling (the sbatch+sacct analog).

Reference behavior under test: submit -> poll-until-terminal -> surface
failures (/root/reference/src/tcn/ci/utils/shell.py:86-100).  The local
backend runs real detached processes; the poll loop also runs against a
scripted fake backend (the serializer-injection test pattern)."""
import time

import pytest

from geosongpu_tpu.harness.jobqueue import (JobHandle, JobQueueError,
                                            JobState, LocalBackend,
                                            wait_for_job)


def test_local_backend_completes(tmp_path):
    be = LocalBackend(str(tmp_path))
    h = be.submit(["echo hello", "sleep 0.3", "echo done"], "okjob")
    st = wait_for_job(be, h, poll_s=0.1, timeout_s=30)
    assert st == JobState.COMPLETED
    log = (tmp_path / "okjob.log").read_text()
    assert "hello" in log and "done" in log


def test_local_backend_failure_surfaces(tmp_path):
    be = LocalBackend(str(tmp_path))
    h = be.submit(["echo start", "false"], "failjob")
    st = wait_for_job(be, h, poll_s=0.1, timeout_s=30)
    assert st == JobState.FAILED


def test_local_backend_timeout_cancels(tmp_path):
    be = LocalBackend(str(tmp_path))
    h = be.submit(["sleep 60"], "slowjob")
    with pytest.raises(JobQueueError):
        wait_for_job(be, h, poll_s=0.1, timeout_s=0.5)
    # the cancel really killed it
    time.sleep(0.3)
    assert be.state(h) in (JobState.FAILED, JobState.COMPLETED)


class _ScriptedBackend:
    """Fake backend: replays a scripted state sequence, records cancels."""

    name = "scripted"

    def __init__(self, states):
        self.states = list(states)
        self.cancelled = []

    def submit(self, commands, job_name="job"):
        return JobHandle(job_id=f"{job_name}-1", backend=self.name)

    def state(self, h):
        return self.states.pop(0) if len(self.states) > 1 else self.states[0]

    def cancel(self, h):
        self.cancelled.append(h.job_id)


def test_wait_for_job_polls_through_pending_and_running():
    be = _ScriptedBackend([JobState.PENDING, JobState.PENDING,
                           JobState.RUNNING, JobState.COMPLETED])
    h = be.submit(["python bench.py"], "hsrun")
    assert wait_for_job(be, h, poll_s=0.01, timeout_s=10) == \
        JobState.COMPLETED
    assert be.states == [JobState.COMPLETED] and not be.cancelled


def test_wait_for_job_surfaces_failed_state_and_timeout():
    be = _ScriptedBackend([JobState.PENDING, JobState.FAILED])
    h = be.submit(["exit 1"], "bad")
    assert wait_for_job(be, h, poll_s=0.01, timeout_s=5) == JobState.FAILED
    stuck = _ScriptedBackend([JobState.RUNNING])
    h = stuck.submit(["sleep 100"], "stuck")
    with pytest.raises(JobQueueError, match="timed out"):
        wait_for_job(stuck, h, poll_s=0.01, timeout_s=0.05)
    assert stuck.cancelled == [h.job_id]
