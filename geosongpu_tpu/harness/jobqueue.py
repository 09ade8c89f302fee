"""Managed-job submission + state polling (the sbatch/sacct analog).

The reference submits through SLURM and polls accounting until a
terminal state (`sbatch` + the `sacct -j <id>` loop,
/root/reference/src/tcn/ci/utils/shell.py:86-100).  This module gives
the harness the same submit -> poll -> terminal-state contract over a
backend protocol (submit / state / cancel):

* ``LocalBackend`` - detached process + pid polling (the single-host
  path, wrapping harness/shell.py; what every test/CI lane uses).

States mirror the reference's sacct vocabulary: PENDING (queued /
provisioning), RUNNING, COMPLETED, FAILED, CANCELLED.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .progress import Progress


class JobState:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    TERMINAL = (COMPLETED, FAILED, CANCELLED)


@dataclass
class JobHandle:
    job_id: str
    backend: str
    meta: Dict = field(default_factory=dict)


class JobQueueError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# local backend (detach + pid poll; the single-host path)
# --------------------------------------------------------------------------

class LocalBackend:
    name = "local"

    def __init__(self, working_directory: str = "."):
        self.wd = working_directory
        self._final: Dict[str, str] = {}

    def submit(self, commands: List[str], job_name: str = "job"
               ) -> JobHandle:
        from .shell import ShellScript

        sh = ShellScript(job_name, self.wd)
        # success sentinel: ShellScript runs `set -e`, so the last line
        # only executes if every command succeeded - the fallback signal
        # when something else (a test harness, a SIGCHLD consumer) reaps
        # the pid before our WNOHANG poll sees the status
        ok_file = os.path.join(self.wd, f".{job_name}.ok")
        if os.path.exists(ok_file):
            os.unlink(ok_file)
        sh.write(list(commands) + [f"touch {ok_file}"])
        pid = sh.execute_detached(
            log_path=os.path.join(self.wd, f"{job_name}.log"))
        return JobHandle(job_id=str(pid), backend=self.name,
                         meta={"ok_file": ok_file})

    def state(self, h: JobHandle) -> str:
        if h.job_id in self._final:
            return self._final[h.job_id]
        pid = int(h.job_id)
        try:
            # we are the parent of the detached script: a WNOHANG reap
            # both detects exit AND returns the exit status (zombies
            # would otherwise still answer kill(pid, 0))
            done, status = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            # already reaped elsewhere: fall back to the success sentinel
            ok = os.path.exists(h.meta.get("ok_file", ""))
            self._final[h.job_id] = (JobState.COMPLETED if ok
                                     else JobState.FAILED)
            return self._final[h.job_id]
        if done == 0:
            return JobState.RUNNING
        ok = (os.waitstatus_to_exitcode(status) == 0
              or os.path.exists(h.meta.get("ok_file", "")))
        self._final[h.job_id] = (JobState.COMPLETED if ok
                                 else JobState.FAILED)
        return self._final[h.job_id]

    def cancel(self, h: JobHandle) -> None:
        if h.job_id in self._final:
            return
        try:
            # the detached script runs in its own session (pid == pgid):
            # signal the exact group we created, never by pattern
            os.killpg(int(h.job_id), 15)
        except ProcessLookupError:
            pass


# --------------------------------------------------------------------------
# the poll loop (the reference's sacct loop)
# --------------------------------------------------------------------------

def wait_for_job(backend, handle: JobHandle, poll_s: float = 10.0,
                 timeout_s: Optional[float] = None,
                 progress_every: int = 6) -> str:
    """Poll until a terminal state; returns it.  Raises JobQueueError on
    timeout (after cancelling), mirroring the reference's behavior of
    surfacing stuck SLURM jobs rather than hanging the pipeline."""
    t0 = time.monotonic()
    i = 0
    while True:
        st = backend.state(handle)
        if st in JobState.TERMINAL:
            return st
        if timeout_s is not None and time.monotonic() - t0 > timeout_s:
            backend.cancel(handle)
            raise JobQueueError(
                f"job {handle.job_id} timed out after {timeout_s}s "
                f"(last state {st})")
        if i % progress_every == 0:
            Progress.log(f"job {handle.job_id}: {st} "
                         f"({time.monotonic() - t0:.0f}s)")
        i += 1
        time.sleep(poll_s)
