"""ShellScript engine: generated, persisted, executed shell scripts.

Parity with /root/reference/src/tcn/ci/utils/shell.py:11-130 (write
executable .sh with env sourcing + modules, execute via subprocess, or
submit-and-poll for batch systems).  JAX runs one process per host, so the sbatch/sacct polling loop becomes a generic
launch-and-poll-pidfile helper used for detached runs (hws servers,
long benchmarks).
"""
from __future__ import annotations

import os
import stat
import subprocess
import time
from typing import List, Optional

from .progress import Progress


class ShellScriptError(RuntimeError):
    pass


def run_subprocess(command: List[str], timeout_s: Optional[float] = None,
                   cwd: Optional[str] = None) -> str:
    """Run, stream-capture, raise on failure (reference shell.py:113-130)."""
    with Progress(f"subprocess: {' '.join(command[:4])}..."):
        r = subprocess.run(command, capture_output=True, text=True,
                           timeout=timeout_s, cwd=cwd)
    if r.returncode != 0:
        raise ShellScriptError(
            f"command failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    return r.stdout


class ShellScript:
    def __init__(self, name: str, working_directory: str = "."):
        self.name = name
        self.wd = os.path.abspath(working_directory)
        self.path = os.path.join(self.wd, f"{self.name}.sh")

    def write(self, shell_commands: List[str],
              env_to_source: Optional[List[str]] = None,
              exports: Optional[dict] = None) -> "ShellScript":
        os.makedirs(self.wd, exist_ok=True)
        lines = ["#!/usr/bin/env bash", "set -euo pipefail", ""]
        for env in env_to_source or []:
            lines.append(f"source {env}")
        for k, v in (exports or {}).items():
            lines.append(f"export {k}={v}")
        lines.append("")
        lines.extend(shell_commands)
        lines.append("")
        with open(self.path, "w") as f:
            f.write("\n".join(lines))
        os.chmod(self.path, os.stat(self.path).st_mode | stat.S_IEXEC)
        return self

    def execute(self, timeout_s: Optional[float] = None) -> str:
        return run_subprocess(["bash", self.path], timeout_s, cwd=self.wd)

    def execute_detached(self, log_path: Optional[str] = None) -> int:
        """Launch in the background; returns the PID (reference's sbatch
        analog - no scheduler between us and the process)."""
        log = open(log_path or os.path.join(self.wd, f"{self.name}.log"), "w")
        proc = subprocess.Popen(["bash", self.path], stdout=log,
                                stderr=subprocess.STDOUT, cwd=self.wd,
                                start_new_session=True)
        return proc.pid

    @staticmethod
    def wait_for_pid(pid: int, poll_s: float = 5.0,
                     timeout_s: Optional[float] = None) -> None:
        """Poll until the detached process exits (the sacct loop analog,
        reference shell.py:86-100).  A finished-but-unreaped child is a
        zombie that still answers kill(pid, 0), so also check the process
        state in /proc."""
        t0 = time.time()
        while True:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return
            try:
                with open(f"/proc/{pid}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
                if state == "Z":
                    try:
                        os.waitpid(pid, os.WNOHANG)
                    except ChildProcessError:
                        pass
                    return
            except FileNotFoundError:
                return
            if timeout_s and time.time() - t0 > timeout_s:
                raise TimeoutError(f"pid {pid} still running after {timeout_s}s")
            time.sleep(poll_s)
