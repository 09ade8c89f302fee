"""Maintenance tasks (parity:
/root/reference/src/tcn/ci/pipeline/ci_clean.py:12-33 and ci_info.py:9-30;
the SLURM-cancel task has no analog - one JAX process per host).
"""
from __future__ import annotations

import os
import shutil

from ..environment import Environment
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase


@Registry.register
class CIClean(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        ws = env.CI_WORKSPACE
        if os.path.isdir(ws):
            shutil.rmtree(ws)
        os.makedirs(ws, exist_ok=True)

    def check(self, config, env: Environment) -> bool:
        ws = env.CI_WORKSPACE
        return os.path.isdir(ws) and not os.listdir(ws)


@Registry.register
class CIInfo(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        import jax

        ws = env.CI_WORKSPACE
        usage = shutil.disk_usage(ws if os.path.isdir(ws) else "/")
        Progress.log(f"devices: {jax.devices()}")
        Progress.log(
            f"disk: {usage.used / 1e9:.1f} / {usage.total / 1e9:.1f} GB used")
        env.set("ci_info.devices", str(jax.devices()))

    def check(self, config, env: Environment) -> bool:
        return env.exists("ci_info.devices")
