"""GPU job-launch configuration.

Parity with /root/reference/src/tcn/ci/actions/slurm.py:6-92
(SlurmConfiguration dataclass with canned node/GPU layouts emitting srun
command lines) and the per-rank GPU wrapper
(templates/gpu-wrapper-slurm-mps.sh.tpl).  Mapping: one JAX process per
host drives all of its GPUs (no MPS/rank pinning: a second JAX process on
a card would find its memory taken), multi-host runs are launched per
host with coordinator env for `jax.distributed.initialize`; the wrapper
script starts the hardware sampler around the payload the same way the
reference's wrapper brackets the exe with hws client calls.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .shell import ShellScript


@dataclass
class GPUJobConfig:
    """One launch description: hosts x GPUs-per-host + env."""

    hosts: int = 1
    gpus_per_host: int = 1
    coordinator: str = "localhost:8476"
    env: Dict[str, str] = field(default_factory=dict)
    hardware_sampling: bool = False

    # -- canned layouts (the reference's classmethod presets,
    # slurm.py:47-92) ---------------------------------------------------
    @classmethod
    def one_gpu(cls) -> "GPUJobConfig":
        return cls(hosts=1, gpus_per_host=1)

    @classmethod
    def one_host_4gpu(cls) -> "GPUJobConfig":
        return cls(hosts=1, gpus_per_host=4)

    @classmethod
    def two_hosts_4gpu(cls) -> "GPUJobConfig":
        return cls(hosts=2, gpus_per_host=4,
                   env={"JAX_COORDINATOR_PORT": "8476"})

    @property
    def total_gpus(self) -> int:
        return self.hosts * self.gpus_per_host

    def launch_env(self, process_id: int) -> Dict[str, str]:
        env = dict(self.env)
        if self.hosts > 1:
            env.update({
                "JAX_COORDINATOR_ADDRESS": self.coordinator,
                "JAX_NUM_PROCESSES": str(self.hosts),
                "JAX_PROCESS_ID": str(process_id),
            })
        return env

    def wrapper_script(self, payload: List[str], name: str = "gpu_run",
                       wd: str = ".") -> ShellScript:
        """The gpu-wrapper analog: bracket the payload with the hardware
        sampler on process 0 (tpl:8-19,60-68 behavior)."""
        cmds: List[str] = []
        if self.hardware_sampling:
            cmds += [
                'if [ "${JAX_PROCESS_ID:-0}" = "0" ]; then',
                "  python -m geosongpu_tpu.hws.cli server --dump_dir . &",
                "  HWS_PID=$!",
                "  sleep 1",
                "  python -m geosongpu_tpu.hws.cli client start",
                "fi",
            ]
        cmds += list(payload)
        if self.hardware_sampling:
            cmds += [
                'if [ "${JAX_PROCESS_ID:-0}" = "0" ]; then',
                "  python -m geosongpu_tpu.hws.cli client dump",
                "  python -m geosongpu_tpu.hws.cli client stop",
                "  wait ${HWS_PID} 2>/dev/null || true",
                "fi",
            ]
        script = ShellScript(name, wd)
        script.write(cmds, exports=self.launch_env(0))
        return script
