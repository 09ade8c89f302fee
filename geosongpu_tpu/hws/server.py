"""Hardware sampling server: asyncio unix-socket service.

Parity with /root/reference/src/tcn/hws/server.py:35-151 (START spawns a
sampling coroutine, DUMP writes npz/json, TICK marks indices, STOP exits).
The reference reads NVML every tick; here each tick runs

    nvidia-smi --query-gpu=power.draw,memory.used,utilization.gpu
               --format=csv,noheader,nounits

which reads the same counters without loading JAX, so the sampler never
becomes a second process on the card.  Fields:

  gpu_psu       measured power.draw [W], summed over the host's GPUs
  gpu_mem_mb    memory.used [MiB], summed over the host's GPUs
  gpu_util      utilization.gpu [%], mean over the host's GPUs
  cpu_exe_utl   psutil.cpu_percent
  cpu_psu       idle + utilization * (tdp - idle)   [reference's model]
  host_mem_pct  psutil.virtual_memory().percent

The exact device busy share of a window comes from a profiler trace
(hws.xprof_util.device_busy).
"""
from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import psutil

from . import constants as C

FIELDS = ("gpu_psu", "gpu_mem_mb", "gpu_util", "cpu_exe_utl", "cpu_psu",
          "host_mem_pct")

NVIDIA_SMI_QUERY = ("--query-gpu=power.draw,memory.used,utilization.gpu",
                    "--format=csv,noheader,nounits")


def read_nvidia_smi() -> List[str]:
    """One CSV line per GPU: `power.draw, memory.used, utilization.gpu`."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise FileNotFoundError("nvidia-smi not found: the hardware "
                                "sampler reads GPU power from it")
    out = subprocess.run([exe, *NVIDIA_SMI_QUERY], capture_output=True,
                         text=True, check=True, timeout=10)
    return out.stdout.strip().splitlines()


def parse_nvidia_smi(lines: Sequence[str]) -> Tuple[float, float, float]:
    """(total power W, total memory MiB, mean utilization %) over the GPUs
    in `lines`; a field nvidia-smi reports as `[N/A]` reads as NaN."""
    def num(x: str) -> float:
        x = x.strip()
        return float("nan") if x.startswith("[") else float(x)

    rows = [[num(x) for x in ln.split(",")] for ln in lines if ln.strip()]
    if not rows or any(len(r) != 3 for r in rows):
        raise ValueError(f"unexpected nvidia-smi output: {list(lines)!r}")
    power, mem, util = zip(*rows)
    return sum(power), sum(mem), sum(util) / len(util)


class Sampler:
    """reader: returns nvidia-smi's CSV lines (default: run nvidia-smi;
    tests inject recorded lines).  Raises FileNotFoundError when the
    default reader has no nvidia-smi to run."""

    def __init__(self, rate_s: float = C.DEFAULT_SAMPLE_RATE_S,
                 reader: Optional[Callable[[], List[str]]] = None):
        if reader is None and shutil.which("nvidia-smi") is None:
            raise FileNotFoundError("nvidia-smi not found: the hardware "
                                    "sampler reads GPU power from it")
        self.rate_s = rate_s
        self.reader = reader or read_nvidia_smi
        self.data: Dict[str, List[float]] = {k: [] for k in FIELDS}
        self.ticks: List[int] = []
        self.running = False

    def _read_row(self) -> Tuple[float, ...]:
        cpu = psutil.cpu_percent(interval=None)
        cpu_psu = C.CPU_SPEC["idle_w"] + cpu / 100.0 * (
            C.CPU_SPEC["tdp_w"] - C.CPU_SPEC["idle_w"])
        mem = psutil.virtual_memory().percent
        gpu_psu, gpu_mem, gpu_util = parse_nvidia_smi(self.reader())
        return (gpu_psu, gpu_mem, gpu_util, cpu, cpu_psu, mem)

    def _append(self, row: Tuple[float, ...]) -> None:
        for k, v in zip(FIELDS, row):
            self.data[k].append(v)

    def sample_once(self) -> None:
        self._append(self._read_row())

    async def run(self) -> None:
        self.running = True
        while self.running:
            # nvidia-smi blocks for tens of ms: read it off the event
            # loop, append on it (DUMP never sees a half-appended row)
            self._append(await asyncio.to_thread(self._read_row))
            await asyncio.sleep(self.rate_s)

    def tick(self) -> None:
        self.ticks.append(len(self.data[FIELDS[0]]))

    def dump(self, directory: str = ".") -> str:
        os.makedirs(directory, exist_ok=True)
        if C.DUMP_FORMAT == "json":
            path = os.path.join(directory, "hws_dump.json")
            with open(path, "w") as f:
                json.dump({"data": self.data, "ticks": self.ticks,
                           "rate_s": self.rate_s}, f)
        else:
            path = os.path.join(directory, "hws_dump.npz")
            np.savez_compressed(
                path,
                ticks=np.asarray(self.ticks),
                rate_s=np.asarray([self.rate_s]),
                **{k: np.asarray(v) for k, v in self.data.items()})
        return path


async def main(socket_dir: str | None = None,
               rate_s: float = C.DEFAULT_SAMPLE_RATE_S,
               dump_dir: str = ".") -> None:
    sampler = Sampler(rate_s)
    task: asyncio.Task | None = None
    stop_event = asyncio.Event()

    async def handle(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        nonlocal task
        raw = await reader.read(4096)
        try:
            order = json.loads(raw.decode()).get("order")
        except Exception:
            order = None
        reply = {"status": "ok", "order": order}
        if order == C.ORDER_START:
            if task is None:
                task = asyncio.get_event_loop().create_task(sampler.run())
        elif order == C.ORDER_TICK:
            sampler.tick()
        elif order == C.ORDER_DUMP:
            reply["path"] = sampler.dump(dump_dir)
        elif order == C.ORDER_STOP:
            sampler.running = False
            if task is not None:
                await asyncio.sleep(0)
            stop_event.set()
        else:
            reply["status"] = "unknown-order"
        writer.write(json.dumps(reply).encode())
        await writer.drain()
        writer.close()

    sdir = socket_dir or C.SOCKET_DIRECTORY
    os.makedirs(sdir, exist_ok=True)
    path = C.socket_path(sdir)
    if os.path.exists(path):
        os.unlink(path)
    server = await asyncio.start_unix_server(handle, path=path)
    async with server:
        await stop_event.wait()
    if os.path.exists(path):
        os.unlink(path)


def cli(socket_dir: str | None = None,
        rate_s: float = C.DEFAULT_SAMPLE_RATE_S, dump_dir: str = ".") -> None:
    asyncio.run(main(socket_dir, rate_s, dump_dir))
