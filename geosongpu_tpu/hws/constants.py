"""Hardware-sampler protocol constants + host CPU spec table.

Parity with /root/reference/src/tcn/hws/constants.py:5-63 (unix socket
path, server orders, client verbs, 0.1 s default rate, spec table selected
by an env var).  GPU power is read from nvidia-smi (hws/server.py), so
only the host CPU keeps the reference's "utilization x TDP, clamped at
idle" model.
"""
from __future__ import annotations

import os

SOCKET_DIRECTORY = "./sockets-runtime"
SOCKET_FILENAME = "hws"

# server orders
ORDER_START = "start"
ORDER_STOP = "stop"
ORDER_DUMP = "dump"
ORDER_TICK = "tick"
ORDERS = (ORDER_START, ORDER_STOP, ORDER_DUMP, ORDER_TICK)

# client verbs == orders (one-shot JSON messages)
CLIENT_CMDS = ORDERS

DEFAULT_SAMPLE_RATE_S = 0.1

DUMP_FORMAT = os.environ.get("HWSAMPLER_DUMP_FORMAT", "npz")  # npz | json

# host CPU spec table: name -> dict(idle_w, tdp_w)
HW_SPECS = {
    "epyc_7402": {"idle_w": 60.0, "tdp_w": 180.0},
    "epyc_7763": {"idle_w": 80.0, "tdp_w": 280.0},
    "generic_host": {"idle_w": 40.0, "tdp_w": 150.0},
}

CPU_SPEC = HW_SPECS[os.environ.get("HWS_HW_CPU", "generic_host")]


def socket_path(directory: str | None = None) -> str:
    d = directory or SOCKET_DIRECTORY
    return os.path.join(d, SOCKET_FILENAME)
