"""hws CLI (parity: /root/reference/src/tcn/hws/cli.py:11-60:
server | client CMD | graph FILE | envelop FILE --data_range a b)."""
from __future__ import annotations

import argparse

from . import constants as C


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="geosongpu-tpu-hws")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server")
    s.add_argument("--rate", type=float, default=C.DEFAULT_SAMPLE_RATE_S)
    s.add_argument("--socket_dir", default=None)
    s.add_argument("--dump_dir", default=".")

    c = sub.add_parser("client")
    c.add_argument("order", choices=list(C.ORDERS))
    c.add_argument("--socket_dir", default=None)

    g = sub.add_parser("graph")
    g.add_argument("file")
    g.add_argument("--out", default=None)

    e = sub.add_parser("envelop")
    e.add_argument("file")
    e.add_argument("--data_range", type=float, nargs=2, default=None,
                   help="start/end seconds (converted via sample rate)")

    args = p.parse_args(argv)

    if args.cmd == "server":
        from .server import cli as server_cli

        server_cli(args.socket_dir, args.rate, args.dump_dir)
        return 0
    if args.cmd == "client":
        from .client import client_main

        reply = client_main(args.order, args.socket_dir)
        print(reply)
        return 0
    if args.cmd == "graph":
        from .graph import graph

        graph(args.file, args.out)
        return 0
    if args.cmd == "envelop":
        from .analysis import energy_envelope, load_data

        data = load_data(args.file)
        start, end = 0, None
        if args.data_range:
            rate = float(data["rate_s"][0])
            start = int(args.data_range[0] / rate)
            end = int(args.data_range[1] / rate)
        rep = energy_envelope(data, start, end)
        print(f"cpu: {rep.cpu_kwh*1e3:.3f} Wh, gpu: {rep.gpu_kwh*1e3:.3f} Wh, "
              f"total: {rep.total_kwh*1e3:.3f} Wh")
        return 0
    return 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
