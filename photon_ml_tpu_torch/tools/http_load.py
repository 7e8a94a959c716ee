"""Closed-loop HTTP load for a scoring server, from a process of its own.

    python photon_ml_tpu_torch/tools/http_load.py --port PORT --bodies FILE \
        --out FILE [--clients 8] [--min-requests 2000]

``--bodies`` holds one JSON request body a line (``{"rows": [...]}``).
``--clients`` threads each hold one keep-alive connection to
``127.0.0.1:PORT`` and POST ``/v1/score`` in a closed loop, taking the
bodies in turn (cycling), until a line ``stop`` (or end of file) arrives on
standard input and at least ``--min-requests`` answers have come back. One
line ``ready`` is printed to standard output as the first request leaves,
then one line ``<answers so far> <model_version>`` for each answer as it
arrives, so that the caller can follow the traffic. At the end
``--out`` receives one JSON object: ``records``, one
``[body index, model_version, seconds, scores]`` per answer in the order
they came back, and ``failures``; then ``end`` is printed.

The clients share no interpreter with the server, so the latencies hold the
server's own work and the wire's, not the load generator's (the bodies are
encoded once, before the first request). The file imports the standard
library only and is run by its path, so that no package is imported.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time


def run(port: int, bodies: list[bytes], clients: int, min_requests: int,
        stop: threading.Event, emit=print) -> tuple[list, list]:
    """Drive ``clients`` closed-loop connections over ``bodies`` until
    ``stop`` is set and ``min_requests`` answers have come back; returns the
    records (in the order they came back) and the failures."""
    lock = threading.Lock()
    state = {"next": 0}
    records, failures = [], []

    def connect():
        return http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def client():
        conn = connect()
        try:
            while True:
                with lock:
                    if stop.is_set() and len(records) >= min_requests:
                        return
                    i = state["next"] % len(bodies)
                    state["next"] += 1
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/v1/score", body=bodies[i],
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                except (OSError, http.client.HTTPException) as e:
                    with lock:
                        failures.append(repr(e))
                    conn.close()
                    conn = connect()
                    continue
                dt = time.perf_counter() - t0
                if resp.status != 200:
                    with lock:
                        failures.append(f"HTTP {resp.status}: {data[:200]!r}")
                    continue
                got = json.loads(data)
                with lock:
                    records.append([i, got["model_version"], dt, got["scores"]])
                    emit(f"{len(records)} {got['model_version']}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    emit("ready")
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return records, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--bodies", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--min-requests", type=int, default=2000)
    args = ap.parse_args(argv)
    with open(args.bodies, "rb") as f:
        bodies = [line.rstrip(b"\n") for line in f if line.strip()]
    stop = threading.Event()

    def watch_stdin():
        for line in sys.stdin:
            if line.strip() == "stop":
                break
        stop.set()

    threading.Thread(target=watch_stdin, daemon=True).start()

    def emit(line: str) -> None:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()

    records, failures = run(args.port, bodies, args.clients, args.min_requests, stop, emit)
    with open(args.out, "w") as f:
        json.dump({"records": records, "failures": failures}, f)
    emit("end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
