"""One port data-plane daemon in its own OS process, on the CPU.

Run as ``python tests/torch_daemon_worker.py``: the process is "one
executor host" of ``tests/test_torch_multidaemon_processes.py``, with its
own interpreter, its own membership registry and its own device state, so
a fit across two such daemons reduces through the driver's hub. Prints
``READY <port>`` once listening and serves until its stdin closes (the
parent's handle drop stops it, so an aborted test leaks no process). It
imports only the port, never the JAX package.

``--state-dir DIR`` makes it a durable daemon (``tests/test_torch_durability.py``
SIGKILLs one and restarts it on the same directory); ``--port N`` binds N.
"""

import argparse
import sys


def main() -> None:
    import torch

    torch.set_num_threads(1)
    from spark_rapids_ml_tpu_torch.serve.daemon import DataPlaneDaemon

    ap = argparse.ArgumentParser()
    ap.add_argument("--state-dir", default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    daemon = DataPlaneDaemon(host="127.0.0.1", port=args.port, device="cpu", ttl=600.0,
                             state_dir=args.state_dir).start()
    print(f"READY {daemon.address[1]}", flush=True)
    sys.stdin.read()  # until the parent closes our stdin
    daemon.stop()


if __name__ == "__main__":
    main()
