"""One peer of a cell: `python -m portbench.peer '<json>'`, started by
run.py. It builds the peer's training state from the seed, joins the ring,
runs the traffic's loop (loops/<mode>.py) through set-up, the checked
first steps and the measured window, and prints its record as the last
line of standard output: PORTBENCH_PEER <json>.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import importlib
import json
import os
import sys

from portbench.guard import forbidden_modules


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def connect(spec: dict):
    """A Communicator on the launcher's master, at this peer's base port
    (p2p, shared state and bench at base, base+4, base+8), once the world
    holds every peer of the cell."""
    from pccl_tpu_torch.comm import Communicator

    base = spec["base_port"]
    comm = Communicator("127.0.0.1", spec["master_port"], p2p_port=base,
                        ss_port=base + 4, bench_port=base + 8)
    comm.connect()
    deadline = time.time() + 180
    while comm.world_size < spec["world"]:
        if time.time() > deadline:
            raise TimeoutError(f"the world never reached {spec['world']}")
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.01)
    return comm


def main(argv) -> int:
    spec = json.loads(argv[1])
    import torch

    if spec["device"] == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = spec["traffic"]["mode"]
    loop = importlib.import_module(f"portbench.loops.{mode}")
    t_imported = time.time()
    record = loop.run(spec, dev)
    record["setup_marks"] = {"process": T_PROCESS, "imported": t_imported,
                             **record.get("setup_marks", {})}
    record["rank"] = spec["rank"]
    record["pid"] = os.getpid()
    record["forbidden"] = forbidden_modules(sys.modules)
    if dev.type == "cuda":
        record["mem_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    sys.stdout.write("PORTBENCH_PEER " + json.dumps(record) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
