"""Standalone master runner: ``python -m pccl_tpu_torch.comm.master --port 48500``.

``--journal PATH`` enables master HA: state is write-ahead-logged to PATH and
a restarted master on the same journal resumes the same world view.
"""

from __future__ import annotations

import argparse
import signal
import sys

from .api import MasterNode


def main() -> int:
    ap = argparse.ArgumentParser(description="pccl_tpu_torch master node")
    ap.add_argument("--listen", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=48500)
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="HA journal path; default: the PCCLT_MASTER_JOURNAL "
                         "env var, else disabled")
    args = ap.parse_args()

    m = MasterNode(args.listen, args.port, journal_path=args.journal)
    m.run()
    print(f"master listening on {args.listen}:{m.port} (epoch {m.epoch})",
          flush=True)

    # sigwait instead of a handler: a handler never runs while the main
    # thread blocks inside the foreign await call. Block the signals first
    # or their default disposition still terminates.
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT, signal.SIGTERM})
    signal.sigwait({signal.SIGINT, signal.SIGTERM})
    m.interrupt()
    m.await_termination()
    m.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
