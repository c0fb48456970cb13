"""A process's own peak resident host memory.

`getrusage(RUSAGE_SELF).ru_maxrss` is no such figure for a process started
by another: the kernel keeps the maximum across `execve`, and a child made
by `vfork` (Python's subprocess) starts from its parent's peak, one made by
`fork` from its parent's resident size at the fork. So a peer spawned by a
large launcher reports the launcher's peak until it exceeds it.

Linux reports the high-water mark of the current address space, which
`execve` replaces, as `VmHWM` in /proc/self/status: the process's own.
A kernel that emulates Linux in user space, such as gVisor, keeps
ru_maxrss as Linux does but may have no VmHWM. There a launcher starts the
process through `relay_argv`: a small relay forks it from its own address
space, so that the process's ru_maxrss starts from the relay's few MiB,
not from the launcher's peak.
"""

from __future__ import annotations

import resource
import sys


def peak_rss_mib() -> int:
    """This process's peak resident set size in MiB: VmHWM where the
    kernel reports it, else ru_maxrss (the process's own when it was
    started through relay_argv)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) >> 10    # "VmHWM:  123456 kB"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10


# Forks argv[1:] and waits for it. SIGTERM and SIGINT go on to the child;
# the child gets SIGKILL when the relay dies (PR_SET_PDEATHSIG), and the
# relay ends as the child did: with its exit code, or by its signal.
_RELAY = """\
import ctypes, os, signal, sys
pid = os.fork()
if pid == 0:
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL, 0, 0, 0)
    os.execv(sys.argv[1], sys.argv[1:])
for s in (signal.SIGTERM, signal.SIGINT):
    signal.signal(s, lambda n, _f: os.kill(pid, n))
_, status = os.waitpid(pid, 0)
if os.WIFSIGNALED(status):
    signal.signal(os.WTERMSIG(status), signal.SIG_DFL)
    os.kill(os.getpid(), os.WTERMSIG(status))
sys.exit(os.waitstatus_to_exitcode(status))
"""


def relay_argv(argv: list) -> list:
    """The command line that runs `argv` (its first element an absolute
    path) through the relay, so that its ru_maxrss is its own."""
    return [sys.executable, "-c", _RELAY, *argv]
