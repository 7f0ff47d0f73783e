"""Cluster preemption (SLURM): checkpoint and requeue on a signal.

The JAX package's utils/cluster.py, with one difference: the SIGTERM and
SIGUSR1 handlers, which set the exit flag that the episode loop polls,
are installed only while `armed()` is entered (ActiveMapper.
test_navigation enters it around the episode) and the handlers found
there are put back when it exits.  The JAX manager installs them when it
is built and keeps them for the life of the process.  `requeue` calls
`scontrol requeue $SLURM_JOB_ID` under SLURM and exits.

In a process group each rank has its own manager and its own flag (a
signal reaches one process; the time budget reads each rank's clock).
The episode loop agrees the flag over the group before it acts on it
(engine/driver.py), and only rank 0 calls scontrol.
"""
from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import time

SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class ClusterStateManager:
    def __init__(self, time_to_run: float | None = None):
        self._exit_requested = False
        self._start = time.time()
        self.time_to_run = time_to_run

    def _handler(self, signum, frame):
        self._exit_requested = True

    @contextlib.contextmanager
    def armed(self):
        """Route SIGTERM and SIGUSR1 to the exit flag inside the block;
        restore the previous handlers after it, also when it raises or
        exits.  Outside the main thread no handler can be set, and the
        block runs with the time budget alone."""
        previous = {}
        try:
            for sig in SIGNALS:
                try:
                    previous[sig] = signal.signal(sig, self._handler)
                except ValueError:          # not the main thread
                    pass
            yield self
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def should_exit(self) -> bool:
        """A signal arrived while armed, or the time budget ran out."""
        if self._exit_requested:
            return True
        return (self.time_to_run is not None
                and time.time() - self._start > self.time_to_run)

    def requeue(self, exit_code: int = 0, call_scontrol: bool = True):
        """`scontrol requeue $SLURM_JOB_ID` under SLURM (unless
        call_scontrol is False: the ranks of a group other than 0), then
        sys.exit(exit_code)."""
        job_id = os.environ.get("SLURM_JOB_ID")
        if job_id and call_scontrol:
            subprocess.call(["scontrol", "requeue", job_id])
        sys.exit(exit_code)


_GLOBAL_CM: ClusterStateManager | None = None


def get_cluster_manager() -> ClusterStateManager:
    """The process's manager, made on first use."""
    global _GLOBAL_CM
    if _GLOBAL_CM is None:
        _GLOBAL_CM = ClusterStateManager()
    return _GLOBAL_CM
