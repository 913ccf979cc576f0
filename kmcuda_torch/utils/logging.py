"""Verbosity-gated logging, stdout-compatible with the reference.

The same lines as ``kmcuda_tpu.utils.logging``: INFO at verbosity > 0,
DEBUG at > 1, TRACE at > 2, plain lines on stdout; warnings always, on
stderr.  The ``iteration %d: %d reassignments`` line is API: test suites
parse it.
"""

import sys


class Logger:
    def __init__(self, verbosity: int = 0):
        self.verbosity = int(verbosity)

    def info(self, msg: str) -> None:
        if self.verbosity > 0:
            print(msg, flush=True)

    def debug(self, msg: str) -> None:
        if self.verbosity > 1:
            print(msg, flush=True)

    def trace(self, msg: str) -> None:
        if self.verbosity > 2:
            print(msg, flush=True)

    def iteration(self, n: int, reassignments: int) -> None:
        """The machine-readable progress line; its format is API."""
        if self.verbosity > 0:
            print("iteration %d: %d reassignments" % (n, reassignments),
                  flush=True)

    def warning(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
