"""R008 fixture (port form): the admission path reads the wall clock.

The pool's eviction age uses ``time.monotonic()`` instead of the
transaction's modeled submit time, so the admitted set depends on host
scheduling and the recorded admission log stops replaying."""
import time


class PendingPool:
    def __init__(self, cap):
        self.cap, self.entries = cap, []

    def admit(self, tx):
        age = time.monotonic()                # wall clock in a decision
        self.entries.append((age, tx))
        return len(self.entries) <= self.cap
