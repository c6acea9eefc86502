"""Core device-scheduling package of the port.

`StaleNodeRefusal` lives here (not in torch_scheduler) so a shell can
import it without pulling torch into oracle-only processes.
"""


class StaleNodeRefusal(Exception):
    """A burst wave driver fetched a decision block that references nodes
    the store no longer has (mid-burst node death). Raised AFTER the
    committed prefix is reconciled and the device folds are discarded,
    BEFORE any decision from the block commits: the shell invalidates the
    dead nodes and replans the uncommitted remainder against the
    post-churn world, so the decision stream stays bit-identical to a
    serial loop that observed the death at the same boundary."""

    def __init__(self, dead: set, n_stale: int):
        super().__init__(
            f"{n_stale} in-flight decisions target vanished nodes "
            f"{sorted(dead)}")
        self.dead = dead
        self.n_stale = n_stale
