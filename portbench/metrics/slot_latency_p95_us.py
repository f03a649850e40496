"""95th percentile over every batch due in an open-loop window of the time
from its due time to its completion seen on the host; a batch that never
completes is missing and counts as later than any."""

from portbench.readers import percentile


def read(run):
    if run.traffic["loop"] != "open":
        return None
    late = [float("inf") if done is None else done - due
            for due, done in zip(run.loop.due_ns, run.loop.done_ns)]
    p95 = percentile(late, 95)
    return None if p95 is None or p95 == float("inf") else p95 / 1e3
