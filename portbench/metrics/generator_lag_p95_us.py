"""95th percentile of how late the open loop issued each batch after its
due time."""

from portbench.readers import percentile


def read(run):
    if run.traffic["loop"] != "open":
        return None
    lag = percentile([i - d for i, d in zip(run.loop.issue_ns, run.loop.due_ns)], 95)
    return None if lag is None else lag / 1e3
