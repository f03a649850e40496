"""Mean host time to return from one call of the entry in the traced
open-loop window."""

from portbench.readers import host_call_us


def read(run):
    return host_call_us(run) if run.traffic["loop"] == "open" else None
