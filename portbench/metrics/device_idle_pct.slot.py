"""Share of the traced open-loop window with no operation on the card."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run) if run.traffic["loop"] == "open" else None
