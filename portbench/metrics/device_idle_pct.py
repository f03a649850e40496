"""Share of the traced closed-loop window with no operation on the card
(the union of the operations' intervals)."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run) if run.traffic["loop"] == "closed" else None
