"""Set-up: from the process's start to the window (imports, the card's
context, the kernel library, the inputs, the receiver and its warm-up)."""


def read(run):
    return run.setup_s
