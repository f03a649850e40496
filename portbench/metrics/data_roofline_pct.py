"""The data stage's bound (roofline.data_bound_s) over the device time of
every operation in the traced window that is not a ``pilot_*`` kernel."""

from portbench import roofline, trace


def read(run):
    if not run.ops:
        return None
    _, other_ns = trace.stage_ns(run.ops)
    if other_ns <= 0:
        return None
    bound = run.loop.calls * roofline.data_bound_s(run.config, run.frames_per_call)
    return 100.0 * bound / (other_ns / 1e9)
