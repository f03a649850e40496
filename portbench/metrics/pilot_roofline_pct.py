"""The pilot stage's bound (roofline.pilot_bound_s) over the device time of
the kernels named ``pilot_*`` in the traced window."""

from portbench import roofline, trace


def read(run):
    if not run.ops:
        return None
    pilot_ns, _ = trace.stage_ns(run.ops)
    if pilot_ns <= 0:
        return None
    bound = run.loop.calls * roofline.pilot_bound_s(run.config, run.frames_per_call)
    return 100.0 * bound / (pilot_ns / 1e9)
