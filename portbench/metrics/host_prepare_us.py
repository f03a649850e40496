"""Mean host time per call, in the traced window, of the receiver's
``pilot.prepare`` and ``data.prepare`` spans: the wrappers' checks, plans,
tables, scratch and outputs before each C call
(``ofdm_ls_mrc_tpu_torch/utils/profiling.spans``).  None where the window
holds no ``*.launch`` span: a program without the spans, or the CPU route."""


def read(run):
    try:
        from ofdm_ls_mrc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = run.loop.epoch_ns
    inside = [r for r in spans() if lo <= r.start_ns and r.end_ns <= hi]
    if not run.loop.calls or not any(r.name.endswith(".launch") for r in inside):
        return None
    ns = sum(r.end_ns - r.start_ns for r in inside
             if r.name in ("pilot.prepare", "data.prepare"))
    return ns / run.loop.calls / 1e3
