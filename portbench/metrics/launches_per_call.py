"""Kernel launches per call in the traced window: the program's
``kernel.launched`` marks (one per ``*.launch`` span, recorded where the
wrappers count ``launch_counts``), over the calls.  None where the window
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
    return sum(r.name == "kernel.launched" for r in inside) / run.loop.calls
