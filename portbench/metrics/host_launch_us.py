"""Mean host time per call, in the traced window, of the receiver's
``pilot.launch`` and ``data.launch`` spans: the C entries, the driver's
launch and the error check
(``ofdm_ls_mrc_tpu_torch/utils/profiling.spans``).  None where the window
holds no ``*.launch`` span: a program without the spans, or the CPU route."""


def read(run):
    try:
        from ofdm_ls_mrc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = run.loop.epoch_ns
    inside = [r for r in spans() if lo <= r.start_ns and r.end_ns <= hi]
    launches = [r for r in inside if r.name.endswith(".launch")]
    if not run.loop.calls or not launches:
        return None
    return sum(r.end_ns - r.start_ns for r in launches) / run.loop.calls / 1e3
