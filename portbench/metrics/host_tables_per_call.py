"""Host tables computed per call in the traced window: the program's
``plan.table`` marks (one per table a function of ``ops/fft_plan.py``
computes; a cached table counts none), over the calls.  None where the
window holds no ``*.launch`` span: a program without the spans, or the CPU
route."""


def read(run):
    try:
        from ofdm_ls_mrc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = run.loop.epoch_ns
    inside = [r for r in spans() if lo <= r.start_ns and r.end_ns <= hi]
    if not run.loop.calls or not any(r.name.endswith(".launch") for r in inside):
        return None
    return sum(r.name == "plan.table" for r in inside) / run.loop.calls
