"""Share of the traced window in which the card was idle (no operation of
the trace running, ``trace.busy``) while the host was inside a
``pilot.prepare`` or ``data.prepare`` span of the receiver
(``ofdm_ls_mrc_tpu_torch/utils/profiling.spans``, on the clock the device
trace is read on).  None without a device trace, or where the window holds
no ``*.launch`` span."""

from portbench import trace


def read(run):
    if not run.ops:
        return None
    try:
        from ofdm_ls_mrc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = run.loop.epoch_ns
    inside = [r for r in spans() if lo <= r.start_ns and r.end_ns <= hi]
    if not any(r.name.endswith(".launch") for r in inside):
        return None
    prepare = sorted((r.start_ns, r.end_ns) for r in inside
                     if r.name in ("pilot.prepare", "data.prepare"))
    _, gaps = trace.busy(run.ops, run.loop.epoch_ns)
    idle, j = 0, 0
    for g0, g1 in gaps:                     # both sorted, neither overlapping itself
        while j < len(prepare) and prepare[j][1] <= g0:
            j += 1
        k = j
        while k < len(prepare) and prepare[k][0] < g1:
            idle += min(g1, prepare[k][1]) - max(g0, prepare[k][0])
            k += 1
    return 100.0 * idle / (hi - lo)
