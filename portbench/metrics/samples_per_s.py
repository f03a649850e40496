"""Complex input samples (S A F a frame) demodulated in a closed-loop
window, over the window's wall time, which ends in a synchronize."""

from portbench import roofline


def read(run):
    if run.traffic["loop"] != "closed" or run.loop.window_s <= 0:
        return None
    c = run.config
    per_call = roofline.capture_samples(run.frames_per_call, c["frame_len"], c["num_antennas"],
                                        c["fft_size"])
    return run.loop.calls * per_call / run.loop.window_s
