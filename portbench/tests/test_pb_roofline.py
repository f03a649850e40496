"""The byte and FLOP counters against the figures worked out by hand."""

import math

import pytest

from portbench import roofline


def test_orbit_frame_bytes_and_samples():
    assert roofline.frame_bytes_in(101, 16, 1024) == 6_619_136
    assert roofline.frame_bytes_out(101, 1024) == 818_400
    assert roofline.capture_samples(1, 101, 16, 1024) == 1_654_784
    # a capture of 64 frames: 423.6 MB in, 52.4 MB out
    assert 64 * roofline.frame_bytes_in(101, 16, 1024) == 423_624_704
    assert 64 * roofline.frame_bytes_out(101, 1024) == 52_377_600


def test_nr_slot_bytes_and_samples():
    assert roofline.frame_bytes_in(14, 64, 4096) == 14_680_064
    assert roofline.frame_bytes_out(14, 4096) == 425_880
    assert roofline.capture_samples(64, 14, 64, 4096) == 234_881_024
    assert 64 * roofline.frame_bytes_in(14, 64, 4096) == 939_524_096


def test_stage_bytes_count_each_input_and_output_once():
    # data rows 6,553,600 + h 131,072 + gains 4,096 + output 818,400
    assert roofline.data_bytes(100, 16, 1024, 2) == 7_507_168
    # rows 65,536 + h 131,072 + gains 4,096 + X 8,192
    assert roofline.pilot_bytes(16, 1024, 2) == 208_896
    assert roofline.data_bytes(13, 64, 4096, 2) == 13_631_488 + 2_097_152 + 16_384 + 425_880
    assert roofline.pilot_bytes(64, 4096, 2, k=2) == 2 * (1_048_576 + 2_097_152 + 16_384) + 32_768


def test_flops_and_bounds():
    assert roofline.fft_flops(1, 1024) == 5 * 1024 * 10
    assert roofline.data_flops(100, 16, 1024) == 1600 * (51_200 + 8 * 1024)
    assert roofline.pilot_flops(16, 1024) == 16 * (51_200 + 15 * 1024)
    orbit = {"frame_len": 101, "num_antennas": 16, "fft_size": 1024, "sample_format": "sc16"}
    # bytes bound both stages: 7.51 MB -> 2.24 us, 0.209 MB -> 0.062 us a frame
    assert roofline.data_bound_s(orbit, 1) == pytest.approx(7_507_168 / 3.35e12)
    assert roofline.pilot_bound_s(orbit, 1) == pytest.approx(208_896 / 3.35e12)
    assert roofline.data_bound_s(orbit, 64) == pytest.approx(64 * 7_507_168 / 3.35e12)
    assert roofline.data_flops(100, 16, 1024) / 67e12 < roofline.data_bound_s(orbit, 1)
    assert math.isclose(roofline.bound_s(0, 67e12), 1.0)
