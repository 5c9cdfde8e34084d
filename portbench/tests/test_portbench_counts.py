"""The benchmark's operation and byte counts against sums by hand."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import common, flops  # noqa: E402


def test_k1_counts_codelab_push():
    # 32 rows of 2553 + 2 x 31 floats, 2 scores a row; rotations 2553 x 10
    # and 31 x 10; constants 3 x 10 + 1.
    assert flops.k1_bytes(32, 2553, 31, 10) == 4 * (
        32 * 2553 + 64 * 31 + 64 + 25530 + 310 + 31)
    assert flops.k1_bytes(64, 2553, 31, 10, calls=2) == 2 * flops.k1_bytes(
        32, 2553, 31, 10)
    # r1: 2 x 2553 x 10; two r2: 2 x 2 x 31 x 10; 5 a dimension a talker.
    assert flops.k1_flops(32, 2553, 31, 10) == 32 * (51060 + 1240 + 100)
    assert 1.6e6 < flops.k1_flops(32, 2553, 31, 10) < 1.8e6


def test_serve_push_counts():
    decode = flops.k1_flops(16, 1408, 31, 5)
    assert flops.serve_push_flops(16, 1, 32, 1408, 31, 5) == decode + 64
    with_ssd = flops.serve_push_flops(16, 1, 32, 1408, 31, 5, ssd_k_w=14)
    assert with_ssd - decode - 64 == flops.ssd_window_flops(14)
    # 20 outer steps; each: E-step 14 x 46, M-step 14 x 32 + 20, forward
    # 14 x (4 + 10 Newton steps of 12 + 8), smoother 14 x 9, eta 14 x 11.
    assert flops.ssd_window_flops(14) == 20 * (
        14 * 46 + 14 * 32 + 20 + 14 * 132 + 14 * 9 + 14 * 11)


def test_sweep_counts_codelab_ridge():
    # Moments 2 N F^2 with N = 40 x 3300 and F = 2553 + 1; per fit a
    # Cholesky of the augmented 2554 system (F^3 / 3) and two solves.
    ops = flops.sweep_flops('ridge', 40, 3300, 2553, 1, 9)
    moments = 2 * 132000 * 2554 ** 2
    fits = 360 * (2554 ** 3 // 3 + 2 * 2554 ** 2)
    assert ops == moments + fits
    assert 3.6e12 < ops < 3.8e12


def test_sweep_counts_kuleuven_cca():
    ops = flops.sweep_flops('cca', 8, 11520, 1408, 31, 9)
    moments = 2 * 92160 * 1439 ** 2
    per_fit = ((1408 ** 3 + 31 ** 3) // 3 + 1408 ** 2 * 31 + 31 ** 2 * 1408
               + 4 * 1408 * 31 ** 2 + 1408 ** 2 + 31 ** 2)
    assert ops == moments + 72 * per_fit


def test_k2_bytes_and_bound():
    # [3336, 69] raw read once, [3336, 69 x 37] written once.
    assert flops.k2_bytes(3336, 69, 37) == 4 * 3336 * 69 * 38
    seconds, which = common.bound(flops.k2_bytes(3336, 69, 37), 0)
    assert which == 'bytes'
    assert abs(seconds - 4 * 3336 * 69 * 38 / 3.35e12) < 1e-15
    seconds, which = common.bound(1, 67e12)
    assert which == 'operations' and seconds == 1.0
