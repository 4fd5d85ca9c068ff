"""Peaks of the card and the least work of the scan kernel (K1).

K1's least work is counted from its inputs, never from what a culling pack
makes it read: every range written once, every scan pose read once, the
world's wall-segment table read once (8 float32 a row), and one ray-segment
hit test and the beam's own direction and epilogue for each beam. A better
culler then shows as a higher share, not as a smaller count.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
F32 = 4
ROW_FLOATS = 8                 # a row of the segment table
HIT_TEST_FLOPS = 14            # two 2-term dots, a scale, a fused
                               # parameter, a min, a test, a select, a max
BEAM_FLOPS = 18                # the beam's direction (11) and epilogue (3),
                               # its LUT angle (4)


def k1_bytes(n_scans: int, num_beams: int, n_segments: int) -> int:
    return F32 * (n_scans * num_beams + 3 * n_scans
                  + ROW_FLOATS * n_segments)


def k1_flops(n_scans: int, num_beams: int) -> int:
    return n_scans * num_beams * (HIT_TEST_FLOPS + BEAM_FLOPS)


def k1_bound_s(n_scans: int, num_beams: int, n_segments: int):
    """(least seconds, "bytes" or "operations": which of the two binds)."""
    tb = k1_bytes(n_scans, num_beams, n_segments) / PEAK_BYTES_PER_S
    tf = k1_flops(n_scans, num_beams) / PEAK_F32_FLOPS
    return (tb, "bytes") if tb >= tf else (tf, "operations")
