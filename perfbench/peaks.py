"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates): HBM bytes/s and float32 operations/s outside the
tensor cores.  A card not listed has no peak, and the metrics that need
one are left out of its runs."""

from __future__ import annotations

PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),     # SXM5, 700 W
)


def peak(device_name: str):
    """``(bytes/s, f32 operations/s)`` of the card, or None."""
    for key, bw, fl in PEAKS:
        if key in device_name:
            return bw, fl
    return None


def bound_s(work: dict, device_name: str):
    """The least seconds ``work`` ({"bytes", "flops"}) takes on the card:
    the larger of bytes over bandwidth and operations over the float32
    rate; None on a card with no peak."""
    pk = peak(device_name)
    if pk is None:
        return None
    return max(work["bytes"] / pk[0], work["flops"] / pk[1])
