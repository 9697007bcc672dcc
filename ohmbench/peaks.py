"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates, at the card's full power limit), and a kernel's share
of its roofline."""

from __future__ import annotations

#: NVIDIA H100 SXM5: 3.35 TB/s of HBM3; 67 TFLOP/s float32 outside the
#: tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks_of(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (torch.cuda.get_device_name),
    or None for a card the table does not hold."""
    return PEAKS.get(kind)


def roofline_share(n_bytes: float, flops: float, kernel_s: float, peaks: dict | None):
    """Percent of the least time the card could take for the work, the
    larger of bytes over bandwidth and operations over peak rate, in the
    kernels' measured device time; None without a time or a peak."""
    if not peaks or kernel_s <= 0:
        return None
    bound = max(n_bytes / peaks["bytes_per_s"], flops / peaks["f32_flops_per_s"])
    return 100.0 * bound / kernel_s
