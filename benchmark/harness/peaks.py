"""Published peaks of the cards the benchmark may run on: NVIDIA's data
sheets, dense rates without sparsity, at the card's full power limit.
The first row whose key is in the card's name applies."""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peak(NamedTuple):
    bytes_per_s: float  # HBM bandwidth
    bf16_flops: float  # dense bf16 tensor-core rate


_PEAKS = (
    ("H200", Peak(4.8e12, 989e12)),
    ("H100 NVL", Peak(3.9e12, 835e12)),
    ("H100 PCIe", Peak(2.0e12, 756e12)),
    ("H100", Peak(3.35e12, 989e12)),  # SXM5, HBM3
)


def peak_of(device_name: str) -> Optional[Peak]:
    for key, peak in _PEAKS:
        if key in device_name:
            return peak
    return None
