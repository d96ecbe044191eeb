"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name`` gives. HBM bandwidth in bytes/s, from
NVIDIA's H100 data sheet (SXM5: 3.35 TB/s; PCIe: 2.0 TB/s; NVL: 3.9 TB/s),
at the card's full power limit. A card not in the table has no peak, and
a share of its peak reads null."""

from __future__ import annotations

HBM_BYTES_PER_S = (
    ("H100 80GB HBM3", 3.35e12),
    ("H100 SXM", 3.35e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
)


def hbm_bytes_per_s(kind: str) -> float | None:
    return next((bw for name, bw in HBM_BYTES_PER_S if name in kind), None)
