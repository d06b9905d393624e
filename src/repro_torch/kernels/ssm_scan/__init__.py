"""Chunked Mamba2 SSD scan kernel ``ssm_scan``; wrapper and plain version in
:mod:`repro_torch.kernels.ssm_scan.ops`."""
from repro_torch.kernels.ssm_scan.ops import (
    LAUNCHES,
    ssd_products,
    ssd_scan_plain,
    ssm_scan,
    ssm_scan_cost,
    tensor_core_route,
)

__all__ = ["LAUNCHES", "ssd_products", "ssd_scan_plain", "ssm_scan",
           "ssm_scan_cost", "tensor_core_route"]
