"""The three-term roofline of a step on the H100 (counterpart of
``repro/roofline/analysis.py``):

  t_comp = FLOPs per rank / bf16 tensor-core peak
           (a hand-written kernel's FLOPs at its own rule's rate)
  t_mem  = HBM bytes per rank / HBM rate
  t_coll = collective bytes per rank / NVLink rate per direction

The reference reads its counts from a compiled artifact
(``from_compiled``); the port reads them from the walker
(:func:`from_cost` over :func:`repro_torch.roofline.cost.cost`), per rank
as rank 0 runs the step. :func:`share` is the roofline step time over a
measured one: the port's benchmark reads it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float            # 6 N_active D (global, fwd+bwd) or serve
    peak_mem_per_device: float | None = None
    #: the part of ``flops_per_device`` that hand-written kernels do, and
    #: the seconds their rules' rates give it
    kernel_flops: float = 0.0
    kernel_comp_s: float = 0.0

    @property
    def t_comp(self) -> float:
        rest = self.flops_per_device - self.kernel_flops
        return rest / hw.PEAK_FLOPS_BF16 + self.kernel_comp_s

    @property
    def t_mem(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def t_coll(self) -> float:
        return self.coll_bytes_per_device / hw.LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: the largest of the three terms
        (perfect overlap)."""
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS over all counted FLOPs (remat and redundancy)."""
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return (self.model_flops / self.chips / t) / hw.PEAK_FLOPS_BF16

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_comp_s": self.t_comp, "t_mem_s": self.t_mem,
            "t_coll_s": self.t_coll, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_frac": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell: 6 N_active D for training, 2
    N_active D for a prefill, 2 N_active per sequence for a decode step."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def from_cost(arch, shape_name, mesh_name, chips, cost: dict,
              model_flops, peak_mem=None) -> Roofline:
    """The roofline of one rank's step from :func:`cost.cost`'s dict (per
    rank already: nothing is divided by ``chips``)."""
    kern = cost.get("by_kernel", {})
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=float(cost["flops"]),
        bytes_per_device=float(cost["bytes"]),
        coll_bytes_per_device=float(sum(cost.get("collectives",
                                                 {}).values())),
        model_flops=model_flops, peak_mem_per_device=peak_mem,
        kernel_flops=float(sum(k["flops"] for k in kern.values())),
        kernel_comp_s=float(sum(k["comp_seconds"] for k in kern.values())))


def share(roofline: Roofline, measured_s: float) -> float:
    """The roofline step time over a measured one: 1.0 at the bound."""
    return roofline.step_time / measured_s if measured_s > 0 else 0.0
