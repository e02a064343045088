"""Roofline terms of a dry-run cell on an NVIDIA H100, as in
`repro.utils.roofline` (whose targets are the TPU v5e's).

  compute    = FLOPs per rank / peak          peak = 989 TFLOP/s bf16
  memory     = bytes per rank / hbm_bw        hbm  = 3.35 TB/s
  collective = collective bytes per rank / link_bw
                                              link = 50 GB/s

The figures are the published peaks of one H100 SXM at its full power
limit of 700 W (`nvidia-smi` names the part "NVIDIA H100 80GB HBM3"):
dense bfloat16 tensor-core rate and HBM3 bandwidth from NVIDIA's H100
data sheet.  The link rate is what a 16-wide ring crosses per GPU: the
ring spans two 8-GPU hosts, and between hosts each GPU has one 400 Gb/s
NDR InfiniBand port (50 GB/s each way; NVIDIA DGX H100 data sheet),
below NVLink's 450 GB/s each way inside a host.  A card set below
700 W runs below these peaks: keep its `nvidia-smi` power limit beside
any number compared with them.

The counts come from `repro_torch.utils.hlo`, per rank (local shapes).
MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) per train step, 2 N D
for a forward: the "useful compute" yardstick.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Chip", "H100", "RooflineTerms", "roofline_from_program",
           "model_flops"]


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float          # bf16, dense
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s per GPU, one direction


H100 = Chip("h100-sxm", 989e12, 3.35e12, 50e9)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # per rank
    hlo_bytes: float           # per rank
    coll_bytes: float          # per rank
    model_flops_total: float   # whole step, all ranks
    chip: Chip = H100

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.t_compute, memory=self.t_memory,
                     collective=self.t_collective)
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:          # roofline lower bound
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat, padding, replicated work)."""
        total = self.hlo_flops * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilisation at the roofline bound."""
        per_dev_useful = self.model_flops_total / self.chips
        return per_dev_useful / (self.step_time * self.chip.peak_flops)

    def row(self) -> dict:
        return dict(arch=self.arch, shape=self.shape, mesh=self.mesh,
                    t_compute=self.t_compute, t_memory=self.t_memory,
                    t_collective=self.t_collective,
                    bottleneck=self.bottleneck,
                    useful=self.useful_fraction, mfu=self.mfu)


def model_flops(cfg, shape, n_params: int, active_params: Optional[int]
                = None) -> float:
    """Whole-step useful FLOPs: 6ND train, 2ND prefill, 2ND/token decode."""
    n = active_params if active_params is not None else n_params
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    # decode: one token per sequence (attention over the cache is
    # N-independent KV reading, counted in the memory term)
    return 2.0 * n * shape.global_batch


def roofline_from_program(analysis: dict, *, arch: str, shape: str,
                          mesh: str, chips: int, model_flops_total: float,
                          chip: Chip = H100) -> RooflineTerms:
    """Terms from `repro_torch.utils.hlo.analyze_program`'s result (per
    rank), in place of the reference's `roofline_from_compiled`."""
    return RooflineTerms(arch=arch, shape=shape, mesh=mesh, chips=chips,
                         hlo_flops=analysis["flops"],
                         hlo_bytes=analysis["major_bytes"],
                         coll_bytes=analysis["collective"]["total"],
                         model_flops_total=model_flops_total, chip=chip)
