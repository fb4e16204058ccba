"""The roofline terms of a counted step (counterpart of
``repro.launch.hlo``'s ``Roofline`` / ``roofline_terms``), on a
``core.hardware.HardwareSpec``: the H100 by default, the reference's
v5e constants with ``hw=V5E``.

  compute    = device_flops / hw.peak_flops
  memory     = device_bytes / hw.hbm_bandwidth
  collective = device_wire_bytes / hw.link_bandwidth

``parsed`` is ``launch.cost.analyze``'s dict (the reference's
``hlo_cost.analyze`` dict has the same keys).  The terms are modelled from
data-sheet constants, not measured.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import H100, HardwareSpec


@dataclasses.dataclass
class Roofline:
    device_flops: float
    device_bytes: float
    collective_result_bytes: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_flops_ratio: float  # model_flops / (device_flops * n_devices)
    bound_s: float  # max of the three terms = roofline-model step time
    collectives: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    *,
    parsed: dict,
    n_devices: int,
    model_flops: float,
    hw: HardwareSpec = H100,
) -> Roofline:
    """The three terms of one device's step and the useful-FLOPs ratio."""
    device_flops = parsed["flops"]
    device_bytes = parsed["bytes_accessed"]
    wire = parsed["collective_wire_bytes"]
    terms = {
        "compute": device_flops / hw.peak_flops,
        "memory": device_bytes / hw.hbm_bandwidth,
        "collective": wire / hw.link_bandwidth,
    }
    return Roofline(
        device_flops=device_flops,
        device_bytes=device_bytes,
        collective_result_bytes=parsed["collective_result_bytes"],
        collective_wire_bytes=wire,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        dominant=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_flops_ratio=model_flops / max(device_flops * n_devices, 1e-30),
        bound_s=max(terms.values()),
        collectives=parsed["collectives"],
    )
