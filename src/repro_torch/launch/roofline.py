"""Peak rates of the card the port runs on, and the roofline terms.

The JAX package's module of this name also parses XLA's HLO to count a
compiled program's FLOPs and bytes; the port has no HLO, so only the
peak table and :func:`roofline_terms` are ported. ``HW`` holds the
NVIDIA H100 SXM's data-sheet figures (dense rates, no sparsity, at the
full 700 W power limit; a card set below it runs slower under load):

* ``peak_flops``     989e12 bf16 FLOP/s on the tensor cores;
* ``peak_f32_flops`` 67e12 float32 FLOP/s outside the tensor cores;
* ``hbm_bw``         3.35e12 B/s of HBM3;
* ``link_bw``        450e9 B/s a direction over NVLink 4 (900 GB/s both ways);
* ``host_link_bw``   64e9 B/s a direction over PCIe Gen5 x16, the link
                     a card-plus-host mesh (``core.comm``) crosses.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["HW", "roofline_terms"]

HW = {
    "name": "NVIDIA H100 SXM",
    "peak_flops": 989e12,
    "peak_f32_flops": 67e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "host_link_bw": 64e9,
}


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float, wire_bytes_per_chip: float,
                   hw: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The three lower bounds of one step, in seconds: compute (FLOPs at
    the bf16 peak), memory (HBM bytes) and collective (wire bytes over
    ``link_bw``); ``dominant`` names the largest and ``bound_s`` is it."""
    hw = HW if hw is None else hw
    compute = flops_per_chip / hw["peak_flops"]
    memory = hbm_bytes_per_chip / hw["hbm_bw"]
    collective = wire_bytes_per_chip / hw["link_bw"]
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = max(compute, memory, collective)
    return terms
