"""The sampler family on a domain with categorical inputs.

``entries/mcmc.py``'s set-up, unit, traced part and check, with the
forests' validity (``bad_nodes``) judged by ``reference/validity.py``: a
categorical split's threshold is a bitmask over the categories that reach
its node, not a number on the input's ordinal axis.
"""

from __future__ import annotations

from perfbench.entries.mcmc import Workload as SamplerWorkload
from perfbench.reference.validity import invalid_nodes


class Workload(SamplerWorkload):
    def readings(self, claim: dict, device, precision: str = "program") -> dict:
        out = super().readings(claim, device, precision)
        forest = {k: v.to(device) for k, v in claim["forest"].items()}
        out["bad_nodes"] = int(invalid_nodes(forest, self.ord_bounds.to(device),
                                             self.ft.to(device)).sum())
        return out
