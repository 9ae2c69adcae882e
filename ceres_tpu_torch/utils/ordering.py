"""Schur ordering: which parameter families to eliminate first
(counterpart of ceres_tpu/utils/ordering.py).

The e-partition is a set of families. A family set is independent iff no
residual kind has two slots inside it; for BA this picks the points.
"""
from __future__ import annotations

from typing import List


def eligible_e_sets(program) -> List[int]:
    """Greedy maximum-tangent-size independent family set (the greedy MIS
    of graph_algorithms.h:97 at family granularity). Returns the family
    indices to eliminate; at least one variable family stays in f."""
    families = program.families

    def is_valid(chosen: set) -> bool:
        for kind in program.kinds:
            if sum(1 for s in kind.slots if s.family_index in chosen) > 1:
                return False
        return True

    order = sorted(
        (fi for fi, f in enumerate(families) if f.num_var > 0),
        key=lambda fi: families[fi].num_var * families[fi].tsize,
        reverse=True,
    )
    chosen: set = set()
    for fi in order:
        if is_valid(chosen | {fi}):
            chosen.add(fi)
    if chosen and len(chosen) == sum(1 for f in families if f.num_var > 0):
        smallest = min(chosen,
                       key=lambda fi: families[fi].num_var * families[fi].tsize)
        chosen.discard(smallest)
    return sorted(chosen)
