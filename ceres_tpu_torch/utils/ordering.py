"""Schur ordering: which parameter families to eliminate first
(counterpart of ceres_tpu/utils/ordering.py).

The e-partition is a set of families. A family set is independent iff no
residual kind has two slots inside it; for BA this picks the points.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


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


def e_set_from_user_ordering(program, ordering: Sequence[Sequence]) -> Optional[List[int]]:
    """The e-family set of a user ordering (ordering.py:120-157): group 0
    is eliminated, and must cover whole families. An entry is a parameter
    array (an individual block) or a ParameterBlockArray handle, which
    covers its family. None for an ordering of fewer than two groups."""
    if not ordering or len(ordering) < 2:
        return None
    arr_to_fam = {id(f.array): fi for fi, f in enumerate(program.families)
                  if f.array is not None}
    ids = set()
    chosen_blocks = set()
    for values in ordering[0]:
        fi = arr_to_fam.get(id(values))
        if fi is not None:
            ids.add(fi)
            continue
        blk = program.problem.parameter_block_for(values)
        ids.add(program._block_pos[id(blk)][0])
        chosen_blocks.add(id(blk))
    for fi in ids:
        fam = program.families[fi]
        if fam.array is not None:
            continue
        if any(id(b) not in chosen_blocks for b in fam.blocks[:fam.num_var]):
            raise ValueError("linear_solver_ordering group 0 must cover whole "
                             "(size, manifold) families")
    return sorted(ids)
