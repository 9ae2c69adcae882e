"""Schur ordering: which parameter families to eliminate first
(counterpart of ceres_tpu/utils/ordering.py).

The e-partition is a set of families. A family set is independent iff no
residual kind has two slots inside it; for BA this picks the points.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


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


def color_family_blocks(program, fi: int):
    """Greedy colouring of family fi's variable blocks over the residual
    co-occurrence graph (ordering.py:61-112; the block-granular
    independent sets of coordinate_descent_minimizer.h:84 CreateOrdering,
    graph_algorithms.h:165): two blocks some residual touches together get
    different colours, so each colour is an independent set even within
    one family (a pose graph: one pose family, binary residuals). Blocks
    are coloured in order of descending degree (Welsh-Powell), each with
    the least colour its neighbours leave. Returns (colours (num_var,)
    int32, number of colours); a family no kind touches twice is one
    colour."""
    fam = program.families[fi]
    nv = fam.num_var
    if nv == 0:
        return np.zeros((0,), np.int32), 0
    edges = []
    for kind in program.kinds:
        ours = [s for s in kind.slots if s.family is fam and s.any_variable]
        for a in range(len(ours)):
            for b in range(a + 1, len(ours)):
                pa = np.asarray(ours[a].pos_in_family)
                pb = np.asarray(ours[b].pos_in_family)
                keep = (pa < nv) & (pb < nv) & (pa != pb)
                if keep.any():
                    edges.append(np.stack([pa[keep], pb[keep]], axis=1))
    if not edges:
        return np.zeros((nv,), np.int32), 1
    e = np.concatenate(edges, axis=0)
    e = np.unique(np.concatenate([e, e[:, ::-1]], axis=0), axis=0)
    deg = np.bincount(e[:, 0], minlength=nv)
    ptr = np.zeros(nv + 1, np.int64)
    ptr[1:] = np.cumsum(deg)
    adj = e[np.argsort(e[:, 0], kind="stable"), 1]
    colors = np.full(nv, -1, np.int32)
    for v in np.argsort(-deg, kind="stable"):
        used = set(int(c) for c in colors[adj[ptr[v]:ptr[v + 1]]] if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors, int(colors.max()) + 1


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
