"""Static per-row edge plan of the lifted parity-check matrix.

Still to port (ROADMAP.md): the flooding BP decoder with static rolls that
this module holds in the JAX package.  Only the plan function that the
layered decoder and the CUDA kernel share lives here so far.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

from ..spec.params import LDPCParams


@functools.lru_cache(maxsize=None)
def _row_plan(params: LDPCParams):
    """Per-base-row edge lists [(edge_idx, col, shift)] and per-col lists."""
    rows, cols, shifts = params.edges
    by_row: List[List[Tuple[int, int, int]]] = [[] for _ in range(params.num_rows)]
    by_col: List[List[Tuple[int, int]]] = [[] for _ in range(params.num_cols)]
    for e, (r, c, s) in enumerate(zip(rows, cols, shifts)):
        by_row[int(r)].append((e, int(c), int(s)))
        by_col[int(c)].append((e, int(s)))
    return by_row, by_col
