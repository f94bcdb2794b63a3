"""Static Tanner-graph structure, hoisted out of the decode hot path.

The reference rebuilds an object-graph Tanner graph for *every* codeword
(``algo/bp.h:212-215``). Batched, the graph depends only on H, so we extract it
once on the host into padded index arrays, and every decoder consumes those
static arrays inside ``jit``:

* **row layout** ``(m, dc_max)``: for each check row, the column indices of
  its support, padded; message tensors in this layout are ``(B, m, dc_max)``.
* **col layout** ``(n, dv_max)``: for each variable, the check indices of its
  incident edges, padded; tensors ``(B, n, dv_max)``.
* flat cross-layout permutations ``row_to_col`` / ``col_to_row`` so a message
  tensor can be re-bucketed with one static ``take`` (padding slots point at a
  sentinel position carrying a neutral value).

Both layouts put the padded degree in the minor axis so vector ops see dense
(8, 128)-tileable work.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["CodeGraph"]


@dataclass(frozen=True)
class CodeGraph:
    """Padded, static edge structure of a parity-check matrix H (host side)."""

    h: np.ndarray                 # (m, n) uint8
    m: int
    n: int
    n_edges: int
    dc_max: int                   # max check (row) degree
    dv_max: int                   # max variable (column) degree
    # row layout
    row_col: np.ndarray           # (m, dc_max) int32: column of each row-slot; == n for pad
    row_mask: np.ndarray          # (m, dc_max) bool
    row_deg: np.ndarray           # (m,) int32
    # col layout
    col_row: np.ndarray           # (n, dv_max) int32: check row of each col-slot; == m for pad
    col_mask: np.ndarray          # (n, dv_max) bool
    col_deg: np.ndarray           # (n,) int32
    # cross-layout flat permutations (flat size +1 for the sentinel slot)
    row_from_col: np.ndarray      # (m, dc_max) int32 into flattened col layout [n*dv_max]
    col_from_row: np.ndarray      # (n, dv_max) int32 into flattened row layout [m*dc_max]

    @staticmethod
    def from_h(h: np.ndarray) -> "CodeGraph":
        h = np.asarray(h, dtype=np.uint8) % 2
        m, n = h.shape
        row_deg = h.sum(axis=1).astype(np.int32)
        col_deg = h.sum(axis=0).astype(np.int32)
        dc_max = max(int(row_deg.max()), 1)
        dv_max = max(int(col_deg.max()), 1)

        row_col = np.full((m, dc_max), n, dtype=np.int32)
        row_mask = np.zeros((m, dc_max), dtype=bool)
        col_row = np.full((n, dv_max), m, dtype=np.int32)
        col_mask = np.zeros((n, dv_max), dtype=bool)
        # slot coordinates of edge (i, j) in each layout
        row_slot = {}
        col_slot = {}
        col_fill = np.zeros(n, dtype=np.int64)
        for i in range(m):
            js = np.nonzero(h[i])[0]
            for s, j in enumerate(js):
                row_col[i, s] = j
                row_mask[i, s] = True
                row_slot[(i, j)] = i * dc_max + s
                t = col_fill[j]
                col_row[j, t] = i
                col_mask[j, t] = True
                col_slot[(i, j)] = j * dv_max + t
                col_fill[j] += 1

        # sentinel index = last flat position (callers append one neutral slot)
        row_sent = m * dc_max
        col_sent = n * dv_max
        row_from_col = np.full((m, dc_max), col_sent, dtype=np.int32)
        col_from_row = np.full((n, dv_max), row_sent, dtype=np.int32)
        for (i, j) in row_slot:
            rs = row_slot[(i, j)]
            cs = col_slot[(i, j)]
            row_from_col[rs // dc_max, rs % dc_max] = cs
            col_from_row[cs // dv_max, cs % dv_max] = rs

        return CodeGraph(
            h=h, m=m, n=n, n_edges=int(row_deg.sum()),
            dc_max=dc_max, dv_max=dv_max,
            row_col=row_col, row_mask=row_mask, row_deg=row_deg,
            col_row=col_row, col_mask=col_mask, col_deg=col_deg,
            row_from_col=row_from_col, col_from_row=col_from_row,
        )
