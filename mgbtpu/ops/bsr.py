"""128-blocked sparse matrices (BSR) for level-space operators.

Tiling to (B, B) dense blocks turns a sparse matvec into a TILE-level
gather (B-wide slices), a batched (T, B, B) x (T, B) matmul contraction,
and a B-wide segment-sum, instead of element-wise ELL gathers. Not yet
measured on the GPU.

Combined with a bandwidth-reducing permutation (reverse Cuthill-McKee)
the fill-in stays small for the mesh-local patterns this solver
produces. This is a re-design of the reference's BlockMatrices
batched-GEMM path (``src/BlockMatrices.jl``) applied to *level-space*
operators (FSAI factors, transfers) rather than element blocks.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from ..utils import pytree_dataclass, to_dev

B = 128  # tile edge


@pytree_dataclass(static=("n_rows", "n_cols", "nrt", "nct", "T"))
class BsrMatrix:
    """Block-sparse matrix with (B, B) dense tiles.

    ``tiles[t]`` is the dense block at (row_tile ``rid[t]``, col tile
    ``cid[t]``); rows/cols beyond ``n_rows``/``n_cols`` are zero padding.
    """
    rid: jnp.ndarray      # (T,) int32 row-tile ids
    cid: jnp.ndarray      # (T,) int32 col-tile ids
    tiles: jnp.ndarray    # (T, B, B)
    n_rows: int
    n_cols: int
    nrt: int              # number of row tiles
    nct: int
    T: int

    def mv(self, x):
        """y = A x for x of shape (n_cols,). Returns (n_rows,)."""
        xt = jnp.zeros((self.nct * B,), x.dtype).at[: self.n_cols].set(x)
        xt = xt.reshape(self.nct, B)
        g = xt[self.cid]                                   # (T, B)
        y = jnp.einsum("tij,tj->ti", self.tiles, g)
        out = jax.ops.segment_sum(y, self.rid, num_segments=self.nrt)
        return out.reshape(-1)[: self.n_rows]

    def rmv(self, y):
        """x = A' y for y of shape (n_rows,). Returns (n_cols,)."""
        yt = jnp.zeros((self.nrt * B,), y.dtype).at[: self.n_rows].set(y)
        yt = yt.reshape(self.nrt, B)
        g = yt[self.rid]
        x = jnp.einsum("tij,ti->tj", self.tiles, g)
        out = jax.ops.segment_sum(x, self.cid, num_segments=self.nct)
        return out.reshape(-1)[: self.n_cols]


def build_bsr(A: sp.spmatrix, dtype=np.float32) -> BsrMatrix:
    """Host-side tiling of a scipy sparse matrix."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    nrt = -(-n // B)
    nct = -(-m // B)
    coo = A.tocoo()
    rt = (coo.row // B).astype(np.int64)
    ct = (coo.col // B).astype(np.int64)
    key = rt * nct + ct
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    T = max(len(uniq), 1)
    tiles = np.zeros((T, B, B), dtype)
    tid_of = np.empty(len(key_s), np.int64)
    tid_of[np.argsort(order, kind="stable")] = np.searchsorted(uniq, key)
    lr = (coo.row % B).astype(np.int64)
    lc = (coo.col % B).astype(np.int64)
    np.add.at(tiles, (tid_of, lr, lc), coo.data.astype(dtype))
    rid = (uniq // nct).astype(np.int32) if len(uniq) else np.zeros(1, np.int32)
    cid = (uniq % nct).astype(np.int32) if len(uniq) else np.zeros(1, np.int32)
    return BsrMatrix(rid=to_dev(rid, np.int32), cid=to_dev(cid, np.int32),
                     tiles=to_dev(tiles), n_rows=n, n_cols=m,
                     nrt=nrt, nct=nct, T=T)


def bsr_pattern_scatter(rows: np.ndarray, cols: np.ndarray, n: int, m: int):
    """Static scatter plan for refreshing BSR values on device.

    Given the (rows, cols) coordinates of entry slots (one slot per value
    the device will produce, in slot order), returns
    ``(rid, cid, nrt, nct, T, flat_idx)`` where ``flat_idx[s]`` is the
    position of slot ``s`` in the flattened (T, B, B) tile array. Device
    refresh is then one scatter-add:

        tiles = zeros((T*B*B,)).at[flat_idx].add(values).reshape(T, B, B)

    Duplicate (row, col) slots accumulate, matching sparse assembly.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nrt = -(-n // B)
    nct = -(-m // B)
    rt = rows // B
    ct = cols // B
    key = rt * nct + ct
    uniq = np.unique(key)
    T = max(len(uniq), 1)
    tid = np.searchsorted(uniq, key) if len(uniq) else np.zeros(0, np.int64)
    flat_idx = tid * (B * B) + (rows % B) * B + (cols % B)
    rid = (uniq // nct).astype(np.int32) if len(uniq) else np.zeros(1, np.int32)
    cid = (uniq % nct).astype(np.int32) if len(uniq) else np.zeros(1, np.int32)
    return rid, cid, nrt, nct, T, flat_idx.astype(np.int64)


def rcm_permutation(pattern: sp.spmatrix) -> np.ndarray:
    """Bandwidth-reducing ordering (reverse Cuthill-McKee): ``perm[i]`` is
    the ORIGINAL index placed at position i of the new order."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    P = sp.csr_matrix(pattern)
    P = ((P + P.T) != 0).astype(np.int8)
    return np.asarray(reverse_cuthill_mckee(P, symmetric_mode=True),
                      dtype=np.int64)
