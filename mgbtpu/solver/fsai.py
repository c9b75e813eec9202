"""Factorized sparse approximate inverse (FSAI) preconditioner, BSR-backed.

For levels too large to factorize densely, the barrier Gram Hessian
H = sum_e P_e' Y_e P_e is sparse on the level space but its ALGEBRAIC
structure shifts every centering (the per-node weights Y carry 1/slack^2
wall terms), so the preconditioner must refresh on device. FSAI is built
from static-shape batched dense work only:

- the PATTERN (lower triangle of H's sparsity, truncated to
  MGBTPU_FSAI_K entries/row) is static per level — compiled once;
- the VALUES refresh on device: one scatter of the element Gram blocks
  into an ELL layout, a gather of k x k local blocks, a LOCAL
  equilibration read off each block's own diagonal, and an UNROLLED
  Gauss-Jordan batched solve (jnp.linalg solve/cholesky lower to 30-80 ms
  for the same batch — the unrolled elimination is ~2 ms);
- the APPLY runs through 128-blocked sparse tiles (ops/bsr.py): tile
  gather + batched matmul contraction + tile segment-sum.

Per row i with lower-neighbor set J_i (diagonal last), on the
equilibrated matrix Hs = D H D:

    g_i = (Hs[J_i, J_i])^-1 e_last,   G[i, J_i] = g_i / sqrt(g_i[last])

which gives diag(G Hs G') = 1 (Kolotilina-Yeremin FSAI), and
M^-1 = G'G is SPD. Reference counterpart: the cuDSS sparse direct
factorization used by the CUDA extension
(``ext/MultiGridBarrierCUDAExt``, ``src/utils.jl:142-145``) — re-designed
as an approximate inverse: JAX has no sparse triangular solves, while
batched dense algebra is native. Newton-level
integration (including the coarse-grid correction that restores
level-independent CG counts) lives in ``solver/newton.py``.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from ..ops.bsr import B as _B
from ..ops.bsr import bsr_pattern_scatter
from ..utils import pytree_dataclass, to_dev


@pytree_dataclass(static=("n_J", "kh", "k", "g_nrt", "g_nct", "g_T"))
class FSAIPlan:
    """Static pattern data (host-precomputed; only shapes enter jit keys)."""
    scat_idx: jnp.ndarray   # (N*C*C,) int32 into flat (n_J*kh) H values
    diag_flat: jnp.ndarray  # (n_J,) int32: flat ELL position of (i, i)
    low_idx: jnp.ndarray    # (n_J, k) int32: lower-neighbor cols, diag last
    low_mask: jnp.ndarray   # (n_J, k) bool
    pos: jnp.ndarray        # (n_J, k, k) int32 into flat H values
    pos_ok: jnp.ndarray     # (n_J, k, k) bool: entry present in pattern
    g_rid: jnp.ndarray      # (g_T,) int32: BSR row-tile ids of G
    g_cid: jnp.ndarray      # (g_T,) int32: BSR col-tile ids of G
    g_scat: jnp.ndarray     # (n_J*k,) int32 into flat (g_T*B*B) G tiles
    n_J: int
    kh: int
    k: int
    g_nrt: int
    g_nct: int
    g_T: int


def build_fsai_plan(cols: np.ndarray, n_J: int) -> FSAIPlan:
    """Host-side pattern construction from the element column lists."""
    cols = np.asarray(cols, np.int64)
    N, C = cols.shape
    rows = np.repeat(cols, C, axis=1).ravel()          # (N*C*C,) row ids
    colsf = np.tile(cols, (1, C)).ravel()              # matching col ids
    P = sp.coo_matrix((np.ones(len(rows), np.int32), (rows, colsf)),
                      shape=(n_J, n_J)).tocsr()
    P.sum_duplicates()
    P.sort_indices()
    indptr, indices = P.indptr, P.indices
    counts = np.diff(indptr)
    kh = int(counts.max())

    r_of = np.repeat(np.arange(n_J), counts)
    s_of = np.arange(P.nnz) - np.repeat(indptr[:-1], counts)

    keys = r_of.astype(np.int64) * (n_J + 1) + indices

    def gslot(qr, qc):
        q = qr.astype(np.int64) * (n_J + 1) + qc
        return np.searchsorted(keys, q)

    # scatter map: element contribution (e, c, d) -> flat ELL slot
    g = gslot(rows, colsf)
    scat_idx = r_of[g] * kh + s_of[g]

    gd = gslot(np.arange(n_J), np.arange(n_J))
    diag_flat = r_of[gd] * kh + s_of[gd]

    # lower-triangular pattern, diagonal last. Per-row counts are capped at
    # MGBTPU_FSAI_K (hub rows otherwise set the ELL width); for capped rows
    # keep the neighbors sharing the MOST elements with the row (the
    # multiplicity in P.data — a structural proxy for coupling strength).
    # Truncated FSAI stays SPD: G is lower triangular, positive diagonal.
    k_cap = int(os.environ.get("MGBTPU_FSAI_K", 32))
    low_mask_csr = indices <= r_of
    lr = r_of[low_mask_csr]
    lc = indices[low_mask_csr]
    lmult = np.asarray(P.data)[low_mask_csr].astype(np.int64)
    is_diag = lc == lr
    prio = np.where(is_diag, np.int64(1) << 40, lmult)
    order = np.lexsort((-lc, -prio, lr))          # rows contiguous
    lr_s, lc_s = lr[order], lc[order]
    cnt_all = np.bincount(lr_s, minlength=n_J)
    start = np.insert(np.cumsum(cnt_all), 0, 0)[:-1]
    rank = np.arange(len(lr_s)) - start[lr_s]
    keep = rank < k_cap
    lr, lc = lr_s[keep], lc_s[keep]
    o2 = np.lexsort((lc, lr))                     # ascending cols per row
    lr, lc = lr[o2], lc[o2]
    lcounts = np.bincount(lr, minlength=n_J)
    k = int(lcounts.max()) if len(lr) else 1
    low_idx = np.zeros((n_J, k), np.int64)
    low_mask = np.zeros((n_J, k), bool)
    ls = (np.arange(len(lr))
          - np.repeat(np.insert(np.cumsum(lcounts), 0, 0)[:-1], lcounts))
    # diagonal (the largest kept col, always present) lands in slot k-1
    ls = ls + (k - lcounts)[lr]
    low_idx[lr, ls] = lc
    low_mask[lr, ls] = True
    pad = ~low_mask
    low_idx[pad] = np.broadcast_to(np.arange(n_J)[:, None], (n_J, k))[pad]

    # pos[i, a, b]: flat ELL slot of H[low_idx[i,a], low_idx[i,b]] where
    # present; padding / absent entries are masked
    qa = np.repeat(low_idx, k, axis=1).ravel()
    qb = np.tile(low_idx, (1, k)).ravel()
    qm = (np.repeat(low_mask, k, axis=1) & np.tile(low_mask, (1, k))).ravel()
    qkey = qa * (n_J + 1) + qb
    ppos = np.searchsorted(keys, qkey)
    ppos_c = np.minimum(ppos, len(keys) - 1)
    present = qm & (keys[ppos_c] == qkey)
    flat = np.where(present, r_of[ppos_c] * kh + s_of[ppos_c], 0)
    pos = flat.reshape(n_J, k, k)
    pos_ok = present.reshape(n_J, k, k)

    # BSR tiling of G's pattern (natural order; measured ~6 lower tiles per
    # 128-row tile at L=6, no bandwidth permutation needed). Padding slots
    # carry value 0 and scatter onto the row's diagonal slot: harmless adds.
    g_rid, g_cid, g_nrt, g_nct, g_T, g_flat = bsr_pattern_scatter(
        np.repeat(np.arange(n_J), k), low_idx.ravel(), n_J, n_J)

    return FSAIPlan(
        scat_idx=to_dev(scat_idx, np.int32),
        diag_flat=to_dev(diag_flat, np.int32),
        low_idx=to_dev(low_idx, np.int32),
        low_mask=to_dev(low_mask),
        pos=to_dev(pos, np.int32),
        pos_ok=to_dev(pos_ok),
        g_rid=to_dev(g_rid, np.int32),
        g_cid=to_dev(g_cid, np.int32),
        g_scat=to_dev(g_flat, np.int32),
        n_J=n_J, kh=kh, k=k, g_nrt=g_nrt, g_nct=g_nct, g_T=g_T)


def _gj_solve_last(Bk, dtype):
    """x with Bk x = e_last for a batch of SPD (k, k) blocks, by UNROLLED
    Gauss-Jordan elimination (no pivoting: blocks are jittered SPD).
    k steps of (n, k, k+1) element-wise work, in place of the batched
    jnp.linalg.solve / cholesky calls (not yet compared on the GPU)."""
    n, k, _ = Bk.shape
    e = jnp.zeros((n, k, 1), dtype).at[:, k - 1, 0].set(1.0)
    M = jnp.concatenate([Bk, e], axis=2)               # (n, k, k+1)
    for j in range(k):
        piv = M[:, j, j][:, None]
        piv = jnp.where(jnp.abs(piv) > 1e-30, piv, 1e-30)
        rowj = M[:, j, :] / piv                        # (n, k+1)
        fac = M[:, :, j]                               # (n, k)
        M = M - fac[:, :, None] * rowj[:, None, :]
        M = M.at[:, j, :].set(rowj)
    return M[:, :, k]


def fsai_values(plan: FSAIPlan, ops, Lnode):
    """Device-side FSAI factor refresh from the current node factors.

    Returns ``(Gtiles, dpos)``: the BSR value tiles of the factor G built
    on the equilibrated matrix Hs = D H D, D = diag(1/sqrt(diag H)), and
    ``dpos = sqrt(diag H)`` (the pcg equilibration scale). Equilibration
    happens PER LOCAL BLOCK from the block's own diagonal — identical
    values to global equilibration, but no (n, kh) element gather.
    """
    dtype = Lnode.dtype
    N, p, nD, C = ops.N, ops.p, ops.nD, ops.C
    Lr = Lnode.reshape(N, p, nD, nD)
    Bm = jnp.einsum("jNpc,Npji->Npic", ops.panels, Lr)
    Bf = Bm.reshape(N, p * nD, C)
    He = jnp.einsum("Nkc,Nkd->Ncd", Bf, Bf)                 # (N, C, C)
    n_flat = plan.n_J * plan.kh
    Hvals = jnp.zeros((n_flat,), dtype).at[plan.scat_idx].add(He.ravel())
    dpos = jnp.sqrt(jnp.maximum(Hvals[plan.diag_flat],
                                jnp.asarray(1e-30, dtype)))
    k = plan.low_idx.shape[1]
    Bblk = jnp.where(plan.pos_ok, Hvals[plan.pos], 0.0)     # (n_J, k, k)
    dloc = jnp.diagonal(Bblk, axis1=1, axis2=2)             # (n_J, k)
    sloc = 1.0 / jnp.sqrt(jnp.maximum(dloc, jnp.asarray(1e-30, dtype)))
    sloc = jnp.where(plan.low_mask, sloc, 1.0)
    Bblk = Bblk * sloc[:, :, None] * sloc[:, None, :]
    eye = jnp.eye(k, dtype=dtype)
    Bblk = jnp.where(plan.pos_ok, Bblk, eye[None, :, :])
    Bblk = Bblk + jnp.asarray(1e-6, dtype) * eye[None, :, :]
    gsol = _gj_solve_last(Bblk, dtype)                      # (n_J, k)
    scale = jnp.sqrt(jnp.maximum(gsol[:, -1], jnp.asarray(1e-30, dtype)))
    G_vals = jnp.where(plan.low_mask, gsol / scale[:, None], 0.0)
    Gtiles = jnp.zeros((plan.g_T * _B * _B,), dtype
                       ).at[plan.g_scat].add(G_vals.ravel())
    return Gtiles.reshape(plan.g_T, _B, _B), dpos


def fsai_apply(plan: FSAIPlan, Gtiles, rs):
    """M_s r = G' (G r) in equilibrated coordinates (SPD), via BSR tiles:
    tile gather + batched matmul contraction + tile segment-sum, twice
    (the adjoint reuses the same tiles with roles swapped)."""
    n, nt = plan.n_J, plan.g_nct
    xt = jnp.zeros((nt * _B,), rs.dtype).at[:n].set(rs).reshape(nt, _B)
    y = jnp.einsum("tij,tj->ti", Gtiles, xt[plan.g_cid])
    u = jax.ops.segment_sum(y, plan.g_rid, num_segments=plan.g_nrt)
    g2 = u[plan.g_rid]
    x = jnp.einsum("tij,ti->tj", Gtiles, g2)
    out = jax.ops.segment_sum(x, plan.g_cid, num_segments=nt)
    return out.reshape(-1)[:n]
