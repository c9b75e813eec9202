"""Per-level batched "panel" operators — the solver's compute core.

For a hierarchy level with prolongation R (broken x n_J) and fine operators
D_k, the composed operators G_k = D_k R have element-local support: the rows
of element e touch at most C level columns. We precompute, per element, the
set of touched columns and the dense panels G_k[rows(e), cols(e)] — after
which every barrier evaluation is a batched einsum plus gathers and a
segment-sum scatter:

    Dz      = Dz0 + einsum(panels, z[cols])              (forward)
    grad    = scatter-add(einsum(panels, Y))              (adjoint)
    Hessian = scatter-add(einsum(panels, Ynode, panels))  (batched A'DA)

This is the batched-array generalization of the reference's BlockAssemblyPlan +
batched-GEMM structured path (``src/BlockMatrices.jl:281-491``): spectral
discretizations (one big dense block, N=1) and FEM (many small blocks) flow
through the same code, and the element axis is the natural sharding axis.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from ..utils import pytree_dataclass, to_dev


@pytree_dataclass(static=("n_nodes", "nD", "n_J", "p", "N", "C", "dd"))
class PanelOps:
    cols: jnp.ndarray      # (N, C) int32, sorted per element, padded by repeat
    panels: jnp.ndarray    # (nD, N, p, C)
    n_nodes: int
    nD: int
    n_J: int
    p: int
    N: int
    C: int
    dd: bool = False       # double-float reductions (the float32 path)
    pcg_ctx: object = None  # PCGContext for levels above the dense threshold
    # Inverse incidence: for each level column j, the (padded) list of flat
    # positions e*C + slot of (element, slot) pairs whose contribution lands
    # on j. The dd adjoint "scatter-add" becomes a GATHER + masked row
    # reduction, so the dd reductions are exact per column (a dd tree sum
    # over the K axis) with no element-coloring rounds at all. Plain f32
    # scatter-adds across
    # elements would inject eps_f32-relative noise into H, which the Newton
    # solve amplifies by the equilibrated condition number ~ t near the
    # central path.
    inv_idx: jnp.ndarray = None   # (n_J, K) int32 into flat (N*C)
    inv_mask: jnp.ndarray = None  # (n_J, K) bool, False on padding

    def apply_G(self, s):
        """(n_J,) level coefficients -> (n_nodes, nD) operator values."""
        sg = s[self.cols]                                   # (N, C)
        out = jnp.einsum("kNpc,Nc->Npk", self.panels, sg)
        return out.reshape(self.N * self.p, self.nD)

    def apply_G_dd(self, s):
        """(n_J,) f32 level coefficients -> DD (n_nodes, nD): G s with
        error-free products and a df64 tree reduction. The barrier input
        Dz = Dz0 + G s must carry more than f32 bits: its rounding noise
        re-enters the power-cone residual cancellation (r = s^a - |q|^2)
        at the same eps*|q|^2 scale the dd barrier evaluation removes."""
        from ..ops import df64
        from ..ops.ddarray import DD

        sg = s[self.cols]                                   # (N, C)
        ph, pe = df64.two_prod(self.panels, sg[None, :, None, :])
        hi, lo = df64.dd_tree_sum((ph, pe), axis=3)         # (nD, N, p)
        hi = hi.transpose(1, 2, 0).reshape(self.N * self.p, self.nD)
        lo = lo.transpose(1, 2, 0).reshape(self.N * self.p, self.nD)
        return DD(hi, lo)

    def apply_Gt(self, Y):
        """(n_nodes, nD) node values -> (n_J,) adjoint.

        In dd mode the per-element contraction runs in double-float so the
        returned f32 entries are correctly rounded — the gradient entries
        near the central path are small differences of large barrier/cost
        terms, and plain f32 accumulation noise there floors the Newton
        decrement above its stopping tolerance. Accepts a DD ``Y`` (the
        double-float per-node gradient path): its low words flow into the
        error accumulator, so the cancellation between the barrier and cost
        terms survives the contraction.
        """
        from ..ops.ddarray import DD

        if isinstance(Y, DD):
            hi, lo = self._adj_mid(Y.hi.reshape(self.N, self.p, self.nD),
                                   Y.lo.reshape(self.N, self.p, self.nD))
            zh, zl = self.scatter_vec_dd(hi, lo)
            return zh + zl
        Yr = Y.reshape(self.N, self.p, self.nD)
        if not self.dd:
            contrib = jnp.einsum("kNpc,Npk->Nc", self.panels, Yr)
            return self.scatter_flat(contrib)
        hi, lo = self._adj_mid(Yr, jnp.zeros_like(Yr))
        zh, zl = self.scatter_vec_dd(hi, lo)
        return zh + zl

    def _adj_mid(self, Yh, Yl):
        """Adjoint contraction middle: dd contrib (N, C) pair from per-node
        dd values Yh/Yl (N, p, nD)."""
        from ..ops import df64

        Yht = Yh.transpose(2, 0, 1)
        Ylt = Yl.transpose(2, 0, 1)
        ph, pe = df64.two_prod(self.panels, Yht[:, :, :, None])
        pe = pe + self.panels * Ylt[:, :, :, None]
        hi, lo = df64.dd_tree_sum((ph, pe), axis=2)
        return df64.dd_tree_sum((hi, lo), axis=0)

    def apply_Gt_dd(self, Y):
        """Adjoint like ``apply_Gt`` but returning a DD vector with an exact
        colored scatter. The assembled gradient must stay double-float into
        the Newton solve: an f32-narrowed g is a relative-eps(f32)
        perturbation whose solve error ||H^-1 dg|| is amplified by the
        equilibrated condition ~ t (the residual stall at t ~ 3e7)."""
        from ..ops.ddarray import DD

        if isinstance(Y, DD):
            Yh = Y.hi.reshape(self.N, self.p, self.nD)
            Yl = Y.lo.reshape(self.N, self.p, self.nD)
        else:
            Yh = Y.reshape(self.N, self.p, self.nD)
            Yl = jnp.zeros_like(Yh)
        hi, lo = self._adj_mid(Yh, Yl)                       # (N, C)
        return DD(*self.scatter_vec_dd(hi, lo))

    def assemble_dense(self, Ynode):
        """(n_nodes, nD, nD) per-node Hessian values -> dense (n_J, n_J)
        via the batched triple-product einsum (the float64 path; the dd
        path is matrix-free, see GramHessian/y_matvec_dd)."""
        Yr = Ynode.reshape(self.N, self.p, self.nD, self.nD)
        He = jnp.einsum("iNpc,Npij,jNpd->Ncd", self.panels, Yr,
                        self.panels)
        H = jnp.zeros((self.n_J, self.n_J), dtype=Ynode.dtype)
        return H.at[self.cols[:, :, None], self.cols[:, None, :]].add(He)

    def assemble_gram(self, Lnode):
        """Gram-form Hessian assembly: given per-node lower factors L with
        bw*F2 = L L^T, compute H = sum_i (L_i^T P_i)^T (L_i^T P_i) as a
        batched SYRK and scatter. Numerically PSD by construction. Used for
        the dd path's dense *preconditioner* (its f32 assembly noise only
        affects preconditioner quality, not the refined direction) and the
        V-cycle coarse solves."""
        Lr = Lnode.reshape(self.N, self.p, self.nD, self.nD)
        B = jnp.einsum("jNpc,Npji->Npic", self.panels, Lr)
        Bf = B.reshape(self.N, self.p * self.nD, self.C)
        He = jnp.einsum("Nkc,Nkd->Ncd", Bf, Bf)
        H = jnp.zeros((self.n_J, self.n_J), dtype=Lnode.dtype)
        return H.at[self.cols[:, :, None], self.cols[:, None, :]].add(He)

    def scatter_flat(self, contrib):
        """(N, C) per-slot contributions -> (n_J,) column sums (plain XLA
        scatter-add). The gather path (inv_idx) is kept for the EXACT dd
        scatter, where it replaces K sequential colored scatter rounds."""
        return jnp.zeros((self.n_J,), dtype=contrib.dtype
                         ).at[self.cols].add(contrib)

    def scatter_vec_dd(self, vh, vl):
        """Exact dd scatter of per-element (N, C) dd contributions into a dd
        (n_J,) pair: per-column gather + dd tree reduction over the K axis
        (no f32 accumulation noise, no colored scatter rounds)."""
        from ..ops import df64

        gh = jnp.where(self.inv_mask, vh.reshape(-1)[self.inv_idx], 0)
        gl = jnp.where(self.inv_mask, vl.reshape(-1)[self.inv_idx], 0)
        return df64.dd_tree_sum((gh, gl), axis=1)


@pytree_dataclass(static=("n_rows", "n_cols", "K"))
class EllOp:
    """Row-padded (ELL) sparse matrix: matvec = gather + small reduction,
    transpose-matvec = scatter-add. Used for hierarchy transfer operators in
    the V-cycle preconditioner (static shapes, no CSR loops).
    """
    idx: jnp.ndarray    # (n_rows, K) int32 column ids, padded by repeat
    val: jnp.ndarray    # (n_rows, K), padding entries are 0
    n_rows: int
    n_cols: int
    K: int
    # transposed ELL of the same matrix: rmv (the adjoint) runs as a
    # gather-matvec instead of an XLA scatter-add (see PanelOps.inv_idx)
    t_idx: jnp.ndarray = None   # (n_cols, Kt)
    t_val: jnp.ndarray = None   # (n_cols, Kt)

    def mv(self, x):
        return (self.val * x[self.idx]).sum(axis=1)

    def mv_dd(self, x):
        """Error-free-product matvec returning a DD vector (used for the
        fused ramp's double-float z carry)."""
        from ..ops import df64
        from ..ops.ddarray import DD

        ph, pe = df64.two_prod(self.val, x[self.idx])
        return DD(*df64.dd_tree_sum((ph, pe), axis=1))

    def rmv(self, y):
        if self.t_idx is not None:
            return (self.t_val * y[self.t_idx]).sum(axis=1)
        contrib = self.val * y[:, None]
        return jnp.zeros((self.n_cols,), dtype=y.dtype).at[self.idx].add(contrib)


def _ell_arrays(A: sp.csr_matrix, dtype):
    n = A.shape[0]
    counts = np.diff(A.indptr)
    K = max(int(counts.max()) if n else 1, 1)
    idx = np.zeros((n, K), dtype=np.int64)
    val = np.zeros((n, K), dtype=dtype)
    if A.nnz:
        rows = np.repeat(np.arange(n), counts)
        slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        idx[rows, slots] = A.indices
        val[rows, slots] = A.data
        # pad rows by repeating their last valid column (keeps idx in range)
        has = counts > 0
        last = np.zeros(n, dtype=np.int64)
        last[has] = A.indices[A.indptr[1:][has] - 1]
        pad = np.arange(K)[None, :] >= counts[:, None]
        idx[pad] = np.broadcast_to(last[:, None], (n, K))[pad]
    return idx, val, K


def build_ell(A: sp.spmatrix, dtype) -> EllOp:
    A = sp.csr_matrix(A)
    n, m = A.shape
    idx, val, K = _ell_arrays(A, dtype)
    t_idx, t_val, _ = _ell_arrays(sp.csr_matrix(A.T), dtype)
    return EllOp(idx=to_dev(idx, np.int32), val=to_dev(val),
                 n_rows=n, n_cols=m, K=K,
                 t_idx=to_dev(t_idx, np.int32),
                 t_val=to_dev(t_val))


@pytree_dataclass(static=("n_levels", "dense_level"))
class PCGContext:
    """Per-level data for the multigrid-preconditioned CG Newton solve of a
    level too large to factorize densely.

    ``coarse_ops[l]`` are the panel operators of hierarchy level l
    (0..n_levels-1, coarse to just-below-fine); ``transfers[l]`` maps level-l
    coefficients to level-(l+1) coefficients (the fine end maps into the
    solve level). Levels <= dense_level get dense Cholesky coarse solves;
    the rest Jacobi-smooth with matrix-free Gram matvecs.
    """
    coarse_ops: tuple       # tuple of PanelOps
    transfers: tuple        # tuple of EllOp, len == n_levels
    n_levels: int
    dense_level: int
    fsai: object = None     # FSAIPlan of the solve level (see solver/fsai.py)
    coarse_T: object = None  # BsrMatrix: dense-base level -> solve level
                             # (composed transfer for the 2-level FSAI
                             # coarse-grid correction, ops/bsr.py)
    nd: object = None       # ops.ndchol.NDDev: nested-dissection direct
                            # factorization plan of the solve level (the
                            # default large-level solver; the deep-t barrier
                            # Hessian defeats every smoother+coarse-space
                            # combination, see ops/ndchol.py)


@pytree_dataclass(static=())
class GramHessian:
    """Matrix-free Hessian in Gram form: H = (L^T P)^T (L^T P); carries the
    level ops, per-node factors, and the V-cycle context. Returned by the
    barrier f2 on levels above the dense threshold; the Newton solve
    dispatches on this type to PCG. On the dd path ``Ydd`` holds the
    double-float per-node blocks bw*F2 for the refinement residual matvec
    (the f32 Lnode factors serve only the V-cycle preconditioner)."""
    ops: PanelOps
    Lnode: jnp.ndarray      # (n_nodes, nD, nD) lower factors of bw*F2
    ctx: object = None      # PCGContext, or None on the dense-level path
    Ydd: object = None      # DD (n_nodes, nD, nD) or None
    H32: object = None      # dense f32 Gram assembly (dd dense-level
                            # preconditioner; its f32 assembly noise only
                            # affects preconditioner quality)

    def mv(self, v):
        return gram_matvec(self.ops, self.Lnode, v)

    def diag(self):
        return gram_diag(self.ops, self.Lnode)


def gram_matvec(ops: PanelOps, Lnode, v):
    """H v = B^T (B v), fully matrix-free (two batched einsums + scatter)."""
    vg = v[ops.cols]                                        # (N, C)
    Lr0 = Lnode.reshape(ops.N, ops.p, ops.nD, ops.nD)
    Pv = jnp.einsum("kNpc,Nc->Npk", ops.panels, vg)         # (N, p, j)
    Bv = jnp.einsum("Npji,Npj->Npi", Lr0, Pv)               # (N, p, i)
    Lr = Lnode.reshape(ops.N, ops.p, ops.nD, ops.nD)
    Y = jnp.einsum("Npji,Npi->Npj", Lr, Bv)                 # back through L
    contrib = jnp.einsum("kNpc,Npk->Nc", ops.panels, Y)
    return ops.scatter_flat(contrib)


def y_matvec_rel(ops: PanelOps, Ydd, v):
    """Like ``y_matvec_dd`` but with a plain (uncolored) scatter and an f32
    result: per-element contractions still run in dd (the in-element
    cancellations are what matter), while the cross-element scatter-add
    rounds at eps relative to the accumulated entries. Used for the INNER
    CG corrector matvecs, which need relative accuracy only — the outer
    iterative-refinement residuals keep the exact ``y_matvec_dd``."""
    sh, sl = _ymv_mid(ops, Ydd, v)                       # (N, C)
    return ops.scatter_flat(sh) + ops.scatter_flat(sl)


def _ymv_mid(ops: PanelOps, Ydd, v):
    """Gather-to-scatter middle of the dd H-apply: forward dd product,
    node-block dd contraction, adjoint dd contraction."""
    from ..ops import df64

    Yh = Ydd.hi.reshape(ops.N, ops.p, ops.nD, ops.nD)
    Yl = Ydd.lo.reshape(ops.N, ops.p, ops.nD, ops.nD)
    Dz = ops.apply_G_dd(v)
    Dzh = Dz.hi.reshape(ops.N, ops.p, ops.nD)
    Dzl = Dz.lo.reshape(ops.N, ops.p, ops.nD)
    ph, pe = df64.two_prod(Yh, Dzh[:, :, None, :])
    pe = pe + Yh * Dzl[:, :, None, :] + Yl * Dzh[:, :, None, :]
    Wh, Wl = df64.dd_tree_sum((ph, pe), axis=3)
    rh, re = df64.two_prod(ops.panels, Wh.transpose(2, 0, 1)[:, :, :, None])
    re = re + ops.panels * Wl.transpose(2, 0, 1)[:, :, :, None]
    sh, sl = df64.dd_tree_sum((rh, re), axis=2)
    return df64.dd_tree_sum((sh, sl), axis=0)            # (N, C)


def y_matvec_dd(ops: PanelOps, Ydd, v):
    """H v = P^T Y (P v) with the per-node blocks Y in double-float,
    computed in dd end to end (error-free products, dd tree reductions,
    exact colored scatter). Returns an (hi, lo) pair. Used for the outer
    iterative-refinement residuals of the matrix-free Newton solve at
    levels too large to factorize: the f32 V-cycle-preconditioned CG is
    only the corrector (see newton.pcg_solve), so neither its rounding nor
    any f32 narrowing of the node blocks limits the direction accuracy."""
    sh, sl = _ymv_mid(ops, Ydd, v)                           # (N, C)
    return ops.scatter_vec_dd(sh, sl)


def gram_diag(ops: PanelOps, Lnode):
    """diag(H) = sum over (e,p,i) of B[e,p,i,c]^2."""
    Lr = Lnode.reshape(ops.N, ops.p, ops.nD, ops.nD)
    B = jnp.einsum("jNpc,Npji->Npic", ops.panels, Lr)
    contrib = (B * B).sum(axis=(1, 2))                      # (N, C)
    return ops.scatter_flat(contrib)


def gram_element_blocks(ops: PanelOps, Lnode, col_scale=None):
    """Per-element Gram blocks He[e] = (L^T P_e)^T (L^T P_e), optionally
    with symmetric column scaling (equilibration): the input of the
    nested-dissection factorization (assemble_gram without the scatter)."""
    Lr = Lnode.reshape(ops.N, ops.p, ops.nD, ops.nD)
    B = jnp.einsum("jNpc,Npji->Npic", ops.panels, Lr)
    Bf = B.reshape(ops.N, ops.p * ops.nD, ops.C)
    if col_scale is not None:
        Bf = Bf * col_scale[ops.cols][:, None, :]
    return jnp.einsum("Nkc,Nkd->Ncd", Bf, Bf)


def build_panel_ops(D_fine, nu: int, R: sp.spmatrix, p: int,
                    dtype, dd: bool = False) -> PanelOps:
    """Host-side plan construction.

    ``D_fine``: list of (BlockDiagHost, comp) fine operators; ``R``: the
    level prolongation (nu*m x n_J); ``p``: broken nodes per element.
    """
    from ..ops.blockdiag import block_column_sparse

    R = sp.csr_matrix(R)
    n_J = R.shape[1]
    m = R.shape[0] // nu
    N = m // p
    nD = len(D_fine)
    Gs = []
    for op, comp in D_fine:
        Dk = block_column_sparse(op, comp, nu)
        Gk = sp.csr_matrix(Dk @ R)
        Gk.sort_indices()
        Gs.append(Gk)

    # per-element union of touched columns across all k
    elems_all, cols_all = [], []
    for Gk in Gs:
        nnz_rows = np.repeat(np.arange(m), np.diff(Gk.indptr))
        elems_all.append(nnz_rows // p)
        cols_all.append(Gk.indices)
    if elems_all:
        ec = np.unique(np.stack([np.concatenate(elems_all),
                                 np.concatenate(cols_all)], axis=1), axis=0)
    else:
        ec = np.zeros((0, 2), dtype=np.int64)
    counts = np.bincount(ec[:, 0], minlength=N)
    C = max(int(counts.max()) if N else 1, 1)
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    cols = np.zeros((N, C), dtype=np.int64)
    if len(ec):
        rows_f = ec[:, 0]
        slots_f = np.arange(len(ec)) - offsets[rows_f]
        cols[rows_f, slots_f] = ec[:, 1]
        has = counts > 0
        last = np.zeros(N, dtype=np.int64)
        last[has] = ec[offsets[1:][has] - 1, 1]
        pad = np.arange(C)[None, :] >= counts[:, None]
        cols[pad] = np.broadcast_to(last[:, None], (N, C))[pad]  # sorted pad
    panels = np.zeros((nD, N, p, C), dtype=dtype)
    for k, Gk in enumerate(Gs):
        coo = Gk.tocoo()
        e = coo.row // p
        i = coo.row % p
        # slot of each col within its element's sorted column list
        slot = _vector_slots(cols, counts, e, coo.col)
        panels[k, e, i, slot] += coo.data
    # inverse incidence lists (see PanelOps.inv_idx): valid slots only —
    # padded slots repeat the last column but their panels are zero
    valid = np.arange(C)[None, :] < counts[:, None]          # (N, C)
    flat_pos = np.flatnonzero(valid.reshape(-1))
    flat_col = cols.reshape(-1)[flat_pos]
    o = np.argsort(flat_col, kind="stable")
    fp, fc = flat_pos[o], flat_col[o]
    cnt_j = np.bincount(fc, minlength=n_J)
    K = max(int(cnt_j.max()) if len(fc) else 1, 1)
    off_j = np.zeros(n_J + 1, dtype=np.int64)
    np.cumsum(cnt_j, out=off_j[1:])
    inv_idx = np.zeros((n_J, K), dtype=np.int64)
    inv_mask = np.zeros((n_J, K), dtype=bool)
    slot_j = np.arange(len(fc)) - off_j[fc]
    inv_idx[fc, slot_j] = fp
    inv_mask[fc, slot_j] = True
    out = PanelOps(
        cols=to_dev(cols, np.int32),
        panels=to_dev(panels),
        n_nodes=m, nD=nD, n_J=n_J, p=p, N=N, C=C, dd=dd,
        inv_idx=to_dev(inv_idx, np.int32),
        inv_mask=to_dev(inv_mask))
    # host copy for downstream host-side pattern builders (build_fsai_plan,
    # the ND plan): np.asarray(ops.cols) would wait for every device
    # transfer queued so far. Non-field attribute: invisible to the pytree
    # protocol.
    object.__setattr__(out, "host_cols", np.asarray(cols, np.int32))
    return out


def _vector_slots(cols, counts, e, c):
    """Vectorized per-element searchsorted via global keys.

    ``e``/``c`` arrive as scipy COO int32 indices; NEP-50 weak promotion
    keeps ``e * max_col`` in int32, which OVERFLOWS once N * n_J > 2^31
    (first hit: fem2d_P1 L=8, 32768 elements x 114k dofs) — elements past
    the wrap got garbage slots and ~38% of the panel data was silently
    dropped. Force int64 keys."""
    N, C = cols.shape
    max_col = int(cols.max()) + 2 if cols.size else 2
    # build sorted global keys of valid (e, col) pairs
    valid_e = np.repeat(np.arange(N), counts)
    pos_in_e = np.concatenate([np.arange(k) for k in counts]) if N else \
        np.zeros(0, dtype=np.int64)
    valid_c = cols[valid_e, pos_in_e]
    keys = valid_e.astype(np.int64) * max_col + valid_c.astype(np.int64)
    q = e.astype(np.int64) * max_col + c.astype(np.int64)
    idx = np.searchsorted(keys, q)
    return pos_in_e[idx]


def gram_element_blocks_dd(ops: PanelOps, Ydd, col_scale=None):
    """Per-element Hessian blocks He = P^T Y P in DOUBLE-FLOAT from the dd
    node blocks (the input of the dd multifrontal factorization): the f32
    Gram-factor blocks lose exactly the lambda_min ~ 1/t information the
    deep-t factorization needs. Returns a dd pair of (N, C, C).

    The equilibration scale enters through the f32 panels (a relative
    perturbation, harmless); all products against Y and the reductions are
    error-free/dd."""
    from ..ops import df64

    Yh = Ydd.hi.reshape(ops.N, ops.p, ops.nD, ops.nD)
    Yl = Ydd.lo.reshape(ops.N, ops.p, ops.nD, ops.nD)
    Pd = ops.panels                                   # (nD, N, p, C)
    if col_scale is not None:
        Pd = Pd * col_scale[ops.cols][None, :, None, :]
    Heh = None
    for q in range(ops.p):                            # static, small
        Pq = Pd[:, :, q, :]                           # (nD, N, C)
        # W[e, i, d] = sum_j Y[e, q, i, j] P[j, e, d]   (dd)
        ph, pe = df64.two_prod(Yh[:, q, :, :, None],
                               Pq.transpose(1, 0, 2)[:, None, :, :])
        pe = pe + Yl[:, q, :, :, None] * Pq.transpose(1, 0, 2)[:, None, :, :]
        Wh, Wl = df64.dd_tree_sum((ph, pe), axis=2)   # (N, i, d)
        # He_q[e, c, d] = sum_i P[i, e, c] W[e, i, d]   (dd)
        rh, re = df64.two_prod(Pq.transpose(1, 0, 2)[:, :, :, None],
                               Wh[:, :, None, :])
        re = re + Pq.transpose(1, 0, 2)[:, :, :, None] * Wl[:, :, None, :]
        qh, ql = df64.dd_tree_sum((rh, re), axis=1)   # (N, C, C)
        if Heh is None:
            Heh, Hel = qh, ql
        else:
            Heh, Hel = df64.dd_add((Heh, Hel), (qh, ql))
    return Heh, Hel
