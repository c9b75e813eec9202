"""Nested-dissection multifrontal Cholesky from batched dense factorizations.

The deep-t barrier Hessian has hundreds of near-null equilibrated
eigenvalues that no smoother/geometric-coarse combination represents
(measured at the L=6 stall state: 406 eigenvalues below 1e-3, V-cycle
contraction 0.998) — iterative fine-level solves are structurally
mismatched, while a direct factorization with shift below lambda_min
handles the same systems effortlessly (the dense path's behavior). The
reference leans on cuDSS sparse Cholesky for exactly this reason
(``ext/MultiGridBarrierCUDAExt/cudss_solver.jl``). JAX has no sparse
direct solver; this module builds one from the FEM element structure:

- SYMBOLIC (host, once per hierarchy level): recursive coordinate
  bisection of the ELEMENTS (element centroids always exist) into a
  complete binary tree; each dof is assigned to the LCA tree node of the
  leaves whose elements touch it (classic nested dissection, no graph
  partitioner needed). Fronts are closed under child Schur updates by the
  LCA property. All index plans (element->leaf-front assembly scatter,
  child-boundary->parent-front maps, per-level padding) are precomputed.

- NUMERIC (device, per centering): bottom-up over tree levels, each level
  one BATCH of dense partial factorizations — batched Cholesky of the
  eliminated block, batched triangular solve for the coupling, batched
  SYRK for the Schur complement. Front sizes are O(sqrt(region)), so the
  whole factorization is O(n^1.5) flops of batched dense work with O(levels)
  sequential steps.

- SOLVE: forward/backward sweeps over the same structure.

Padded slots carry unit diagonal and zero coupling so they factor
trivially and contribute nothing.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# symbolic phase (host)
# ---------------------------------------------------------------------------

def _bisect_order(xy: np.ndarray, depth: int) -> np.ndarray:
    """Leaf id (0..2^depth-1) per element by recursive median bisection of
    the widest coordinate axis."""
    N = xy.shape[0]
    leaf = np.zeros(N, dtype=np.int64)
    stack = [(np.arange(N), 0, 0)]
    while stack:
        idx, d, base = stack.pop()
        if d == depth or len(idx) == 0:
            leaf[idx] = base
            continue
        spans = xy[idx].max(axis=0) - xy[idx].min(axis=0) if len(idx) else 0
        ax = int(np.argmax(spans))
        order = idx[np.argsort(xy[idx, ax], kind="stable")]
        h = len(order) // 2
        stack.append((order[:h], d + 1, base << 1))
        stack.append((order[h:], d + 1, (base << 1) | 1))
    return leaf


class NDPlan:
    """Host-side symbolic factorization plan (see module docstring)."""

    def __init__(self, cols: np.ndarray, n_J: int, elem_xy: np.ndarray,
                 leaf_elems: int = 8):
        cols = np.asarray(cols, dtype=np.int64)
        N, C = cols.shape
        depth = max(0, int(np.ceil(np.log2(max(N, 1) / leaf_elems))))
        leaf = _bisect_order(np.asarray(elem_xy, np.float64), depth)
        self.n_J = n_J
        self.depth = depth

        # dof -> (lmin, lmax) over touching leaves -> LCA node
        lmin = np.full(n_J, 1 << 62, dtype=np.int64)
        lmax = np.full(n_J, -1, dtype=np.int64)
        lf = np.repeat(leaf, C)
        cf = cols.reshape(-1)
        np.minimum.at(lmin, cf, lf)
        np.maximum.at(lmax, cf, lf)
        touched = lmax >= 0
        # level of LCA: depth - (highest differing bit position + 1); equal
        # -> leaf level (= depth)
        diff = lmin ^ lmax
        hb = np.zeros(n_J, dtype=np.int64)
        nz = diff > 0
        hb[nz] = np.floor(np.log2(diff[nz].astype(np.float64))).astype(np.int64) + 1
        lev = depth - hb                     # tree level of the LCA node
        node_idx = lmin >> hb                # index within that level
        lev[~touched] = depth                # untouched dofs: park at leaf 0
        node_idx[~touched] = 0

        # per-node assigned dofs, sorted by global id (deterministic)
        self.levels = []
        # front membership: dof d belongs to front of node v iff v is on
        # the tree path from any touching leaf to d's LCA node. Compute
        # per-level front lists bottom-up.
        # region-touched dofs per node at each level:
        # node (k, i) covers leaves [i<<(depth-k), (i+1)<<(depth-k))
        # dof touched by node (k, i) iff [lmin, lmax] intersects that range
        # and front-member iff additionally its LCA level <= k (assigned at
        # or above this level).
        self.assign_lev = lev
        self.assign_idx = node_idx
        self.lmin, self.lmax = lmin, lmax
        self.leaf_of_elem = leaf
        self.cols = cols


    def front_dofs(self, k, i):
        """Front of node (k, i): dofs assigned at (k, i) first, then
        boundary dofs (EXACTLY touched by the node's elements, assigned to
        a proper ancestor), each sorted by global id."""
        s = self.depth - k
        in_node = (self.leaf_of_elem >> s) == i
        touched = np.zeros(self.n_J, dtype=bool)
        touched[np.unique(self.cols[in_node])] = True
        assigned_here = touched & (self.assign_lev == k) \
            & (self.assign_idx == i)
        anc = touched & (self.assign_lev < k)
        a = np.flatnonzero(assigned_here)
        b = np.flatnonzero(anc)
        return a, b


# ---------------------------------------------------------------------------
# numpy reference numeric (correctness oracle for the device version)
# ---------------------------------------------------------------------------

def _assemble_dense(plan: NDPlan, He: np.ndarray, jitter: float):
    n = plan.n_J
    N, C, _ = He.shape
    H = np.zeros((n, n))
    for e in range(N):
        c = plan.cols[e]
        # np.add.at, NOT fancy += : ``cols`` may contain duplicate (padded)
        # entries, and buffered fancy assignment keeps only one write per
        # cell — silently dropping the real slot's contribution
        np.add.at(H, (c[:, None], c[None, :]), He[e])
    return H + jitter * np.eye(n)


def nd_factor_ref(plan: NDPlan, He: np.ndarray, jitter: float = 0.0):
    """Reference multifrontal factorization in numpy float64: returns the
    per-node dict {(k, i): (A_dofs, B_dofs, L_A, U)} bottom-up."""
    depth = plan.depth
    He = np.asarray(He, np.float64)
    fronts = {}   # (k, i) -> (dofs array, dense front)
    fact = {}
    # leaf assembly
    for i in range(1 << depth):
        a, b = plan.front_dofs(depth, i)
        dofs = np.concatenate([a, b])
        loc = {d: j for j, d in enumerate(dofs)}
        F = np.zeros((len(dofs), len(dofs)))
        for e in np.flatnonzero(plan.leaf_of_elem == i):
            ll = np.array([loc[d] for d in plan.cols[e]])
            np.add.at(F, (ll[:, None], ll[None, :]), He[e])
        F[np.arange(len(a)), np.arange(len(a))] += jitter
        fronts[(depth, i)] = (dofs, F)
    for k in range(depth, -1, -1):
        for i in range(1 << k):
            if (k, i) not in fronts:      # internal: gather children schur
                a, b = plan.front_dofs(k, i)
                dofs = np.concatenate([a, b])
                loc = {d: j for j, d in enumerate(dofs)}
                F = np.zeros((len(dofs), len(dofs)))
                for ch in ((k + 1, 2 * i), (k + 1, 2 * i + 1)):
                    bd, S = fronts.pop(("S",) + ch)
                    ll = np.array([loc[d] for d in bd], dtype=np.int64)
                    if len(ll):
                        np.add.at(F, (ll[:, None], ll[None, :]), S)
                F[np.arange(len(a)), np.arange(len(a))] += jitter
                fronts[(k, i)] = (dofs, F)
            dofs, F = fronts.pop((k, i))
            a_n = len(plan.front_dofs(k, i)[0])
            A = F[:a_n, :a_n]
            Bc = F[a_n:, :a_n]
            Cc = F[a_n:, a_n:]
            L_A = np.linalg.cholesky(A) if a_n else np.zeros((0, 0))
            U = np.linalg.solve(L_A, Bc.T).T if a_n else \
                np.zeros((len(dofs), 0))
            S = Cc - U @ U.T
            fact[(k, i)] = (dofs[:a_n], dofs[a_n:], L_A, U)
            if k > 0:
                fronts[("S", k, i)] = (dofs[a_n:], S)
    return fact


# ---------------------------------------------------------------------------
# device plan (static index arrays) + batched numeric
# ---------------------------------------------------------------------------

class NDDevicePlan:
    """Per-level static index arrays for the batched factorization.

    Front layout per node at level k: slots [0, amax_k) hold the node's
    assigned (eliminated) dofs (padded with unit-diagonal dummies), slots
    [amax_k, amax_k + bmax_k) the boundary dofs; one trailing dump slot
    absorbs padded scatters. All dof-id arrays use n_J as the dump id
    (rhs/solution vectors are padded to n_J + 1).

    The symbolic build is fully vectorized (the per-node membership at
    level k is the contiguous leaf-id interval [lmin>>s, lmax>>s], a
    conservative superset for non-contiguous touch sets — extra boundary
    members only enlarge fronts, never break the Schur closure)."""

    def __init__(self, plan: NDPlan):
        depth = plan.depth
        n = plan.n_J
        self.depth = depth
        self.n_J = n
        alev = plan.assign_lev
        self.levels = []
        # EXACT per-level membership from the (dof, leaf) incidence: a dof
        # belongs to the fronts of exactly the nodes whose regions contain
        # one of its touching leaves (the [lmin, lmax] hull overestimates
        # catastrophically for dofs near cut corners — measured 247-wide
        # leaf fronts where the true boundary is ~25).
        pair_dof = plan.cols.reshape(-1)
        pair_leaf = np.repeat(plan.leaf_of_elem, plan.cols.shape[1])
        node_front = []        # per level: (node_of_member, dof, is_bnd)
        for k in range(depth, -1, -1):
            s = depth - k
            nk = 1 << k
            key = pair_dof * nk + (pair_leaf >> s)
            uniq = np.unique(key)
            rep_dof = uniq // nk
            rep_node = uniq % nk
            keep = alev[rep_dof] <= k
            rep_dof, rep_node = rep_dof[keep], rep_node[keep]
            is_bnd = ~((alev[rep_dof] == k)
                       & (plan.assign_idx[rep_dof] == rep_node))
            order = np.lexsort((rep_dof, is_bnd, rep_node))
            node_front.append((rep_node[order], rep_dof[order],
                               is_bnd[order]))
            a_cnt = np.bincount(rep_node[~is_bnd], minlength=nk)
            b_cnt = np.bincount(rep_node[is_bnd], minlength=nk)
            amax = max(int(a_cnt.max()) if nk else 0, 1)
            bmax = max(int(b_cnt.max()) if nk else 0, 1)
            adofs = np.full((nk, amax), n, dtype=np.int64)
            bdofs = np.full((nk, bmax), n, dtype=np.int64)
            nd_s, dof_s, bnd_s = node_front[-1]
            # slot index within (node, is_bnd) group
            grp = nd_s * 2 + bnd_s
            start = np.zeros(2 * nk + 1, dtype=np.int64)
            np.cumsum(np.bincount(grp, minlength=2 * nk), out=start[1:])
            slot = np.arange(len(grp)) - start[grp]
            am = ~bnd_s
            adofs[nd_s[am], slot[am]] = dof_s[am]
            bdofs[nd_s[~am], slot[~am]] = dof_s[~am]
            self.levels.append(dict(k=k, nk=nk, amax=amax, bmax=bmax,
                                    adofs=adofs, bdofs=bdofs))

        def slot_of(level_idx, nodes, dofs):
            """Front-local slot of (node, dof) pairs at a level via
            searchsorted in the node's sorted assigned/boundary lists."""
            L = self.levels[level_idx]
            adofs, bdofs = L["adofs"], L["bdofs"]
            amax = L["amax"]
            ja = _row_searchsorted(adofs[nodes], dofs)
            hit_a = (ja < adofs.shape[1]) & \
                (adofs[nodes, np.minimum(ja, adofs.shape[1] - 1)] == dofs)
            jb = _row_searchsorted(bdofs[nodes], dofs)
            hit_b = (jb < bdofs.shape[1]) & \
                (bdofs[nodes, np.minimum(jb, bdofs.shape[1] - 1)] == dofs)
            out = np.where(hit_a, ja, amax + jb)
            out[~(hit_a | hit_b)] = amax + bdofs.shape[1]   # dump
            return out

        # leaf element assembly map
        N, C = plan.cols.shape
        le = plan.leaf_of_elem
        flat_nodes = np.repeat(le, C)
        flat_dofs = plan.cols.reshape(-1)
        self.leaf_loc = slot_of(0, flat_nodes, flat_dofs).reshape(N, C)
        self.leaf_of_elem = le
        # GATHER-form leaf assembly (the dd factorization path): per leaf,
        # the member-element list and the inverse of leaf_loc (front slot ->
        # element-local column). Scatter-add assembly rounds the hi words at
        # eps(f32), a perturbation far above lambda_min ~ 1/t of the deep-t
        # equilibrated Hessian — the dd Cholesky then breaks down for any
        # shift below that noise (measured: non-finite at shift <= 1e-9
        # while the true lambda_min is 1.7e-10). Gather + dd tree-sum is
        # exact. Duplicate padded columns in ``cols`` carry zero panels, so
        # first-write-wins collisions at a slot are harmless.
        nk0 = self.levels[0]["nk"]
        f0 = self.levels[0]["amax"] + self.levels[0]["bmax"]
        cnt = np.bincount(le, minlength=nk0)
        m_max = max(int(cnt.max()) if len(cnt) else 1, 1)
        order = np.argsort(le, kind="stable")
        start = np.zeros(nk0 + 1, dtype=np.int64)
        np.cumsum(cnt, out=start[1:])
        member = np.arange(N) - start[le[order]]
        self.elems_of_leaf = np.full((nk0, m_max), N, dtype=np.int64)
        self.elems_of_leaf[le[order], member] = order
        self.leaf_loc_inv = np.full((nk0, m_max, f0 + 1), C, dtype=np.int64)
        mem_of_elem = np.empty(N, dtype=np.int64)
        mem_of_elem[order] = member
        # write slots in REVERSE so the FIRST occurrence wins: ``cols`` pads
        # by repeating the last real column, so its duplicates are (real
        # slot K, zero-panel pads K+1..). Keeping a pad slot instead drops
        # the element's entire contribution at that dof — measured as a
        # fake null direction (true curvature 1.0, factor pivot = shift,
        # 1/shift amplification) that wrecked the corrector.
        rev = np.arange(C)[::-1]
        self.leaf_loc_inv[np.repeat(le, C), np.repeat(mem_of_elem, C),
                          self.leaf_loc[:, rev].reshape(-1)] = np.tile(rev, N)
        # per-level inverse incidence of the boundary scatter (dd solve
        # path): for each dof, the flat (node*bmax + slot) positions whose
        # forward-elimination update lands on it. Same eps(f32) story as
        # above, applied to the triangular solve: a plain hi/lo scatter-add
        # gives the *application* a backward error ~ eps(f32), i.e. a
        # preconditioned kappa ~ eps32 * t — useless at deep t.
        self.b_inc = []
        for L in self.levels:
            nk, bmax = L["nk"], L["bmax"]
            bd = L["bdofs"].reshape(-1)
            real = bd < n
            pos = np.flatnonzero(real)
            dofs = bd[real]
            kb = np.bincount(dofs, minlength=n)
            Kb = max(int(kb.max()) if len(kb) else 1, 1)
            inc = np.full((n + 1, Kb), nk * bmax, dtype=np.int64)
            o = np.argsort(dofs, kind="stable")
            st = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(kb, out=st[1:])
            inc[dofs[o], np.arange(len(o)) - st[dofs[o]]] = pos[o]
            self.b_inc.append(inc)
        # child-boundary -> parent-front maps, BOTH directions: cmap for
        # reference/tests, inverse (gather) maps for the device assembly
        self.child_maps = []
        self.parent_gather = []   # per internal level: (invL, invR)
        for li in range(1, depth + 1):
            Lc = self.levels[li - 1]
            Lp = self.levels[li]
            nk_c, bmax_c = Lc["nk"], Lc["bmax"]
            nk_p = Lp["nk"]
            fp = Lp["amax"] + Lp["bmax"]
            bd = Lc["bdofs"]
            nodes = np.repeat(np.arange(nk_c) // 2, bmax_c)
            dofs = bd.reshape(-1)
            cmap = slot_of(li, nodes, dofs)
            cmap[dofs >= n] = fp
            cmap = cmap.reshape(nk_c, bmax_c)
            self.child_maps.append(cmap)
            # inverse: parent slot -> child b-slot (miss -> bmax_c)
            invs = []
            for side in (0, 1):
                ip = np.full((nk_p, fp + 1), bmax_c, dtype=np.int64)
                ci = 2 * np.arange(nk_p) + side
                rows = np.repeat(ci, bmax_c)
                pslots = cmap[ci].reshape(-1)
                keep = pslots < fp
                ip[rows[keep] // 2, pslots[keep]] = \
                    np.tile(np.arange(bmax_c), nk_p)[keep]
                invs.append(ip)
            self.parent_gather.append(tuple(invs))

    def to_device(self, mesh=None):
        """Build the jit-carriable pytree (NDDev). ``mesh`` opts the
        numeric phase into subtree-per-device factor sharding (see NDDev)."""
        from ..utils import to_dev

        levels = tuple(
            NDLevel(adofs=to_dev(L["adofs"], np.int32),
                    bdofs=to_dev(L["bdofs"], np.int32),
                    k=L["k"], nk=L["nk"], amax=L["amax"], bmax=L["bmax"])
            for L in self.levels)
        return NDDev(levels=levels,
                     leaf_of_elem=to_dev(self.leaf_of_elem, np.int32),
                     leaf_loc=to_dev(self.leaf_loc, np.int32),
                     child_maps=tuple(to_dev(m, np.int32)
                                      for m in self.child_maps),
                     parent_gather=tuple(
                         (to_dev(a, np.int32), to_dev(b, np.int32))
                         for a, b in self.parent_gather),
                     elems_of_leaf=to_dev(self.elems_of_leaf, np.int32),
                     leaf_loc_inv=to_dev(self.leaf_loc_inv, np.int32),
                     b_inc=tuple(to_dev(m, np.int32) for m in self.b_inc),
                     depth=self.depth, n_J=self.n_J, mesh=mesh)


from ..utils import pytree_dataclass


@pytree_dataclass(static=("k", "nk", "amax", "bmax"))
class NDLevel:
    adofs: jnp.ndarray     # (nk, amax) assigned dof ids (n_J = pad)
    bdofs: jnp.ndarray     # (nk, bmax) boundary dof ids
    k: int
    nk: int
    amax: int
    bmax: int


@pytree_dataclass(static=("depth", "n_J", "mesh"))
class NDDev:
    """Device-side nested-dissection plan (a pytree: flows through jit as
    an argument like PanelOps, never baked into executables).

    ``mesh``: optional jax.sharding.Mesh. When set, the numeric phase
    constrains the FRONT-BATCH axis of every per-level factor block to
    shard across the mesh (subtree-per-device: the tree ordering is
    contiguous, so children 2i/2i+1 of parent i stay on the same shard
    until nk < n_devices, where the top fronts replicate). This is what
    makes multi-chip scale the dominant memory object — without it GSPMD
    replicates the factors per chip and a mesh buys only element/node-axis
    assembly parallelism (reference row-partition contract:
    /root/reference/src/mgb.jl:393-403)."""
    levels: tuple          # of NDLevel, leaf..root
    leaf_of_elem: jnp.ndarray
    leaf_loc: jnp.ndarray
    child_maps: tuple
    parent_gather: tuple   # per internal level: (invL, invR) parent-slot ->
                           # child-b-slot maps (miss -> bmax_child)
    elems_of_leaf: jnp.ndarray   # (nk0, m_max) element ids (N = pad)
    leaf_loc_inv: jnp.ndarray    # (nk0, m_max, f0+1) front slot -> elem col
    b_inc: tuple                 # per level: (n_J+1, Kb) flat b-positions
    depth: int
    n_J: int
    mesh: object = None


def _bshard(dp: "NDDev", pair_or_arr):
    """Shard-constrain the leading (front-batch) axis over ``dp.mesh``.

    Accepts an array or a (hi, lo) dd pair; no-op when no mesh is set or
    the batch does not divide the mesh (top-of-tree fronts replicate)."""
    if dp.mesh is None:
        return pair_or_arr
    from jax.sharding import NamedSharding, PartitionSpec

    from ..parallel.sharding import AXIS

    n = dp.mesh.devices.size

    def one(a):
        if a.ndim == 0 or a.shape[0] % n != 0 or a.shape[0] < n:
            return a
        spec = [None] * a.ndim
        spec[0] = AXIS
        return jax.lax.with_sharding_constraint(
            a, NamedSharding(dp.mesh, PartitionSpec(*spec)))

    if isinstance(pair_or_arr, tuple):
        return tuple(one(a) for a in pair_or_arr)
    return one(pair_or_arr)


def _row_searchsorted(A, v):
    """Per-row searchsorted: position of v[i] in sorted row A[i]."""
    n, m = A.shape
    lo = np.zeros(len(v), dtype=np.int64)
    hi = np.full(len(v), m, dtype=np.int64)
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        val = A[np.arange(len(v)), np.minimum(mid, m - 1)]
        go_right = active & (val < v)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    return lo


def nd_factor(dp: "NDDev", He, diag_shift):
    """Batched multifrontal factorization of sum-of-element-blocks + shift.

    ``He`` (N, C, C) element blocks (already equilibrated if desired),
    ``diag_shift`` scalar added to every assigned diagonal — or a
    (n_J + 1,) per-dof vector (unit pivots for structurally empty dofs,
    mirroring nd_factor_dd). Returns the per-level factor pytree
    ((L, U), ...) leaf..root."""
    fact = []
    S_prev = None
    for li, L in enumerate(dp.levels):
        amax, bmax, nk = L.amax, L.bmax, L.nk
        f = amax + bmax
        if li == 0:
            # leaf assembly: one scatter-add of the (N, C, C) element
            # blocks (the expensive scatters were the O(b^2)-per-node
            # child updates, which are gather-form below; this one is
            # nnz-bounded)
            F = jnp.zeros((nk, f + 1, f + 1), He.dtype)
            F = F.at[dp.leaf_of_elem[:, None, None],
                     dp.leaf_loc[:, :, None],
                     dp.leaf_loc[:, None, :]].add(He)
        else:
            invL, invR = dp.parent_gather[li - 1]
            bmax_c = dp.levels[li - 1].bmax
            Sp = jnp.pad(S_prev, ((0, 0), (0, 1), (0, 1)))
            SL, SR = Sp[0::2], Sp[1::2]
            F = SL[jnp.arange(nk)[:, None, None],
                   invL[:, :, None], invL[:, None, :]] + \
                SR[jnp.arange(nk)[:, None, None],
                   invR[:, :, None], invR[:, None, :]]
        # unit diagonal on padded/dummy slots; shift on real assigned slots
        apad = (L.adofs >= dp.n_J)
        bpad = (L.bdofs >= dp.n_J)
        if jnp.ndim(diag_shift) == 1:
            sh_a = diag_shift[jnp.minimum(L.adofs, dp.n_J)]
        else:
            sh_a = jnp.broadcast_to(jnp.asarray(diag_shift, He.dtype),
                                    L.adofs.shape)
        diag_a = jnp.where(apad, 1.0, sh_a).astype(He.dtype)
        ii = jnp.arange(amax)
        F = F.at[:, ii, ii].add(diag_a)
        jjb = amax + jnp.arange(bmax)
        F = F.at[:, jjb, jjb].add(jnp.where(bpad, 1.0, 0.0).astype(He.dtype))
        A = F[:, :amax, :amax]
        B = F[:, amax:amax + bmax, :amax]
        C_ = F[:, amax:amax + bmax, amax:amax + bmax]
        Lf = _bshard(dp, jnp.linalg.cholesky(A))
        U = _bshard(dp, lax.linalg.triangular_solve(
            Lf, B, left_side=False, lower=True, transpose_a=True))
        S_prev = _bshard(dp, C_ - jax.lax.dot_general(
            U, U, (((2,), (2,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST))
        fact.append((Lf, U))
    return tuple(fact)


def nd_finite(fact):
    """All factor leaves finite (the factorization's PD certificate)."""
    flags = [jnp.all(jnp.isfinite(Lf)) & jnp.all(jnp.isfinite(U))
             for Lf, U in fact]
    out = flags[0]
    for f in flags[1:]:
        out = out & f
    return out


def nd_solve(dp: "NDDev", fact, rhs):
    """Solve H x = rhs with the factors from nd_factor (one rhs)."""
    r = jnp.concatenate([rhs, jnp.zeros((1,), rhs.dtype)])
    ys = []
    for li, L in enumerate(dp.levels):
        Lf, U = fact[li]
        rA = r[L.adofs]
        y = lax.linalg.triangular_solve(Lf, rA[:, :, None], left_side=True,
                                        lower=True)[:, :, 0]
        ys.append(y)
        upd = jnp.einsum("nba,na->nb", U, y)
        r = r.at[L.bdofs].add(-upd)
    x = jnp.zeros_like(r)
    for li in range(len(dp.levels) - 1, -1, -1):
        L = dp.levels[li]
        Lf, U = fact[li]
        xB = x[L.bdofs]
        t = ys[li] - jnp.einsum("nba,nb->na", U, xB)
        xA = lax.linalg.triangular_solve(Lf, t[:, :, None], left_side=True,
                                         lower=True, transpose_a=True)[:, :, 0]
        x = x.at[L.adofs].set(jnp.where(L.adofs < dp.n_J, xA, 0.0))
    return x[:-1]


def nd_solve_ref(plan: NDPlan, fact, rhs: np.ndarray):
    depth = plan.depth
    r = np.asarray(rhs, np.float64).copy()
    ys = {}
    for k in range(depth, -1, -1):
        for i in range(1 << k):
            A_d, B_d, L_A, U = fact[(k, i)]
            y = np.linalg.solve(L_A, r[A_d]) if len(A_d) else np.zeros(0)
            ys[(k, i)] = y
            if len(B_d):
                r[B_d] -= U @ y
    x = np.zeros_like(r)
    for k in range(0, depth + 1):
        for i in range(1 << k):
            A_d, B_d, L_A, U = fact[(k, i)]
            if len(A_d):
                t = ys[(k, i)] - U.T @ x[B_d]
                x[A_d] = np.linalg.solve(L_A.T, t)
    return x


# ---------------------------------------------------------------------------
# double-float factorization (ops/ddlinalg.py): resolves the equilibrated
# spectrum to ~2^-48 * kappa, so deep-t Newton directions come from a
# direct solve + one dd refinement instead of a shift-limited CG (which
# degenerated to 1000-2800 its/step at t >= 8e5)
# ---------------------------------------------------------------------------

import os as _os

# Leaf assembly form: "gemm" (default) = one-hot incidence GEMMs;
# "gather" = the two-axis gather + dd tree-sum (the original form, which
# measured far slower to run and to compile; kept as the oracle/fallback).
ND_ASM = _os.environ.get("MGBTPU_ND_ASM", "gemm")


def _leaf_assemble_dd(dp: "NDDev", Heh, Hel):
    """Assemble the dd leaf fronts (nk0, f0+1, f0+1) from element blocks.

    GEMM form: with P the per-element one-hot local->front incidence
    (built in-program from ``leaf_loc`` by an iota compare — 0/1 entries,
    exact in bf16), F = sum_e P_e^T He_e P_e becomes two exact-operand
    Ozaki GEMMs (ops/ozaki.py dd_matmul_exact_nt) per leaf:
    T = He P (inner dim C) and F = T~^T P~ (inner dim m*C). Duplicate
    padded columns map to the same slot and ADD — their panels are zero
    (solver/levelops.py:441), so the sum is exact; this mirrors the f64
    oracle's np.add.at semantics. Everything dd-exact: a plain hi/lo
    scatter-add would round the hi words at eps(f32) (see nd_factor_dd).
    """
    from .ozaki import dd_matmul_exact_nt

    nk0, m_max = dp.elems_of_leaf.shape
    f0p1 = dp.leaf_loc_inv.shape[2]
    N, C, _ = Heh.shape
    if ND_ASM == "gather":
        eh = jnp.pad(Heh, ((0, 1), (0, 1), (0, 1)))
        el = jnp.pad(Hel, ((0, 1), (0, 1), (0, 1)))
        ee = dp.elems_of_leaf[:, :, None, None]
        la = dp.leaf_loc_inv[:, :, :, None]
        lb = dp.leaf_loc_inv[:, :, None, :]
        from . import df64 as _df
        return _df.dd_tree_sum((eh[ee, la, lb], el[ee, la, lb]), axis=1)
    eh = jnp.pad(Heh, ((0, 1), (0, 0), (0, 0)))
    el = jnp.pad(Hel, ((0, 1), (0, 0), (0, 0)))
    Hb = (eh[dp.elems_of_leaf], el[dp.elems_of_leaf])   # (nk0, m, C, C)
    ll = jnp.concatenate(
        [dp.leaf_loc, jnp.full((1, C), f0p1 - 1, dp.leaf_loc.dtype)])
    slots = ll[dp.elems_of_leaf]                        # (nk0, m, C)
    P = (slots[..., None]
         == jnp.arange(f0p1, dtype=slots.dtype)).astype(Heh.dtype)
    # T[l,t,a,g] = sum_b He[l,t,a,b] P[l,t,b,g]
    Th, Tl = dd_matmul_exact_nt(Hb, jnp.swapaxes(P, -1, -2))
    Th = Th.reshape(nk0, m_max * C, f0p1)
    Tl = Tl.reshape(nk0, m_max * C, f0p1)
    Pf = P.reshape(nk0, m_max * C, f0p1)
    # F[l,f,g] = sum_(t,a) T[l,(t,a),f] P[l,(t,a),g]  (symmetric)
    Fh, Fl = dd_matmul_exact_nt(
        (jnp.swapaxes(Th, -1, -2), jnp.swapaxes(Tl, -1, -2)),
        jnp.swapaxes(Pf, -1, -2))
    from . import df64 as _df
    Fh, Fl = _df.dd_add((Fh, Fl), (jnp.swapaxes(Fh, -1, -2),
                                   jnp.swapaxes(Fl, -1, -2)))
    return 0.5 * Fh, 0.5 * Fl


def nd_factor_dd(dp: "NDDev", Heh, Hel, diag_shift):
    """Multifrontal factorization with dd fronts. ``He`` is a dd pair of
    (N, C, C) element blocks. Returns per-level ((Lh, Ll), (Uh, Ul)).

    EVERY assembly step is exact in dd — gather-form leaf assembly
    (``NDDevicePlan.elems_of_leaf``/``leaf_loc_inv``), ``dd_add`` of the
    sibling Schur complements, ``dd_add`` of the diagonal shift. Plain
    hi/lo scatter-adds round the hi words at eps(f32), which exceeds
    lambda_min ~ 1/t of the deep-t equilibrated Hessian and makes the
    assembled fronts indefinite at any useful shift (measured: breakdown
    for shift <= 1e-9 with true lambda_min = 1.7e-10)."""
    from . import df64
    from .ddlinalg import (TRI_INV, TRI_PANEL, dd_cholesky,
                           dd_cholesky_pform, dd_matmul_nt_any,
                           dd_syrk_sub, dd_tri_inverse,
                           dd_tri_solve_right, dd_tri_solve_right_pinv)

    fact = []
    S_prev = None
    for li, L in enumerate(dp.levels):
        amax, bmax, nk = L.amax, L.bmax, L.nk
        f = amax + bmax
        if li == 0:
            Fh, Fl = _leaf_assemble_dd(dp, Heh, Hel)
        else:
            invL, invR = dp.parent_gather[li - 1]
            Sh = jnp.pad(S_prev[0], ((0, 0), (0, 1), (0, 1)))
            Sl = jnp.pad(S_prev[1], ((0, 0), (0, 1), (0, 1)))
            ii = jnp.arange(nk)[:, None, None]
            Fh, Fl = df64.dd_add(
                (Sh[0::2][ii, invL[:, :, None], invL[:, None, :]],
                 Sl[0::2][ii, invL[:, :, None], invL[:, None, :]]),
                (Sh[1::2][ii, invR[:, :, None], invR[:, None, :]],
                 Sl[1::2][ii, invR[:, :, None], invR[:, None, :]]))
        apad = (L.adofs >= dp.n_J)
        bpad = (L.bdofs >= dp.n_J)
        ii2 = jnp.arange(amax)
        jjb = amax + jnp.arange(bmax)
        if jnp.ndim(diag_shift) == 1:
            # per-dof shift (n_J + 1,): unit pivots for structurally empty
            # dofs (zero Hessian row, e.g. constrained boundary dofs) so a
            # deep shift doesn't turn them into 1/shift amplifiers
            sh_a = diag_shift[jnp.minimum(L.adofs, dp.n_J)]
        else:
            sh_a = jnp.broadcast_to(jnp.asarray(diag_shift, Heh.dtype),
                                    L.adofs.shape)
        dsh = jnp.concatenate(
            [jnp.where(apad, 1.0, sh_a).astype(Heh.dtype),
             jnp.where(bpad, 1.0, 0.0).astype(Heh.dtype)], axis=1)
        jj = jnp.concatenate([ii2, jjb])
        dh, dl = df64.dd_add((Fh[:, jj, jj], Fl[:, jj, jj]),
                             (dsh, jnp.zeros_like(dsh)))
        Fh = Fh.at[:, jj, jj].set(dh)
        Fl = Fl.at[:, jj, jj].set(dl)
        Ah, Al = Fh[:, :amax, :amax], Fl[:, :amax, :amax]
        Bh, Bl = Fh[:, amax:amax + bmax, :amax], Fl[:, amax:amax + bmax, :amax]
        Ch, Cl = (Fh[:, amax:amax + bmax, amax:amax + bmax],
                  Fl[:, amax:amax + bmax, amax:amax + bmax])
        if TRI_PANEL:
            # factor straight into the partitioned-inverse (P-) form:
            # inverted _BLOCK diagonal panels in place, off-diagonal L
            # kept (dd_cholesky_pform reuses the panel inverses the
            # blocked recursion computes anyway). U rides the blocked
            # GEMM right-solve; substitution-grade accuracy.
            Lf = _bshard(dp, dd_cholesky_pform(Ah, Al))
            U = _bshard(dp, dd_tri_solve_right_pinv(Lf[0], Lf[1], Bh, Bl))
        elif TRI_INV:
            # store L^-1 (Newton-Schulz GEMMs) instead of L: U becomes one
            # Ozaki GEMM here and every solve-time substitution becomes a
            # batched dd GEMV. UNSAFE at depth — the inverse application
            # cancels (ops/ddlinalg.py TRI_MODE note); kept for A/Bs.
            Lf = dd_cholesky(Ah, Al)
            Li = dd_tri_inverse(Lf[0], Lf[1])
            U = _bshard(dp, dd_matmul_nt_any((Bh, Bl), Li))
            Lf = _bshard(dp, Li)
        else:
            Lf = _bshard(dp, dd_cholesky(Ah, Al))
            U = _bshard(dp, dd_tri_solve_right(Lf[0], Lf[1], Bh, Bl))
        S_prev = _bshard(dp, dd_syrk_sub(Ch, Cl, U[0], U[1]))
        fact.append((Lf, U))
    return tuple(fact)


def nd_solve_dd(dp: "NDDev", fact, rh, rl=None):
    """Solve with dd factors and a dd rhs pair; returns the dd pair.

    The forward-elimination updates land on shared separator dofs through
    the inverse-incidence gather (``NDDevicePlan.b_inc``) + dd tree-sum +
    ``dd_sub`` — a hi/lo scatter-add would give the application a backward
    error ~ eps(f32), i.e. a preconditioned kappa ~ eps32 * t.

    With TRI_PANEL (default) the factor is in P-form (inverted _BLOCK
    diagonal panels), so every substitution here runs in ceil(front/32)
    blocked steps instead of an O(front)-step rolled loop, at
    substitution-grade accuracy; TRI_INV (L^-1 stored whole) applies in
    one dd GEMV but cancels at depth (ops/ddlinalg.py TRI_MODE note)."""
    from . import df64
    from .ddlinalg import (TRI_INV, TRI_PANEL, dd_gemv, dd_tri_solve_left,
                           dd_tri_solve_left_pinv)

    if rl is None:
        rl = jnp.zeros_like(rh)
    rh = jnp.concatenate([rh, jnp.zeros((1,), rh.dtype)])
    rl = jnp.concatenate([rl, jnp.zeros((1,), rl.dtype)])
    ys = []
    for li, L in enumerate(dp.levels):
        (Lh, Ll), (Uh, Ul) = fact[li]
        if TRI_INV:
            yA = dd_gemv((Lh, Ll), (rh[L.adofs], rl[L.adofs]))
        elif TRI_PANEL:
            yA = dd_tri_solve_left_pinv(Lh, Ll, rh[L.adofs], rl[L.adofs])
        else:
            yA = dd_tri_solve_left(Lh, Ll, rh[L.adofs], rl[L.adofs])
        ys.append(yA)
        ph, pe = df64.dd_mul((Uh, Ul), (yA[0][:, None, :], yA[1][:, None, :]))
        uh, ul = df64.dd_tree_sum((ph, pe), axis=2)
        uh = jnp.pad(uh.reshape(-1), (0, 1))
        ul = jnp.pad(ul.reshape(-1), (0, 1))
        inc = dp.b_inc[li]
        sh, sl = df64.dd_tree_sum((uh[inc], ul[inc]), axis=1)
        rh, rl = df64.dd_sub((rh, rl), (sh, sl))
    xh = jnp.zeros_like(rh)
    xl = jnp.zeros_like(rl)
    for li in range(len(dp.levels) - 1, -1, -1):
        L = dp.levels[li]
        (Lh, Ll), (Uh, Ul) = fact[li]
        xB = (xh[L.bdofs], xl[L.bdofs])
        ph, pe = df64.dd_mul((jnp.swapaxes(Uh, 1, 2), jnp.swapaxes(Ul, 1, 2)),
                             (xB[0][:, None, :], xB[1][:, None, :]))
        th, tl = df64.dd_tree_sum((ph, pe), axis=2)
        th, tl = df64.dd_sub(ys[li], (th, tl))
        if TRI_INV:
            xA = dd_gemv((Lh, Ll), (th, tl), transpose=True)
        elif TRI_PANEL:
            xA = dd_tri_solve_left_pinv(Lh, Ll, th, tl, transpose=True)
        else:
            xA = dd_tri_solve_left(Lh, Ll, th, tl, transpose=True)
        ok = L.adofs < dp.n_J
        xh = xh.at[L.adofs].set(jnp.where(ok, xA[0], 0.0))
        xl = xl.at[L.adofs].set(jnp.where(ok, xA[1], 0.0))
    return xh[:-1], xl[:-1]


def nd_memory_report(dp) -> dict:
    """Analytic memory model of the factorization (bytes), per level and
    total, for capacity planning at scale (the 1M-DOF target) and for the
    multi-chip story: with ``NDDev.mesh`` set the mesh-divisible (bottom)
    tree levels shard their factor blocks subtree-per-device (verified by
    tests/test_ndchol.py::test_nd_factor_subtree_sharding: per-device
    bytes = total/n_devices on those levels), and only the top
    nk < n_devices fronts replicate — so the per-chip requirement is
    ~``factor_dd_bytes``/n_devices + the top-of-tree tail. Without a mesh
    (or for non-divisible levels) the full factor must fit in one chip's
    HBM.

    Counts the stored factor blocks (L: nk*amax^2, U: nk*bmax*amax) plus
    the peak transient front/Schur pair at each level (F: nk*(amax+bmax)^2,
    S: nk*bmax^2 — alive only during that level's factorization step).
    dd doubles every word (hi, lo f32 pairs).
    """
    word = 4  # float32
    per_level = []
    factor = 0
    peak_transient = 0
    for L in dp.levels:
        if isinstance(L, dict):   # NDDevicePlan.levels; NDDev uses NDLevel
            nk, amax, bmax, k = L["nk"], L["amax"], L["bmax"], L["k"]
        else:
            nk, amax, bmax, k = L.nk, L.amax, L.bmax, L.k
        f = amax + bmax
        fb = nk * (amax * amax + bmax * amax) * word
        tb = nk * ((f + 1) * (f + 1) + bmax * bmax) * word
        factor += fb
        peak_transient = max(peak_transient, tb)
        per_level.append(dict(k=k, nk=nk, amax=amax, bmax=bmax,
                              factor_bytes=fb, transient_bytes=tb))
    return dict(levels=per_level,
                factor_bytes=factor,
                factor_dd_bytes=2 * factor,
                peak_transient_bytes=peak_transient,
                peak_dd_bytes=2 * (factor + peak_transient))


def nd_finite_dd(fact):
    flags = []
    for (Lh, Ll), (Uh, Ul) in fact:
        flags.append(jnp.all(jnp.isfinite(Lh)) & jnp.all(jnp.isfinite(Uh)))
    out = flags[0]
    for f in flags[1:]:
        out = out & f
    return out
