"""Batched non-negative solvers (the fit engine's numerical core).

The reference calls SPAMS' active-set ``nnls``/LARS ``lasso`` once per voxel
from a Cython ``nogil`` loop (/root/reference/amico/models.pyx:615,911,926,
940,1238,1569).  Active-set methods are branchy and voxel-divergent -- the
wrong shape for SIMD hardware -- so this build solves the same strictly
convex problem

    min_x  0.5 ||y - A x||^2 + lam1 ||x||_1 + 0.5 lam2 ||x||^2,   x >= 0
    (SPAMS mode=2, pos=true semantics)

on the *normal equations*:  min_x 0.5 x'Gx - b'x + ...,  with G = A'A,
b = A'y, via a fixed-iteration scheme that vectorizes perfectly over
thousands of voxels:

1. **FISTA** with adaptive (gradient) restart -- batched matvecs;
2. **cyclic coordinate-descent polish** -- exact per-coordinate minimization
   producing exact zeros (needed for the NODDI support detection,
   models.pyx:933-936) and fast tail convergence on the ill-conditioned
   NODDI dictionaries.

Shapes use NumPy broadcasting: ``b`` is ``(..., n)`` and ``G`` is anything
broadcastable to ``(..., n, n)``.  The fit engine's fast path buckets voxels
by LUT direction into tiles that share one dictionary: ``G (T, 1, n, n)``
against ``b (T, M, n)`` -- the Gram matrix is read once per tile instead of
once per voxel (SURVEY.md section 7).

An optional ``mask`` constrains coordinates to zero, which implements the
reference's debias re-fit on the positive support (models.pyx:929-942)
without ragged shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def power_iteration_L(G: jnp.ndarray, iters: int = 30) -> jnp.ndarray:
    """Largest eigenvalue of symmetric PSD G (..., n, n) -> (...,)."""
    n = G.shape[-1]
    v = jnp.ones(G.shape[:-1], G.dtype) / jnp.sqrt(jnp.asarray(n, G.dtype))

    def body(_, v):
        w = _mv(G, v)
        return w / (jnp.linalg.norm(w, axis=-1, keepdims=True) + 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v)
    w = _mv(G, v)
    return jnp.sum(v * w, axis=-1)


class _FistaState(NamedTuple):
    x: jnp.ndarray
    z: jnp.ndarray
    t: jnp.ndarray


def _mv(G, x):
    """Broadcasting matvec: (..., n, n) @ (..., n) -> (..., n).

    NB: precision HIGHEST -- a reduced-precision f32 product (bf16 passes,
    or TF32 on GPUs) makes CG diverge on ill-conditioned dictionaries
    (cond(G) ~ 1e8 for NODDI)."""
    return jnp.squeeze(jnp.matmul(G, x[..., None],
                                  precision=jax.lax.Precision.HIGHEST), -1)


def _cg_masked(G, b, m, x0, lam2, iters: int):
    """Batched conjugate gradient for (G + lam2 I) z = b restricted to the
    support mask m (off-support coordinates pinned to 0).  This is the
    same subproblem an active-set method solves exactly on its working set
    (reference SPAMS nnls inner solve; native amico_qp_nonneg chol_solve)."""
    # p stays masked by construction (z/r/p start masked, every update
    # preserves it), so Aop needs no pre-mask on its input
    def Aop(p):
        return (_mv(G, p) + lam2 * p) * m

    z = x0 * m
    r = (b * m) - Aop(z)
    p = r
    rs = jnp.sum(r * r, axis=-1, keepdims=True)

    def body(_, carry):
        z, r, p, rs = carry
        Ap = Aop(p)
        denom = jnp.sum(p * Ap, axis=-1, keepdims=True)
        # guard: f32 Grams can carry tiny negative eigenvalues; on negative
        # curvature freeze the step and restart the direction at r
        safe = denom > 1e-30
        alpha = jnp.where(safe, rs / jnp.where(safe, denom, 1.0), 0.0)
        z = z + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r, axis=-1, keepdims=True)
        beta = jnp.where(safe, rs_new / (rs + 1e-30), 0.0)
        p = r + beta * p
        return z, r, p, rs_new

    z, _, _, _ = jax.lax.fori_loop(0, iters, body, (z, r, p, rs))
    return jnp.where(jnp.isfinite(z), z, 0.0)


def nneg_qp_batch(G, b, lam1=0.0, lam2=0.0, mask=None, L=None,
                  fista_iters: int = 200, cd_sweeps: int = 40, x0=None,
                  refine_rounds: int = 0, cg_iters: int = 32,
                  inner_passes: int = 2, m0=None, early_exit: bool = True,
                  converge: bool = False, add_k: int = 1):
    """Solve min_x 0.5 x'Gx - b'x + lam1 1'x + 0.5 lam2 |x|^2,  x >= 0
    for a broadcastable batch of problems.

    Parameters
    ----------
    G : broadcastable to (..., n, n) against b's batch dims (e.g. (n, n)
        shared, (B, n, n) per-problem, or (T, 1, n, n) per-tile)
    b : (..., n) linear terms (A'y)
    lam1, lam2 : scalars (or arrays broadcastable to b)
    mask : optional {0,1} array broadcastable to b; 0-coordinates pinned to 0
    L : optional Lipschitz constants broadcastable to b's batch dims
        (lam2 excluded); computed by power iteration when None
    m0 : optional initial working set for the active-set rounds (seeds the
        support directly instead of the FISTA/CD solution's positives --
        combine with fista_iters=0, cd_sweeps=0 and an x0 to warm-start)
    early_exit : stop the FISTA/active-set loops once the whole batch is
        converged (while_loop instead of fixed trip count)
    cg_iters : int (flat budget) or tuple (per-round budgets; rounds are
        then unrolled -- round r's working set holds at most r atoms, so
        early rounds need only a few CG steps)
    converge : after the scheduled active-set rounds, keep running rounds
        (at a full-width CG budget) until every problem's working set is
        stable.  Each round grows the working set by at most one atom, so
        a fixed ``refine_rounds`` silently truncates solutions whose
        optimal support is larger -- with ``converge`` the round count is
        a *tuning* of the fast path, not a support-size cap.  Costs
        nothing when the batch is already stable (while_loop exits on
        entry).
    add_k : top-k violated atoms added per active-set round (default 1 =
        classic Lawson-Hanson).  k=2 halves the rounds a large support
        needs; wrongly co-added atoms are removed by the same pruning
        that serves the k=1 path.
    """
    b = jnp.asarray(b)
    G = jnp.asarray(G, b.dtype)
    n = b.shape[-1]

    lam1 = jnp.asarray(lam1, b.dtype)
    lam2 = jnp.asarray(lam2, b.dtype)

    if L is None:
        L = power_iteration_L(G)
    L = jnp.asarray(L, b.dtype)
    step = 1.0 / (L[..., None] + lam2 + 1e-30) if L.ndim else \
        1.0 / (L + lam2 + 1e-30)

    if mask is not None:
        mask = jnp.asarray(mask, b.dtype)

    x_init = jnp.zeros_like(b) if x0 is None else \
        jnp.broadcast_to(jnp.asarray(x0, b.dtype), b.shape)
    if mask is not None:
        x_init = x_init * mask

    def prox(v):
        out = jnp.maximum(v, 0.0)
        if mask is not None:
            out = out * mask
        return out

    def fista_body(s: _FistaState) -> _FistaState:
        grad = _mv(G, s.z) - b + lam2 * s.z
        x_new = prox(s.z - step * (grad + lam1))
        # adaptive gradient restart (per problem)
        restart = jnp.sum((s.z - x_new) * (x_new - s.x), axis=-1) > 0.0
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * s.t * s.t))
        t_eff = jnp.where(restart, 1.0, t_new)
        beta = jnp.where(restart, 0.0, (s.t - 1.0) / t_new)[..., None]
        z_new = x_new + beta * (x_new - s.x)
        return _FistaState(x_new, z_new, t_eff)

    state = _FistaState(x_init, x_init, jnp.ones(b.shape[:-1], b.dtype))
    if fista_iters > 0 and m0 is None:
        if early_exit:
            bscale = jnp.max(jnp.abs(b)) + 1e-30
            ftol = 1e-4 if b.dtype == jnp.float32 else 1e-6

            def fcond(carry):
                s, prev, i = carry
                moved = jnp.max(jnp.abs(s.x - prev)) > ftol * bscale
                return jnp.logical_and(i < fista_iters,
                                       jnp.logical_or(i < 2, moved))

            def fbody(carry):
                s, _, i = carry
                return fista_body(s), s.x, i + 1

            state, _, _ = jax.lax.while_loop(
                fcond, fbody, (state, jnp.full_like(x_init, jnp.inf), 0))
        else:
            state = jax.lax.fori_loop(0, fista_iters,
                                      lambda _, s: fista_body(s), state)
    x = state.x

    # ---- coordinate-descent polish (exact coordinate minimization) ----
    if cd_sweeps > 0 and m0 is None:
        Gdiag = jnp.diagonal(G, axis1=-2, axis2=-1)  # (..., n)
        lam1_j = jnp.broadcast_to(lam1, b.shape) if lam1.ndim else lam1
        lam2_j = jnp.broadcast_to(lam2, b.shape) if lam2.ndim else lam2

        def cd_coord(j, carry):
            x, q = carry
            xj = x[..., j]
            gjj = Gdiag[..., j]
            l1 = lam1_j[..., j] if lam1.ndim else lam1
            l2 = lam2_j[..., j] if lam2.ndim else lam2
            rj = b[..., j] - (q[..., j] - gjj * xj) - l1
            xj_new = jnp.maximum(rj / (gjj + l2 + 1e-30), 0.0)
            if mask is not None:
                xj_new = xj_new * jnp.broadcast_to(mask, b.shape)[..., j]
            delta = xj_new - xj
            # row j of G broadcasts against the batch dims of delta
            q = q + delta[..., None] * G[..., j, :]
            x = x.at[..., j].set(xj_new)
            return x, q

        def cd_sweep(_, carry):
            return jax.lax.fori_loop(0, n, cd_coord, carry)

        q = _mv(G, x)
        x, _ = jax.lax.fori_loop(0, cd_sweeps, cd_sweep, (x, q))

    # ---- active-set polish: batched Lawson-Hanson rounds warm-started from
    # the FISTA/CD solution.  On the flat valleys of ill-conditioned
    # dictionaries (NODDI: cond(G) ~ 1e8) first-order methods stop far from
    # the vertex an active-set solver (the reference's SPAMS) lands on; these
    # rounds close that gap: exact CG solve on the working set, step-back
    # removal of negative coordinates, single best-gradient atom additions.
    if refine_rounds > 0:
        cg_schedule = tuple(cg_iters) if isinstance(cg_iters, tuple) else None
        cg_cap = max(cg_schedule) if cg_schedule else cg_iters
        b_eff = b - lam1
        scale = jnp.max(jnp.abs(b_eff), axis=-1, keepdims=True) + 1e-30
        tol = 3e-6 if b.dtype == jnp.float32 else 1e-10
        big = jnp.asarray(jnp.finfo(b.dtype).max, b.dtype)

        def inner_solve(carry, iters=cg_cap):
            x, m = carry
            z = _cg_masked(G, b_eff, m, x, lam2, iters)
            # classic LH ratio test: only coords with x > 0 bound the step.
            # An ENTERING atom (x == 0) whose subproblem value comes back
            # non-positive would give ratio 0/(0 - z) = 0 and freeze the
            # whole step (alpha = 0), livelocking the round on an
            # add->prune cycle; excluding it lets the step proceed and the
            # tol prune below remove that atom immediately instead
            neg = (z <= 0.0) & (m > 0.0) & (x > 0.0)
            ratio = jnp.where(neg, x / (x - z + 1e-30), big)
            alpha = jnp.clip(jnp.min(ratio, axis=-1, keepdims=True), 0.0, 1.0)
            x = (x + alpha * (z - x)) * m
            m = m * (x > tol * scale).astype(b.dtype)
            return x * m, m

        def as_round(carry, iters=cg_cap):
            x, m, i, _ = carry
            m_before = m
            for _r in range(inner_passes):   # solve (+ optional removal pass)
                x, m = inner_solve((x, m), iters)
            # addition step: best violated atom outside the working set
            w = b_eff - _mv(G, x) - lam2 * x
            allowed = (1.0 - m) * (mask if mask is not None else 1.0)
            w_cand = jnp.where(allowed > 0.0, w, -big)
            jstar = jnp.argmax(w_cand, axis=-1)
            wmax = jnp.take_along_axis(w_cand, jstar[..., None], axis=-1)
            add = (wmax > tol * scale).astype(b.dtype)
            onehot = jax.nn.one_hot(jstar, b.shape[-1], dtype=b.dtype)
            m_new = jnp.minimum(m + add * onehot, 1.0)
            for _k in range(1, add_k):
                # next most-violated atom under the same tol gate;
                # stability keys on the first add (wmax bounds the rest)
                w_cand = jnp.where(onehot > 0.0, -big, w_cand)
                jstar = jnp.argmax(w_cand, axis=-1)
                wk = jnp.take_along_axis(w_cand, jstar[..., None], axis=-1)
                addk = (wk > tol * scale).astype(b.dtype)
                onehot = jax.nn.one_hot(jstar, b.shape[-1], dtype=b.dtype)
                m_new = jnp.minimum(m_new + addk * onehot, 1.0)
            stable = jnp.logical_and(
                jnp.max(add) <= 0.0,
                jnp.max(jnp.abs(m_new - m_before)) <= 0.0)
            return x, m_new, i + 1, stable

        if m0 is not None:
            m_init = jnp.broadcast_to(jnp.asarray(m0, b.dtype), b.shape)
            if mask is not None:
                m_init = m_init * mask
        else:
            m_init = (x > 0.0).astype(b.dtype)
            if mask is not None:
                m_init = m_init * mask
        if cg_schedule is not None:
            # equal-budget runs stay rolled in fori_loops
            carry = (x, m_init, 0, False)
            sched = [int(it) for it in cg_schedule[:refine_rounds]]
            # a schedule shorter than refine_rounds extends at its last
            # budget (silently truncating rounds would under-converge)
            if sched and len(sched) < refine_rounds:
                sched += [sched[-1]] * (refine_rounds - len(sched))
            runs: list[list[int]] = []
            for it in sched:
                if runs and runs[-1][1] == it:
                    runs[-1][0] += 1
                else:
                    runs.append([1, it])
            for count, it in runs:
                if count == 1:
                    carry = as_round(carry, it)
                else:
                    carry = jax.lax.fori_loop(
                        0, count, lambda _, c, _it=it: as_round(c, _it),
                        carry)
            x, m, stable0 = carry[0], carry[1], carry[3]
        elif early_exit:
            x, m, _, stable0 = jax.lax.while_loop(
                lambda c: jnp.logical_and(c[2] < refine_rounds,
                                          jnp.logical_not(c[3])),
                as_round, (x, m_init, 0, False))
        else:
            x, m, _, stable0 = jax.lax.fori_loop(
                0, refine_rounds, lambda _, c: as_round(c),
                (x, m_init, 0, False))
        if converge:
            # supports larger than the scheduled round count keep growing
            # one atom per round until stable (cap: generous 3n rounds);
            # full-width CG budget since the working set can now reach any
            # size <= n.  Second exit criterion: the QP solution x is
            # unique (strictly convex), so once a round stops MOVING x the
            # remaining working-set churn is degenerate cycling between
            # equivalent supports -- without this, one cycling problem
            # pins the whole batch at the round cap
            # ``converge`` may be an int: the continuation CG budget (the
            # Krylov dim needed equals the working-set size, bounded by
            # |seed| + rounds, usually far below n)
            cont_it = max(cg_cap, n) if isinstance(converge, bool) \
                else max(cg_cap, int(converge))
            xtol = tol * jnp.max(scale)

            def cont_body(c):
                x0c, m0c, i, _ = c
                xn, mn, _, st = as_round((x0c, m0c, i, False), cont_it)
                done = jnp.logical_or(
                    st, jnp.max(jnp.abs(xn - x0c)) <= xtol)
                return xn, mn, i + 1, done

            x, m, _, _ = jax.lax.while_loop(
                lambda c: jnp.logical_and(c[2] < 3 * n,
                                          jnp.logical_not(c[3])),
                cont_body, (x, m, 0, stable0))
            x, m = inner_solve((x, m), cont_it)
        else:
            x, m = inner_solve((x, m))
        x = jnp.maximum(x, 0.0)
    return x


def gram(A, precision=jax.lax.Precision.HIGHEST):
    """A'A for A (..., m, n)."""
    return jnp.einsum('...mi,...mj->...ij', A, A, precision=precision)


def nneg_lasso_from_A(A, y, lam1=0.0, lam2=0.0, **kw):
    """Convenience wrapper: reference `lasso` semantics from (A, y) directly.
    A: (m, n) shared or (B, m, n); y: (B, m)."""
    prec = jax.lax.Precision.HIGHEST
    A = jnp.asarray(A)
    y = jnp.asarray(y)
    G = gram(A)
    if A.ndim == 2:
        b = jnp.einsum('mi,...m->...i', A, y, precision=prec)
    else:
        b = jnp.einsum('bmi,bm->bi', A, y, precision=prec)
    return nneg_qp_batch(G, b, lam1=lam1, lam2=lam2, **kw)


def nnls_from_A(A, y, **kw):
    """Reference `nnls` semantics (lam1=lam2=0) from (A, y)."""
    return nneg_lasso_from_A(A, y, 0.0, 0.0, **kw)


def noddi_stage2_tiebreak(G2, b2, x2, lam1, lam2, nb_minus, nb_plus,
                          cg_iters: int = 8):
    """Degenerate-vertex objective tie-break for the NODDI stage-2 lasso
    (see PARITY.md 'error tail' for the root cause).

    For each voxel, swap the dominant WM atom to each same-ICVF adjacent-
    kappa neighbour (``nb_minus``/``nb_plus``, -1 = grid edge), re-solve a
    short masked CG on the swapped support, and keep the lowest QP
    objective -- matching the exact-vertex selection of SPAMS
    (/root/reference/amico/models.pyx:926).

    G2 (C, n, n), b2/x2 (C, M, n); returns the tie-broken x2.
    """
    prec = jax.lax.Precision.HIGHEST
    n = x2.shape[-1]
    idx = jnp.arange(n)
    nbm = jnp.asarray(nb_minus, jnp.int32)
    nbp = jnp.asarray(nb_plus, jnp.int32)

    def mv(X):
        return jnp.einsum('cij,cmj->cmi', G2, X, precision=prec)

    def obj(x):
        q = mv(x) + lam2 * x
        return (0.5 * jnp.sum(x * q, -1) - jnp.sum(b2 * x, -1)
                + lam1 * jnp.sum(x, -1))                      # (C, M)

    beff = b2 - lam1

    def cg(m, z0):
        def Aop(p):
            return (mv(p) + lam2 * p) * m

        z = z0 * m
        r = beff * m - Aop(z)
        p = r
        rs = jnp.sum(r * r, -1, keepdims=True)

        def body(_, c):
            z, r, p, rs = c
            Ap = Aop(p)
            den = jnp.sum(p * Ap, -1, keepdims=True)
            safe = den > 1e-30
            al = jnp.where(safe, rs / jnp.where(safe, den, 1.0), 0.0)
            z = z + al * p
            r = r - al * Ap
            rs2 = jnp.sum(r * r, -1, keepdims=True)
            be = jnp.where(safe, rs2 / (rs + 1e-30), 0.0)
            return z, r, r + be * p, rs2

        z, _, _, _ = jax.lax.fori_loop(0, int(cg_iters), body, (z, r, p, rs))
        return jnp.where(jnp.isfinite(z), z, 0.0)

    sup = (x2 > 0.0).astype(x2.dtype)
    dom = jnp.argmax(x2, axis=-1)                             # (C, M)
    oh_dom = (idx == dom[..., None]).astype(x2.dtype)
    F_best = obj(x2)
    x_best = x2
    for nbt in (nbm, nbp):
        nbv = jnp.take(nbt, dom)                              # (C, M)
        valid = nbv >= 0
        oh_nb = jnp.logical_and(idx == nbv[..., None],
                                valid[..., None]).astype(x2.dtype)
        m_c = jnp.clip(sup * (1.0 - oh_dom) + oh_nb, 0.0, 1.0)
        z = cg(m_c, x2 * (1.0 - oh_dom))
        x_c = jnp.maximum(z, 0.0) * m_c
        F_c = obj(x_c)
        take = jnp.logical_and(valid, F_c < F_best)
        x_best = jnp.where(take[..., None], x_c, x_best)
        F_best = jnp.where(take, F_c, F_best)
    return x_best
