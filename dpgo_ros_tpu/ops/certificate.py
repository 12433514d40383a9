"""SE-Sync-style global-optimality certification for the lifted PGO problem.

The reference's accuracy pitch rests on certifiably-correct pose-graph
optimization (reference ``README.md:79-112`` cites the SE-Sync / DC2-PGO
TRO-2021 line of work), but neither the wrapper nor the DPGO core exposes a
certifier. This module adds one: everything is matvecs through
the same edge-parallel :mod:`dpgo_ros_tpu.ops.quadratic` operators the
solver uses — the dual certificate matrix ``S`` is never materialized.

Math. Write the lifted state as the r×N matrix ``X`` (N = n·(d+1) columns:
d Stiefel columns + 1 translation column per pose) and the cost as
``f(X) = tr(X Q Xᵀ)`` with Q the sparse PSD quadratic-form operator
(:func:`quadratic.apply_Q` applies it). The manifold constraints are
``YᵢᵀYᵢ = I_d``. First-order criticality gives block-diagonal symmetric
multipliers

    Λᵢ = sym(Yᵢᵀ ∇f(X)_{Yᵢ}) / 2          (translations: multiplier 0),

and the dual certificate operator is

    S = Q − Λ̂,   Λ̂ = blockdiag(Λ₁ ⊕ 0, …, Λₙ ⊕ 0).

If ``X`` is critical (S Xᵀ = 0 by construction) and **S ⪰ 0**, then
Z = XᵀX solves the SDP relaxation, f(X) is the SDP optimum, and the
rank-d rounding of X is a *global* minimizer of the original SE(d)
synchronization problem whenever rank(X) = d (SE-Sync Prop. 2 / the
Burer–Monteiro a-posteriori guarantee). If S has a negative eigenvalue
with eigenvector v, appending ε·vᵀ as a fresh lifted row is a descent
direction at the *next* rank — the Riemannian staircase step
(:func:`escape_direction`, consumed by ``RBCDEngine``-level
:func:`certified_solve` in ``models/certified.py``).

The minimum eigenvalue is computed by Lanczos (scipy ``eigsh``) over a
LinearOperator whose matvec is one jitted ``apply_Q`` call on an (n, 1,
d+1) test vector — Q is rank-agnostic, so the same XLA operator that
powers the solver powers the certifier.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.ops import quadratic, stiefel
from dpgo_ros_tpu.ops.quadratic import EdgeSet


class CertificateResult(NamedTuple):
    """Outcome of :func:`certify`.

    ``is_global``: S ⪰ −tol·scale and the point is first-order critical.
    ``min_eig``: smallest eigenvalue of S (absolute units of Q).
    ``crit_residual``: ‖S Xᵀ‖_F / max(1, ‖Q Xᵀ‖_F) — how critical X is;
    a loose solve can fail certification on criticality alone.
    ``eigvec``: eigenvector for ``min_eig`` as an (n, d+1) array (None when
    the eigensolve was skipped because criticality already failed).
    ``scale``: the Frobenius-ish scale of Q used for the relative test
    (largest |diag block| of the preconditioner, a cheap Gershgorin-like
    bound).
    """

    is_global: bool
    min_eig: float
    crit_residual: float
    eigvec: Optional[np.ndarray]
    scale: float
    # second-shift margin guard (round 4): ``min_eig`` recomputed with an
    # independent spectral shift. Certificates whose margin is within
    # ``MARGIN_GUARD_BAND``·scale of the accept/reject boundary are only
    # trusted when both shifts agree (an fp Lanczos wobble at a 1e-9-thin
    # margin could otherwise flip the verdict).
    min_eig_check: Optional[float] = None
    margin_verified: bool = True


def lambda_blocks(X: jnp.ndarray, e: EdgeSet) -> jnp.ndarray:
    """Per-pose symmetric multipliers Λᵢ = sym(Yᵢᵀ ∇f_{Yᵢ}) / 2, (n, d, d)."""
    d = X.shape[-1] - 1
    G = quadratic.egrad(X, e)
    Y = X[..., :d]
    GY = G[..., :d]
    return stiefel.sym(jnp.einsum("nra,nrb->nab", Y, GY)) * 0.5


def s_matvec(
    V: jnp.ndarray, X: jnp.ndarray, Lam: jnp.ndarray, e: EdgeSet
) -> jnp.ndarray:
    """S applied to a test state V (n, r_v, d+1): Q(V) − V_Y Λ per pose.

    Rank-agnostic: r_v = 1 certifies; r_v = r reproduces S Xᵀ = 0."""
    d = X.shape[-1] - 1
    QV = quadratic.apply_Q(V, e)
    LV = jnp.einsum("nra,nab->nrb", V[..., :d], Lam)
    return QV - jnp.concatenate(
        [LV, jnp.zeros_like(V[..., d:])], axis=-1
    )


def crit_residual(X: jnp.ndarray, Lam: jnp.ndarray, e: EdgeSet) -> float:
    """‖S Xᵀ‖_F / max(1, ‖Q Xᵀ‖_F): 0 at exact first-order criticality."""
    SX = s_matvec(X, X, Lam, e)
    QX = quadratic.apply_Q(X, e)
    den = float(jnp.linalg.norm(QX))
    return float(jnp.linalg.norm(SX)) / max(1.0, den)


def _q_scale(e: EdgeSet, n: int) -> float:
    """Cheap spectral-scale bound for Q: max per-pose diagonal-block norm
    (undamped Jacobi blocks are exactly the diagonal blocks of Q)."""
    P = quadratic.precond_blocks(e, n, damping=0.0)
    return float(jnp.max(jnp.linalg.norm(P, axis=(-2, -1)))) + 1e-30


# relative band around the accept threshold inside which a certificate
# verdict requires second-shift agreement (see CertificateResult)
MARGIN_GUARD_BAND = 1e-7


def s_sparse(X: jnp.ndarray, Lam: jnp.ndarray, e: EdgeSet):
    """Assemble S = Q − Λ̂ as a HOST scipy CSR matrix (fp64).

    ARPACK needs hundreds-to-thousands of matvecs, and each
    device-dispatched ``s_matvec`` pays a dispatch and a device-to-host
    copy. S is block-sparse with n + 2E blocks of (d+1)²; assembling it
    once lets ARPACK multiply on the host. Per edge (i, j) with
    rotation R̃, translation t̃ and effective weights (κw, τw) the
    quadratic form contributes

        Q_ii = [[κw·R̃R̃ᵀ + τw·t̃t̃ᵀ, τw·t̃], [τw·t̃ᵀ, τw]]
        Q_ij = [[−κw·R̃, −τw·t̃], [0, −τw]]      (Q_ji = Q_ijᵀ)
        Q_jj = [[κw·I_d, 0], [0, τw]]

    (identical block algebra to ``quadratic.precond_blocks``); Λ̂ subtracts Λᵢ on the Y-block of
    pose i. Matches :func:`s_matvec` exactly (pinned in tests).
    """
    import scipy.sparse as sp

    n, _, dp1 = X.shape
    d = dp1 - 1
    src = np.asarray(e.src)
    dst = np.asarray(e.dst)
    kw, tw = e.effective_weights()
    kw = np.asarray(kw, np.float64)
    tw = np.asarray(tw, np.float64)
    R = np.asarray(e.R, np.float64)
    t = np.asarray(e.t, np.float64)
    E = src.shape[0]
    B = dp1
    I_d = np.eye(d)
    RRt = np.einsum("eab,ecb->eac", R, R)
    ttT = t[:, :, None] * t[:, None, :]
    Zii = np.zeros((E, B, B))
    Zii[:, :d, :d] = kw[:, None, None] * RRt + tw[:, None, None] * ttT
    Zii[:, :d, d] = tw[:, None] * t
    Zii[:, d, :d] = tw[:, None] * t
    Zii[:, d, d] = tw
    Zij = np.zeros((E, B, B))
    Zij[:, :d, :d] = -kw[:, None, None] * R
    Zij[:, :d, d] = -tw[:, None] * t
    Zij[:, d, d] = -tw
    Zjj = np.zeros((E, B, B))
    Zjj[:, :d, :d] = kw[:, None, None] * I_d
    Zjj[:, d, d] = tw
    Zji = np.swapaxes(Zij, -1, -2)

    a_idx = np.arange(B)
    rows_blk = np.repeat(a_idx, B)[None, :]  # (1, B*B)
    cols_blk = np.tile(a_idx, B)[None, :]
    rows, cols, vals = [], [], []
    for bi, bj, Z in (
        (src, src, Zii), (src, dst, Zij), (dst, src, Zji), (dst, dst, Zjj)
    ):
        rows.append((bi[:, None] * B + rows_blk).ravel())
        cols.append((bj[:, None] * B + cols_blk).ravel())
        vals.append(Z.reshape(E, -1).ravel())
    # −Λ̂ on the Y-block diagonal
    Lam_np = np.asarray(Lam, np.float64)
    pidx = np.arange(n)
    ry = np.repeat(np.arange(d), d)[None, :]
    cy = np.tile(np.arange(d), d)[None, :]
    rows.append((pidx[:, None] * B + ry).ravel())
    cols.append((pidx[:, None] * B + cy).ravel())
    vals.append(-Lam_np.reshape(n, -1).ravel())
    N = n * B
    S = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N),
    ).tocsr()
    return S


def min_eig_lanczos(
    X: jnp.ndarray,
    Lam: jnp.ndarray,
    e: EdgeSet,
    num_eigs: int = 1,
    tol: float = 1e-6,
    maxiter: Optional[int] = None,
    sigma_boost: float = 1.0,
    host_sparse: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Smallest eigenpair of S by *shifted* Lanczos (scipy ``eigsh``).

    S has an exact nullspace at any critical point (S Xᵀ = 0), and ARPACK's
    ``which='SA'`` stalls or returns interior Ritz values near a degenerate
    zero cluster (observed on tinyGrid3D: returned +3.34 with four exact
    zeros below it). The SE-Sync-standard fix: get σ ≳ λ_max(S) from a
    ``which='LA'`` solve, then find λ_max(σI − S) = σ − λ_min(S) — the
    extreme-end target Lanczos is reliable for.

    ``host_sparse`` (default) assembles S once as a host CSR matrix
    (:func:`s_sparse`) instead of dispatching one device matvec per
    Lanczos iteration — the 1,506 s → seconds fix for large certifies.

    Returns (eigvals ascending (k,), eigvecs (N, k)).
    """
    import scipy.sparse.linalg as sla

    n, _, dp1 = X.shape
    N = n * dp1
    dtype = np.float64 if X.dtype == jnp.float64 else np.float32

    if host_sparse:
        S_host = s_sparse(X, Lam, e).astype(dtype)

        def s_apply(v):
            return S_host @ v.astype(dtype)

    else:
        mv = jax.jit(lambda v: s_matvec(v, X, Lam, e))

        def s_apply(v):
            # layout: v packs pose-major [Y cols | p]; (N,) -> (n, 1, d+1)
            V = jnp.asarray(v, X.dtype).reshape(n, dp1)[:, None, :]
            return np.asarray(mv(V)).reshape(N).astype(dtype)

    def top_eig(matvec):
        op = sla.LinearOperator((N, N), matvec=matvec, dtype=dtype)
        try:
            vals, vecs = sla.eigsh(
                op, k=num_eigs, which="LA", tol=tol, maxiter=maxiter
            )
        except sla.ArpackNoConvergence as exc:  # pragma: no cover - rare
            if not len(exc.eigenvalues):
                raise
            vals, vecs = exc.eigenvalues, exc.eigenvectors
        return vals[-1], vals, vecs

    lam_max, _, _ = top_eig(s_apply)
    # sigma_boost > 1 selects an intentionally DIFFERENT (larger) shift —
    # the second-opinion run of the margin guard must not share the
    # original's spectral conditioning
    sigma = (abs(float(lam_max)) * 1.01 + 1e-8) * float(sigma_boost)

    _, vals_sh, vecs = top_eig(lambda v: sigma * v - s_apply(v))
    vals = sigma - vals_sh[::-1]  # ascending eigenvalues of S
    return vals, vecs[:, ::-1]


def certify(
    X: jnp.ndarray,
    e: EdgeSet,
    eig_tol: float = 1e-5,
    crit_tol: float = 1e-5,
    lanczos_tol: float = 1e-6,
    maxiter: Optional[int] = None,
) -> CertificateResult:
    """Certify a candidate lifted solution as globally optimal.

    ``eig_tol`` and ``crit_tol`` are *relative* to the Q diagonal-block
    scale: S ⪰ 0 is accepted at min_eig ≥ −eig_tol·scale. A point that is
    not critical to ``crit_tol`` fails fast without an eigensolve.
    """
    n = X.shape[0]
    Lam = lambda_blocks(X, e)
    scale = _q_scale(e, n)
    cres = crit_residual(X, Lam, e)
    if cres > crit_tol:
        return CertificateResult(False, float("nan"), cres, None, scale)
    vals, vecs = min_eig_lanczos(
        X, Lam, e, tol=lanczos_tol, maxiter=maxiter
    )
    min_eig = float(vals[0])
    vec = vecs[:, 0].reshape(n, X.shape[-1])
    is_global = min_eig >= -eig_tol * scale
    # margin guard: a verdict decided by a margin thinner than the guard
    # band is re-checked with an INDEPENDENT spectral shift (sigma chosen
    # from a different bound); both runs must land on the same side
    min_eig2 = None
    verified = True
    margin = abs(min_eig + eig_tol * scale)
    if margin < MARGIN_GUARD_BAND * scale:
        vals2, _ = min_eig_lanczos(
            X, Lam, e, tol=lanczos_tol * 0.1, maxiter=maxiter,
            sigma_boost=3.0,
        )
        min_eig2 = float(vals2[0])
        verified = (min_eig2 >= -eig_tol * scale) == is_global
    return CertificateResult(
        is_global, min_eig, cres, vec, scale, min_eig2, verified
    )


def escape_direction(
    X: jnp.ndarray, result: CertificateResult
) -> jnp.ndarray:
    """Riemannian-staircase rank ascent from a failed certificate.

    Returns X⁺ of rank r+1: X with a zero row appended, plus the negative
    eigenvector as a tangent row — ⟨v, S v⟩ = min_eig < 0 makes the lifted
    direction (0,…,0, vᵀ) a strict second-order descent direction at X⁺
    (SE-Sync Alg. 2 / Burer–Monteiro saddle escape). The caller takes a
    small step along it and re-solves at the new rank.
    """
    if result.eigvec is None:
        raise ValueError("certificate has no eigenvector (criticality failed)")
    n, r, dp1 = X.shape
    Xp = jnp.concatenate(
        [X, jnp.zeros((n, 1, dp1), X.dtype)], axis=1
    )
    v = jnp.asarray(result.eigvec, X.dtype)[:, None, :]  # (n, 1, d+1)
    dirn = jnp.concatenate(
        [jnp.zeros((n, r, dp1), X.dtype), v], axis=1
    )
    return Xp, dirn
