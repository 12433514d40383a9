"""The lifted PGO quadratic form and its edge-parallel operators.

This is the framework's hot path — the matrix-free replacement for the DPGO
core's cached data matrices ("connection Laplacian", invalidated by
``PoseGraph::clearDataMatrices`` on weight changes, reference
``src/PGOAgentROS.cpp:1351``).

The cost over lifted poses X ∈ (St(d,r) × R^r)^n is

  f(X) = Σ_e w_e [ κ_e ||Y_j − Y_i R_e||_F² + τ_e ||p_j − p_i − Y_i t_e||² ]

a homogeneous quadratic f(X) = <X, Q(X)> with Q a sparse PSD linear operator.
We never materialize Q: every operator below is an edge-parallel
gather → small-matmul → scatter-add pipeline with static shapes, which XLA
fuses into a handful of kernels. Because f is quadratic, the Euclidean
Hessian-vector product is the *same* linear map as the gradient:
ehess(X)[V] = 2 Q(V) = apply_Q(V) * 2 — no autodiff or re-linearization
needed inside the tCG loop.

Padded edges (mask 0, src=dst=0) contribute exactly zero to every operator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_ros_tpu.ops import stiefel
from dpgo_ros_tpu.ops.batched import bmm, bmm_nt, bmm_tn, bmv, outer


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EdgeSet:
    """Static-shape struct-of-arrays edge data (device-resident).

    ``src``/``dst`` are *flattened global* pose indices (robot blocks
    concatenated). ``weight`` is the robust (GNC) weight; ``mask`` zeroes
    padding edges. ``is_loop`` marks non-odometry edges (eligible for GNC
    reweighting — odometry is fixedWeight per reference ``utils.cpp:141-149``).

    ``pull`` (optional, (n, D) int32) is the transpose-incidence gather
    index: row i lists the contribution rows of pose i's incident edges
    (edge k as src ↦ k; edge k as dst ↦ E + k; padding ↦ 2E). When present,
    every accumulation uses gather-sum instead of scatter-add (the pull
    path is pure gathers; whether it beats scatter-add on a given device
    is a measurement, not a given). Build with
    :func:`build_pull_index`.
    """

    src: jnp.ndarray  # (E,) int32
    dst: jnp.ndarray  # (E,) int32
    R: jnp.ndarray  # (E, d, d)
    t: jnp.ndarray  # (E, d)
    kappa: jnp.ndarray  # (E,)
    tau: jnp.ndarray  # (E,)
    weight: jnp.ndarray  # (E,)
    mask: jnp.ndarray  # (E,) 1.0 real / 0.0 padding
    is_loop: jnp.ndarray  # (E,) 1.0 if GNC-adjustable loop closure
    pull: Optional[jnp.ndarray] = None  # (n, D) int32 gather index

    @property
    def d(self) -> int:
        return int(self.R.shape[-1])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def effective_weights(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(κ_eff, τ_eff) = mask * weight * (κ, τ)."""
        w = self.mask * self.weight
        return w * self.kappa, w * self.tau


def build_pull_index(
    src, dst, n: int, num_edge_rows: Optional[int] = None
) -> np.ndarray:
    """Host-side build of the (n, D) transpose-incidence gather index.

    Row i lists contribution rows for pose i (edge k as src ↦ k, edge k as
    dst ↦ Epad + k), padded with 2·Epad (a zero row). ``num_edge_rows`` is
    the *padded* edge count Epad when src/dst cover only real edges.
    D = max pose degree.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    E = src.shape[0]
    Epad = num_edge_rows or E
    lists = [[] for _ in range(n)]
    for k in range(E):
        lists[int(src[k])].append(k)
        lists[int(dst[k])].append(Epad + k)
    D = max(1, max(len(l) for l in lists))
    out = np.full((n, D), 2 * Epad, np.int32)
    for i, l in enumerate(lists):
        out[i, : len(l)] = l
    return out


def _pull_sum(contrib_src: jnp.ndarray, contrib_dst: jnp.ndarray, pull: jnp.ndarray) -> jnp.ndarray:
    """Accumulate per-edge contributions into per-pose sums via gather-sum.

    contrib_src/contrib_dst: (E, ...) contributions to the src/dst endpoint.
    Returns (n, ...). Pure gathers — no scatter.
    """
    zero = jnp.zeros((1,) + contrib_src.shape[1:], contrib_src.dtype)
    C = jnp.concatenate([contrib_src, contrib_dst, zero], axis=0)  # (2E+1, ...)
    return jnp.sum(C[pull], axis=1)  # (n, D, ...) -> (n, ...)


def residuals(X: jnp.ndarray, e: EdgeSet) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-edge residuals r1 = Y_j − Y_i R_e (E, r, d), r2 = p_j − p_i − Y_i t_e (E, r)."""
    d = e.d
    Xi = X[e.src]  # (E, r, d+1)
    Xj = X[e.dst]
    Yi, pi = Xi[..., :d], Xi[..., d]
    Yj, pj = Xj[..., :d], Xj[..., d]
    r1 = Yj - bmm(Yi, e.R)
    r2 = pj - pi - bmv(Yi, e.t)
    return r1, r2


def cost(X: jnp.ndarray, e: EdgeSet) -> jnp.ndarray:
    """f(X) — the global objective (reference's fOpt/fInit telemetry,
    ``src/PGOAgentROS.cpp:166-172``)."""
    r1, r2 = residuals(X, e)
    kw, tw = e.effective_weights()
    return jnp.sum(kw * jnp.sum(r1 * r1, axis=(-2, -1))) + jnp.sum(
        tw * jnp.sum(r2 * r2, axis=-1)
    )


def egrad(X: jnp.ndarray, e: EdgeSet) -> jnp.ndarray:
    """Euclidean gradient ∇f(X) = 2 Q(X), shape (n, r, d+1).

    Linear in X — also serves as the Euclidean Hessian-vector product:
    ehess[V] = egrad(V).
    """
    n, r, dp1 = X.shape
    d = dp1 - 1
    r1, r2 = residuals(X, e)
    kw, tw = e.effective_weights()
    kr1 = 2.0 * kw[:, None, None] * r1  # (E, r, d)
    tr2 = 2.0 * tw[:, None] * r2  # (E, r)

    # contributions to src pose i: -kr1 R^T - outer(tr2, t) on Y, -tr2 on p
    gYi = -bmm_nt(kr1, e.R) - outer(tr2, e.t)
    gpi = -tr2
    gi = jnp.concatenate([gYi, gpi[..., None]], axis=-1)  # (E, r, d+1)
    # contributions to dst pose j: +kr1 on Y, +tr2 on p
    gj = jnp.concatenate([kr1, tr2[..., None]], axis=-1)

    if e.pull is not None:
        return _pull_sum(gi, gj, e.pull)
    G = jnp.zeros_like(X)
    G = G.at[e.src].add(gi)
    G = G.at[e.dst].add(gj)
    return G


def apply_Q(V: jnp.ndarray, e: EdgeSet) -> jnp.ndarray:
    """Q(V) = egrad(V) / 2 — the bare quadratic-form operator."""
    return 0.5 * egrad(V, e)


def rgrad(X: jnp.ndarray, e: EdgeSet, G: jnp.ndarray | None = None) -> jnp.ndarray:
    """Riemannian gradient: tangent projection of the Euclidean gradient."""
    if G is None:
        G = egrad(X, e)
    return stiefel.proj_tangent(X, G)


def rhess_vp(
    X: jnp.ndarray, V: jnp.ndarray, e: EdgeSet, G: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Riemannian Hessian-vector product on (St(d,r) × R^r)^n.

    Standard embedded-submanifold formula: for the Stiefel block,
    Hess f[V]_Y = Proj( ehess[V]_Y − V_Y sym(Y^T egrad_Y) ); the Euclidean
    translation block needs no correction. Used by the truncated-CG inner
    loop of RTR (reference solver budget ``RTR_tCG_iterations``,
    ``launch/dpgo_demo.launch:34``).
    """
    d = X.shape[-1] - 1
    if G is None:
        G = egrad(X, e)
    EH = egrad(V, e)  # linearity: ehess[V] == egrad(V)
    Y = X[..., :d]
    GY = G[..., :d]
    VY = V[..., :d]
    S = stiefel.sym(bmm_tn(Y, GY))
    corr_Y = bmm(VY, S)
    corr = jnp.concatenate(
        [corr_Y, jnp.zeros_like(V[..., d:])], axis=-1
    )
    return stiefel.proj_tangent(X, EH - corr)


def precond_blocks(e: EdgeSet, n: int, damping: float = 1e-2) -> jnp.ndarray:
    """Per-pose (d+1)×(d+1) diagonal blocks of Q, damped.

    For edge (i→j) with effective weights (κ, τ):
      D_i += [[κ I + τ t tᵀ, τ t], [τ tᵀ, τ]]     (= A_i W A_iᵀ)
      D_j += [[κ I, 0], [0, τ]]
    This is the Jacobi-type preconditioner behind DPGO's
    ``RGD_use_preconditioner`` (reference ``launch/PGOAgent.launch:18``).
    """
    d = e.d
    kw, tw = e.effective_weights()
    # weights may live at a higher precision than the edge tensors (e.g.
    # fp64 solver state over fp32 data); the damped-Jacobi blocks are a
    # preconditioner — compute them at the edge dtype (scatter into a mixed-
    # dtype buffer is a hard error in future JAX)
    kw = kw.astype(e.R.dtype)
    tw = tw.astype(e.R.dtype)
    I = jnp.eye(d, dtype=e.R.dtype)
    ttT = outer(e.t, e.t)
    Dii = jnp.zeros((e.num_edges, d + 1, d + 1), e.R.dtype)
    Dii = Dii.at[:, :d, :d].set(kw[:, None, None] * I + tw[:, None, None] * ttT)
    Dii = Dii.at[:, :d, d].set(tw[:, None] * e.t)
    Dii = Dii.at[:, d, :d].set(tw[:, None] * e.t)
    Dii = Dii.at[:, d, d].set(tw)
    Djj = jnp.zeros((e.num_edges, d + 1, d + 1), e.R.dtype)
    Djj = Djj.at[:, :d, :d].set(kw[:, None, None] * I)
    Djj = Djj.at[:, d, d].set(tw)

    if e.pull is not None:
        D = _pull_sum(Dii, Djj, e.pull)
    else:
        D = jnp.zeros((n, d + 1, d + 1), e.R.dtype)
        D = D.at[e.src].add(Dii)
        D = D.at[e.dst].add(Djj)
    # damping keeps isolated/padded poses invertible and bounds conditioning
    scale = jnp.maximum(
        jnp.trace(D, axis1=-2, axis2=-1)[:, None, None] / (d + 1), 1.0
    )
    return D + damping * scale * jnp.eye(d + 1, dtype=e.R.dtype)


def precond_solve(P: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Apply block-diagonal inverse: V_i ← V_i P_i^{-1}.

    Row-vector convention: the quadratic is tr(Z Q Zᵀ), so the gradient rows
    multiply P^{-1} on the right. P is (n, d+1, d+1) SPD; batched Cholesky
    solve (tiny matrices — XLA keeps them on-chip).

    Hot loops should instead precompute :func:`precond_inverse` once per
    block update and apply it with :func:`precond_apply` instead of a
    factorization per tCG application.
    """
    L = jnp.linalg.cholesky(P)
    # solve P x^T = v^T  for each row block: use triangular solves
    Vt = jnp.swapaxes(V, -1, -2)  # (n, d+1, r)
    Z = jax.scipy.linalg.solve_triangular(L, Vt, lower=True)
    Xt = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), Z, lower=False
    )
    return jnp.swapaxes(Xt, -1, -2)


def precond_inverse(P: jnp.ndarray) -> jnp.ndarray:
    """Batched explicit inverse of the (n, d+1, d+1) SPD damped blocks.

    Computed ONCE per block update; application is then a single batched
    matmul (:func:`precond_apply`) instead of per-iteration factorizations.
    """
    L = jnp.linalg.cholesky(P)
    eye = jnp.broadcast_to(jnp.eye(P.shape[-1], dtype=P.dtype), P.shape)
    Z = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.einsum("nki,nkj->nij", Z, Z)  # L^{-T} L^{-1} = P^{-1}


def precond_apply(Pinv: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """V_i ← V_i P_i^{-1} with a precomputed symmetric inverse (one batched
    matmul)."""
    return bmm(V, Pinv)
