"""Radial-distortion homography initialization, fully batched.

Batched redesign of the reference's RANSAC loop
(``src/optimization/homography.rs:219-262``): instead of 1000 sequential
{shuffle, 6-point solve, score} iterations, all hypotheses are drawn with
Gumbel top-k sampling from one PRNG key and solved/scored as a single
vmapped batch under ``jit`` — one (S,8,8) QR, one (S,4,4) solve, one
(S,N) scoring pass, one argmin.

The 6-point minimal solver follows the radial-distortion homography
formulation of Kukelova et al., CVPR 2015 (the method the reference README
credits): observed points lift to (x, y, 1 + l*r^2) with the division
model; a 6x8 design matrix has a 2D null space; the constraint that H maps
lifted source points to lifted target rays yields a quadratic in the
null-space mixing coefficient gamma, and the remaining row of H plus the
second distortion l' come from a 6x4 least-squares system.

``homography_to_focal`` is the classic closed-form focal-from-homography
(two constraint pairs, geometric-mean combination) used at
``src/util.rs:116-122``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def lift(p, l):
    """Division-model lifting (x,y) -> (x, y, 1 + l r^2)."""
    r2 = jnp.sum(p * p, axis=-1)
    return jnp.concatenate([p, (1.0 + l * r2)[..., None]], axis=-1)


def _solve_h6(p0, p1):
    """Minimal 6-point solver. p0,p1: (6,2) normalized pairs.

    Returns (lam, H (3,3), valid).
    """
    x, y = p0[:, 0], p0[:, 1]
    xp, yp = p1[:, 0], p1[:, 1]
    r2 = x * x + y * y
    rp2 = xp * xp + yp * yp
    # 6x8 design matrix; null space encodes rows 0,1 of H and the l-terms
    M = jnp.stack(
        [
            -x * yp,
            -y * yp,
            -yp,
            x * xp,
            xp * y,
            xp,
            -r2 * yp,
            r2 * xp,
        ],
        axis=-1,
    )  # (6,8)
    Q, _ = jnp.linalg.qr(M.T, mode="complete")  # (8,8)
    n0 = Q[:, 6]
    n1 = Q[:, 7]
    n02, n05, n06, n07 = n0[2], n0[5], n0[6], n0[7]
    n12, n15, n16, n17 = n1[2], n1[5], n1[6], n1[7]

    a_coef = n02 * n07 - n05 * n06
    b_minus = -n02 * n17 + n05 * n16 + n06 * n15 - n07 * n12
    disc = (
        n02 * n02 * n17 * n17
        - 2.0 * n02 * n05 * n16 * n17
        - 2.0 * n02 * n06 * n15 * n17
        - 2.0 * n02 * n07 * n12 * n17
        + 4.0 * n02 * n07 * n15 * n16
        + n05 * n05 * n16 * n16
        + 4.0 * n05 * n06 * n12 * n17
        - 2.0 * n05 * n06 * n15 * n16
        - 2.0 * n05 * n07 * n12 * n16
        + n06 * n06 * n15 * n15
        - 2.0 * n06 * n07 * n12 * n15
        + n07 * n07 * n12 * n12
    )
    ok_disc = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    den = 2.0 * a_coef
    den = jnp.where(jnp.abs(den) > 1e-20, den, 1e-20)
    gammas = jnp.stack([(b_minus - sq) / den, (b_minus + sq) / den])  # (2,)

    def per_gamma(gamma):
        lden = -gamma * n02 - n12
        lden = jnp.where(jnp.abs(lden) > 1e-20, lden, 1e-20)
        l = -(gamma * n06 + n16) / lden
        v1 = gamma * n0 + n1  # (8,)
        h00, h01, h02 = v1[0], v1[1], v1[2]
        h10, h11, h12 = v1[3], v1[4], v1[5]
        # remaining row + l' from the lifted-transfer constraint:
        # rows: [-x xp, -xp y, -xp sc, rp2*(h0 . lift)] [h20,h21,h22,l']=-(h0.lift)
        sc = 1.0 + l * r2
        h0_dot = h00 * x + h01 * y + h02 * sc  # (6,)
        A = jnp.stack([-x * xp, -xp * y, -xp * sc, rp2 * h0_dot], axis=-1)  # (6,4)
        b = -h0_dot
        AtA = A.T @ A + 1e-14 * jnp.eye(4, dtype=A.dtype)
        Atb = A.T @ b
        L = jnp.linalg.cholesky(AtA)
        sol = jax.scipy.linalg.cho_solve((L, True), Atb)
        H = jnp.stack(
            [
                jnp.stack([h00, h01, h02]),
                jnp.stack([h10, h11, h12]),
                sol[:3],
            ]
        )
        lp = sol[3]
        return l, lp, H

    l_a, lp_a, H_a = per_gamma(gammas[0])
    l_b, lp_b, H_b = per_gamma(gammas[1])
    valid_a = (l_a < 0.0) & (lp_a < 0.0)
    valid_b = (l_b < 0.0) & (lp_b < 0.0)

    # both valid: pick the pair with min |log10(l/l')| (most consistent)
    score_a = jnp.abs(jnp.log10(jnp.abs(l_a / jnp.where(lp_a != 0, lp_a, 1e-20))))
    score_b = jnp.abs(jnp.log10(jnp.abs(l_b / jnp.where(lp_b != 0, lp_b, 1e-20))))
    pick_a = jnp.where(
        valid_a & valid_b, score_a < score_b, valid_a
    )
    l = jnp.where(pick_a, l_a, l_b)
    lp = jnp.where(pick_a, lp_a, lp_b)
    H = jnp.where(pick_a, H_a, H_b)
    lam = -jnp.sqrt(jnp.maximum(l * lp, 0.0))
    valid = ok_disc & (valid_a | valid_b)
    return lam, H, valid


def _score(p0, p1, mask, H, lam):
    """Average transfer distance of (H, lam) over all masked pairs.

    Mirrors the reference scoring (homography.rs:169-205): lift source with
    lam, map through H, intersect back with the division-model circle
    (quadratic in the scale alpha), pick the root by the first pair, average
    sqrt distances.
    """
    sc = 1.0 + lam * jnp.sum(p0 * p0, axis=-1)
    r = (H @ jnp.concatenate([p0, sc[:, None]], axis=-1).T).T  # (N,3)
    in_sqrt = jnp.maximum(
        r[:, 2] * r[:, 2] - 4.0 * lam * (r[:, 0] ** 2 + r[:, 1] ** 2), 0.0
    )
    root = jnp.sqrt(in_sqrt)
    a0 = (r[:, 2] - root) / 2.0
    a1 = (r[:, 2] + root) / 2.0
    a0 = jnp.where(jnp.abs(a0) > 1e-20, a0, 1e-20)
    a1 = jnp.where(jnp.abs(a1) > 1e-20, a1, 1e-20)
    # choose branch from the first valid pair
    first = jnp.argmax(mask)
    d0_first = jnp.abs(p1[first, 0] - r[first, 0] / a0[first])
    d1_first = jnp.abs(p1[first, 0] - r[first, 0] / a1[first])
    use0 = d0_first < d1_first
    a = jnp.where(use0, a0, a1)
    d = jnp.sqrt(
        (p1[:, 0] - r[:, 0] / a) ** 2 + (p1[:, 1] - r[:, 1] / a) ** 2
    )
    wsum = jnp.maximum(jnp.sum(mask), 1.0)
    return jnp.sum(jnp.where(mask, d, 0.0)) / wsum


@partial(jax.jit, static_argnames=("n_samples",))
def radial_distortion_homography(key, p0, p1, mask, n_samples=1000):
    """Batched RANSAC estimate of (lambda, H) between two frames.

    Args:
      key: jax PRNG key (replaces the reference's thread RNG; reproducible).
      p0, p1: (N,2) center/half-size-normalized point pairs, aligned by
        board corner index (the dense-board layout makes the id join free).
      mask: (N,) bool — pair observed in both frames.
      n_samples: hypothesis count (reference uses 1000).

    Returns (lambda, H, best_score).
    """
    n = p0.shape[0]
    keys = jax.random.split(key, n_samples)

    def sample_and_solve(k):
        # Gumbel top-6 over valid indices = uniform 6-subset w/o replacement
        g = jax.random.gumbel(k, (n,), dtype=p0.dtype)
        g = jnp.where(mask, g, -jnp.inf)
        _, idx = jax.lax.top_k(g, 6)
        lam, H, valid = _solve_h6(p0[idx], p1[idx])
        score = _score(p0, p1, mask, H, lam)
        # a sample is meaningless with <6 observed pairs (degenerate mask)
        enough = jnp.sum(mask) >= 6
        score = jnp.where(valid & enough, score, jnp.inf)
        return lam, H, score

    lams, Hs, scores = jax.vmap(sample_and_solve)(keys)
    best = jnp.argmin(scores)
    return lams[best], Hs[best], scores[best]


def homography_to_focal_traced(H):
    """Traceable twin of ``homography_to_focal`` (same closed form,
    jnp.where instead of Python branches) so the whole init pipeline can
    run as ONE device graph (calib.initialize._try_init_device).

    Returns (f, ok) as traced scalars."""
    h0, h1, h2 = H[0, 0], H[0, 1], H[0, 2]
    h3, h4, h5 = H[1, 0], H[1, 1], H[1, 2]
    h6, h7 = H[2, 0], H[2, 1]

    def safe_div(n, d):
        return n / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)

    def pair(v1, v2, d1, d2):
        lo = jnp.minimum(v1, v2)
        hi = jnp.maximum(v1, v2)
        val = jnp.where(
            lo > 0.0, jnp.where(jnp.abs(d1) > jnp.abs(d2), hi, lo), hi
        )
        ok = jnp.where(lo > 0.0, True, hi > 0.0)
        return val, ok

    d1a = h6 * h7
    d2a = (h7 - h6) * (h7 + h6)
    f1_sq, f1_ok = pair(
        safe_div(-(h0 * h1 + h3 * h4), d1a),
        safe_div(h0 * h0 + h3 * h3 - h1 * h1 - h4 * h4, d2a),
        d1a, d2a,
    )
    d1b = h0 * h3 + h1 * h4
    d2b = h0 * h0 + h1 * h1 - h3 * h3 - h4 * h4
    f0_sq, f0_ok = pair(
        safe_div(-h2 * h5, d1b), safe_div(h5 * h5 - h2 * h2, d2b), d1b, d2b
    )
    f1 = jnp.sqrt(jnp.maximum(f1_sq, 0.0))
    f0 = jnp.sqrt(jnp.maximum(f0_sq, 0.0))
    f = jnp.where(
        f0_ok & f1_ok,
        jnp.sqrt(jnp.maximum(f0 * f1, 0.0)),
        jnp.where(f0_ok, f0, f1),
    )
    return f, (f0_ok | f1_ok)


def homography_to_focal(H):
    """Closed-form focal from a homography (unit-plane, centered pp).

    Returns (f, valid).  Classic two-constraint derivation (same math as
    src/optimization/homography.rs:274-325): each of two orthogonality/
    equal-norm constraint pairs yields candidate f^2 values; pick per-pair
    by the larger denominator, combine available estimates geometrically.

    Host-side numpy (a dozen scalar ops; not worth a device dispatch).
    """
    import numpy as np

    H = np.asarray(H, dtype=np.float64)
    h0, h1, h2 = H[0]
    h3, h4, h5 = H[1]
    h6, h7 = H[2, 0], H[2, 1]

    def safe_div(n, d):
        return n / (d if abs(d) > 1e-20 else 1e-20)

    def pair(v1, v2, d1, d2):
        # sort so hi = max, lo = min, then (matching the reference's
        # post-swap selection): both positive -> pick hi when |d1|>|d2|
        # else lo; only hi positive -> hi; else invalid.
        lo, hi = min(v1, v2), max(v1, v2)
        if lo > 0.0:
            return (hi if abs(d1) > abs(d2) else lo), True
        return hi, hi > 0.0

    d1a = h6 * h7
    d2a = (h7 - h6) * (h7 + h6)
    f1_sq, f1_ok = pair(
        safe_div(-(h0 * h1 + h3 * h4), d1a),
        safe_div(h0 * h0 + h3 * h3 - h1 * h1 - h4 * h4, d2a),
        d1a, d2a,
    )
    d1b = h0 * h3 + h1 * h4
    d2b = h0 * h0 + h1 * h1 - h3 * h3 - h4 * h4
    f0_sq, f0_ok = pair(
        safe_div(-h2 * h5, d1b), safe_div(h5 * h5 - h2 * h2, d2b), d1b, d2b
    )
    f1 = float(np.sqrt(max(f1_sq, 0.0)))
    f0 = float(np.sqrt(max(f0_sq, 0.0)))
    if f0_ok and f1_ok:
        f = float(np.sqrt(max(f0 * f1, 0.0)))
    elif f0_ok:
        f = f0
    else:
        f = f1
    return f, (f0_ok or f1_ok)
