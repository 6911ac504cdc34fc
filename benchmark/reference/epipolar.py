"""Batched essential-matrix estimation, the consensus initial guess and
the outlier gates: spherical_bundle_adjuster_tpu/solver/epipolar.py.

All RANSAC trials run as one batch (a trial axis written out where the
reference vmapped). Each trial weights a uniform 25% subsample of the
valid matches (Gumbel top-n), takes the null vector of the 9x9 normal
matrix by Cholesky inverse iteration, factors it with one 3x3 SVD and
decomposes it into (R1, R2, t). The winner minimizes the 20-80%-trimmed
mean distance to all other candidate Euler vectors, or, with
scoring="inlier_count", maximizes its epipolar inlier count; a
cheirality vote fixes the sign of t. `initial_guess_topk` keeps the k
best candidates and a Kabsch rotation-only start for multi-start
refinement, and the gates (`epipolar_inlier_mask`,
`residual_inlier_mask`) take a leading start axis.

Every function takes an optional leading pair axis: banks (P, M, 3),
masks (P, M), Gumbel draws (P, trials, M), so P consensus problems run
at once (the reference vmapped pairs); each pair's problem is the one it
would be alone. Without the axis, every function is the single-pair one.

torch cannot reproduce jax.random.gumbel, so `ransac_trials`,
`initial_guess` and `initial_guess_topk` take an optional
(..., num_trials, M) Gumbel tensor; parity tests feed them the
reference's draws. Without one, the draws come from the given
torch.Generator.

Constraint convention: row_i = flatten(outer(b_left_i, b_right_i)), i.e.
b_left^T E b_right = 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import rotation
from .config import RansacConfig


class InitialGuess(NamedTuple):
    euler: torch.Tensor          # (..., 3) winning rotation as Euler (rx, ry, rz)
    translation: torch.Tensor    # (..., 3) unit translation of the winning trial
    num_candidates: torch.Tensor  # (...) int: valid (R, t) candidates
    ok: torch.Tensor             # (...) bool: at least one valid candidate


_W = ((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _constraint_rows(b1, b2):
    """(..., N, 9) rows flatten(outer(b1_i, b2_i))."""
    return (b1[..., :, None] * b2[..., None, :]).reshape(b1.shape[:-1] + (9,))


def _null_vector(ata, iters: int = 3, shift_scale: float = 1e-6):
    """Unit eigenvector of the smallest eigenvalue of PSD (..., 9, 9):
    inverse iteration with a trace-scaled shift (the reference's
    smallmat.smallest_eigvec_psd, with a library Cholesky)."""
    n = ata.shape[-1]
    tr = torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1)
    eps = shift_scale * torch.clamp(tr, min=1e-30) / n
    eye = torch.eye(n, dtype=ata.dtype, device=ata.device)
    L, _ = torch.linalg.cholesky_ex(ata + eps[..., None, None] * eye)
    v = torch.full(ata.shape[:-1], 1.0 / n**0.5, dtype=ata.dtype, device=ata.device)
    for _ in range(iters):
        v = torch.cholesky_solve(v[..., None], L)[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def decompose_essential(E):
    """(..., 3, 3) E -> (R1, R2, t): R1 = U W Vt, R2 = U W^T Vt, t = U[:, 2]
    with det-corrected U / Vt (the cv::decomposeEssentialMat convention)."""
    u, _, vt = torch.linalg.svd(E)
    u = torch.where((torch.linalg.det(u) < 0)[..., None, None], -u, u)
    vt = torch.where((torch.linalg.det(vt) < 0)[..., None, None], -vt, vt)
    w = torch.tensor(_W, dtype=E.dtype, device=E.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    return r1, r2, u[..., :, 2]


def essential_from_bearings(b1, b2, weights):
    """Weighted 8-point essential matrix (3, 3), rank-2 projected.
    b1, b2: (N, 3); weights: (N,) subsample mask."""
    a = _constraint_rows(b1, b2)
    ata = (a * weights[:, None]).T @ a
    e = _null_vector(ata).reshape(3, 3)
    u, s, vt = torch.linalg.svd(e, full_matrices=False)
    s2 = torch.cat([s[:2], torch.zeros_like(s[2:])])
    return (u * s2[None, :]) @ vt


def _trial_pose(b1, b2, weights):
    """Batched 8-point estimates -> (R1, R2, t), one SVD per trial (the
    projected E's SVD factors the same matrix). b1, b2: (..., N, 3);
    weights: (..., T, N)."""
    a = _constraint_rows(b1, b2)  # (..., N, 9)
    ata = torch.einsum("...tn,...ni,...nj->...tij", weights, a, a)
    e = _null_vector(ata).reshape(weights.shape[:-1] + (3, 3))
    return decompose_essential(e)


def eight_point_trial(b1, b2, weights, max_euler_valid):
    """8-point trials -> candidates of both branches: euler (..., T, 2, 3),
    t (..., T, 2, 3) (the same t for both), valid (..., T, 2) =
    |euler|_inf < bound."""
    r1, r2, t = _trial_pose(b1, b2, weights)
    euler = torch.stack([rotation.matrix_to_euler(r1), rotation.matrix_to_euler(r2)], -2)
    valid = torch.amax(torch.abs(euler), dim=-1) < max_euler_valid
    return euler, torch.stack([t, t], -2), valid


def consensus_scores(euler, valid, trim_lo: float, trim_hi: float):
    """Trimmed-mean mode-consensus score per candidate (the reference's
    loop includes the self-distance 0 at rank 0, replicated).
    euler: (..., C, 3); valid: (..., C). Returns (score (..., C) +inf on
    invalid slots, n_cand (...) int)."""
    n_cand = torch.sum(valid.to(torch.int32), dim=-1)
    dist = torch.linalg.vector_norm(euler[..., :, None, :] - euler[..., None, :, :], dim=-1)
    dist = torch.where(valid[..., None, :], dist, torch.inf)
    dist_sorted = torch.sort(dist, dim=-1).values
    rank = torch.arange(dist.shape[-1], device=euler.device)
    nf = n_cand.to(torch.float32)
    lo = torch.floor(trim_lo * nf).to(torch.int64)[..., None, None]
    hi = torch.floor(trim_hi * nf).to(torch.int64)[..., None, None]
    keep = (rank >= lo) & (rank < hi)
    kept = torch.where(keep & torch.isfinite(dist_sorted), dist_sorted, 0.0)
    denom = torch.clamp(torch.sum(keep, dim=-1), min=1).to(torch.float32)
    score = torch.sum(kept, dim=-1) / denom
    return torch.where(valid, score, torch.inf), n_cand


def _matvec(A, x):
    """A (..., M, 3) times x (..., 3) -> (..., M)."""
    return A @ x if x.ndim == 1 else (A @ x[..., None])[..., 0]


def resolve_translation_sign(b_left, b_right, match_valid, euler, t):
    """Cheirality vote: t or -t, whichever makes the midpoint-triangulated
    match depths (model X2 = R X1 - t) mostly positive. Banks (..., M, 3)
    against the pose (..., 3)."""
    Rm = rotation.euler_to_matrix(euler).transpose(-1, -2)
    a = b_left @ Rm.transpose(-1, -2)
    c = b_right
    s = torch.sum(a * c, dim=-1)
    at = _matvec(a, t)
    ct = _matvec(c, t)
    den = torch.clamp(1.0 - s * s, min=1e-6)
    d1 = (at - s * ct) / den
    d2 = (s * at - ct) / den
    vote = torch.sum(torch.where(match_valid, torch.sign(d1) + torch.sign(d2), 0.0), dim=-1)
    return torch.where(vote[..., None] < 0, -t, t)


def gumbel_draws(num_trials: int, m: int, generator, device, lead=()):
    """lead + (num_trials, m) standard Gumbel noise from a torch.Generator."""
    u = torch.rand(tuple(lead) + (num_trials, m), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def ransac_trials(b_left, b_right, match_valid, generator, cfg: RansacConfig,
                  gumbel=None):
    """All RANSAC trials as one batch -> flat candidate banks
    (euler (..., 2T, 3), t (..., 2T, 3), valid (..., 2T)).

    Each trial picks floor(valid_count * sample_fraction) (at least 9)
    distinct valid matches uniformly at random: the matches whose Gumbel
    score reaches the trial's n_sample-th largest.
    """
    m = b_left.shape[-2]
    lead = match_valid.shape[:-1]
    dev = b_left.device
    v = torch.sum(match_valid.to(torch.int32), dim=-1)
    n_sample = (v.to(torch.float32) * cfg.sample_fraction).to(torch.int64)
    n_sample = torch.minimum(torch.clamp(n_sample, min=9), v.to(torch.int64))
    if gumbel is None:
        gumbel = gumbel_draws(cfg.num_trials, m, generator, dev, lead)
    g = torch.where(match_valid[..., None, :], gumbel.to(dev, torch.float32), -torch.inf)
    pos = (m - torch.clamp(n_sample, 1, m))[..., None, None].expand(g.shape[:-1] + (1,))
    thr = torch.gather(torch.sort(g, dim=-1).values, -1, pos)
    w = ((g >= thr) & match_valid[..., None, :]).to(torch.float32)
    euler, t, valid = eight_point_trial(b_left, b_right, w, cfg.max_euler_valid)
    valid = valid.reshape(lead + (-1,)) & (v >= 9)[..., None]
    return euler.reshape(lead + (-1, 3)), t.reshape(lead + (-1, 3)), valid


def candidate_inlier_counts(b_left, b_right, match_valid, eulers, ts, thresh_rad):
    """(..., C) int32: per candidate (eulers, ts (..., C, 3)), the valid
    matches whose angular epipolar residual against E_c = [t_c]x R_c is at
    most thresh_rad."""
    E = rotation.skew(ts) @ rotation.euler_to_matrix(eulers)  # (..., C, 3, 3)
    n = torch.einsum("...cik,...mk->...cmi", E, b_right)  # (..., C, M, 3)
    n_norm = torch.linalg.vector_norm(n, dim=-1)
    sin_res = (torch.abs(torch.einsum("...mi,...cmi->...cm", b_left, n))
               / torch.clamp(n_norm, min=1e-12))
    ok = (sin_res <= math.sin(thresh_rad)) & match_valid[..., None, :]
    return torch.sum(ok.to(torch.int32), dim=-1)


def masked_median(x, valid):
    """Median of x (..., M) over its valid slots (the lower middle for an
    even count): (...,). valid broadcasts against x."""
    valid = valid.expand(x.shape)
    n = torch.sum(valid.to(torch.int64), dim=-1)
    xs = torch.sort(torch.where(valid, x, torch.inf), dim=-1).values
    mid = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, x.shape[-1] - 1)
    return torch.gather(xs, -1, mid[..., None])[..., 0]


def residual_inlier_mask(residual, match_valid, thresh_rad: float, k_med: float = 3.0,
                         min_keep: int = 9):
    """Adaptive gate over (..., M) residuals: keep the valid matches at most
    max(thresh_rad, k_med * median residual); where fewer than min_keep
    survive, the mask is returned unchanged."""
    med = masked_median(residual, match_valid)
    thr = torch.clamp(k_med * med, min=thresh_rad)
    gated = match_valid & (residual <= thr[..., None])
    enough = torch.sum(gated.to(torch.int32), dim=-1) >= min_keep
    return torch.where(enough[..., None], gated, match_valid)


def epipolar_inlier_mask(b_left, b_right, match_valid, euler, translation,
                         thresh_rad: float, k_med: float = 3.0, min_keep: int = 9):
    """match_valid (..., M) gated by the angular epipolar residual
    asin(|b_l . n| / |n|), n = E b_r, E = [t]x R(euler), of the pose
    (euler, translation) (..., 3); matches near the epipole (|n| < 1e-6)
    get residual 0."""
    E = rotation.skew(translation) @ rotation.euler_to_matrix(euler)
    n = torch.einsum("...ij,...mj->...mi", E, b_right)
    n_norm = torch.linalg.vector_norm(n, dim=-1)
    sin_res = torch.abs(torch.sum(b_left * n, dim=-1)) / torch.clamp(n_norm, min=1e-12)
    sin_res = torch.where(n_norm < 1e-6, 0.0, sin_res)
    ang = torch.arcsin(torch.clamp(sin_res, 0.0, 1.0))
    return residual_inlier_mask(ang, match_valid, thresh_rad, k_med, min_keep)


def kabsch_rotation_hypothesis(b_left, b_right, match_valid, n_irls: int = 2):
    """Rotation-only start: the rotation maximizing sum w_i b_r . (R b_l)
    (orthogonal Procrustes) with n_irls Cauchy reweighting rounds.
    Returns (euler (..., 3) of R^T, the candidate banks' convention; ok =
    at least 3 valid matches)."""

    def fit(w):
        c = torch.einsum("...m,...mi,...mj->...ij", w, b_right, b_left)
        u, _, vt = torch.linalg.svd(c)
        d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
        signs = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
        return (u * signs[..., None, :]) @ vt

    valid_f = match_valid.to(torch.float32)
    w = valid_f
    for _ in range(n_irls):
        R = fit(w)
        cosang = torch.clamp(torch.sum((b_left @ R.transpose(-1, -2)) * b_right, dim=-1),
                             -1.0, 1.0)
        ang = torch.arccos(cosang)
        scale = torch.clamp(1.5 * masked_median(ang, match_valid), min=math.radians(0.05))
        w = valid_f / (1.0 + (ang / scale[..., None]) ** 2)
    euler = rotation.matrix_to_euler(fit(w).transpose(-1, -2))
    return euler, torch.sum(match_valid.to(torch.int32), dim=-1) >= 3


def initial_guess(b_left, b_right, match_valid, generator,
                  cfg: RansacConfig = RansacConfig(), gumbel=None) -> InitialGuess:
    """Consensus relative-pose initial guess over all matches.

    b_left / b_right: (..., M, 3) bearing banks (padded); match_valid:
    (..., M).
    """
    euler, t, valid = ransac_trials(b_left, b_right, match_valid, generator, cfg, gumbel)
    score, n_cand = consensus_scores(euler, valid, cfg.trim_lo, cfg.trim_hi)
    if cfg.scoring == "inlier_count":
        counts = candidate_inlier_counts(b_left, b_right, match_valid, euler, t,
                                         math.radians(cfg.inlier_thresh_deg))
        counts = torch.where(valid, counts, -1)
        # most epipolar inliers first; the trimmed-mode score, scaled into
        # [0, 1), breaks ties and never outranks one inlier
        top = torch.amax(torch.where(valid, score, 0.0), dim=-1, keepdim=True)
        tie = torch.clamp(score / (top + 1e-6), 0.0, 1.0)
        tie = torch.where(torch.isfinite(tie), tie, 1.0)
        win = torch.argmax(counts.to(torch.float32) - 0.5 * tie, dim=-1)
    else:
        win = torch.argmin(score, dim=-1)
    ok = n_cand > 0
    e_win = pick(euler, win)
    t_win = pick(t, win)
    if cfg.cheirality:
        t_win = resolve_translation_sign(b_left, b_right, match_valid, e_win, t_win)
    return InitialGuess(
        euler=torch.where(ok[..., None], e_win, torch.zeros_like(e_win)),
        translation=torch.where(ok[..., None], t_win,
                                torch.tensor([1.0, 0.0, 0.0], device=t_win.device)),
        num_candidates=n_cand,
        ok=ok,
    )


def pick(x, idx):
    """x (..., C, ...) at index idx (...) of its candidate axis, the first
    axis after idx's: x[idx] without a leading axis, else per pair."""
    if idx.ndim == 0:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device), idx]


def k_smallest(score, k: int):
    """Indices of the k smallest scores (..., C) along the last axis, ties
    toward the lower index (the order of the reference's
    lax.top_k(-score, k); torch.topk promises no tie order)."""
    return torch.sort(score, dim=-1, stable=True).indices[..., :k]


def initial_guess_topk(b_left, b_right, match_valid, generator,
                       cfg: RansacConfig = RansacConfig(), k: int = 4, gumbel=None):
    """The k best consensus candidates (ascending trimmed-mode score, the
    lower index first on ties) as multi-start inits; with
    cfg.rotation_hypothesis the last slot holds the Kabsch rotation-only
    start with t = 0 instead. Slots past the candidate count repeat the
    best one. Returns (eulers (..., k, 3), translations (..., k, 3), ok
    (...))."""
    euler, t, valid = ransac_trials(b_left, b_right, match_valid, generator, cfg, gumbel)
    score, n_cand = consensus_scores(euler, valid, cfg.trim_lo, cfg.trim_hi)
    order = k_smallest(score, k)
    ok = n_cand > 0
    slot_ok = torch.arange(k, device=score.device) < n_cand[..., None]
    idx = torch.where(slot_ok, order, order[..., :1])
    e_sel = torch.take_along_dim(euler, idx[..., None], dim=-2)
    t_sel = torch.take_along_dim(t, idx[..., None], dim=-2)
    if cfg.cheirality:
        def signs(bl, br, mv, e, tt):  # the k slots of one pair
            return torch.vmap(lambda ee, ttt: resolve_translation_sign(bl, br, mv, ee, ttt))(e, tt)

        if ok.ndim:
            signs = torch.vmap(signs)
        t_sel = signs(b_left, b_right, match_valid, e_sel, t_sel)
    okk = ok[..., None, None]
    e_k = torch.where(okk, e_sel, torch.zeros_like(e_sel))
    t_k = torch.where(okk, t_sel, torch.tensor([1.0, 0.0, 0.0], device=t_sel.device))
    if cfg.rotation_hypothesis and k >= 2:
        # usable without any consensus candidate: pure rotation can leave
        # every 8-point trial invalid
        e_rot, rot_ok = kabsch_rotation_hypothesis(b_left, b_right, match_valid)
        last = (torch.arange(k, device=e_k.device)[:, None] == k - 1) & rot_ok[..., None, None]
        e_k = torch.where(last, e_rot[..., None, :], e_k)
        t_k = torch.where(last, 0.0, t_k)
        ok = ok | rot_ok
    return e_k, t_k, ok
