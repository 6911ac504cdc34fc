"""Port parity for run_two_view_batch at 128x256: the JAX package's three
batch scenes (tests/test_twoview_e2e.py) through both packages' batch
entry points, the port's chunking and its host two-pass auto ladder, each
batch row against the port's own single-pair run, a corrected-mode batch,
and the parallax renderer.

Both packages see the reference's own images (its render_erp) and its
backend-dependent modes pinned; the reference's RANSAC draws (from each
pair's key) are injected, assigned to matches by identity, and the
reference runs on the port's exactly rounded integral image
(test_torch_integral.py), as in tests/test_torch_bench_pair.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from spherical_bundle_adjuster_tpu.core import rotation as jrot
from spherical_bundle_adjuster_tpu.models import frontend as jfront, twoview as jtv
from spherical_bundle_adjuster_tpu.utils import synthetic as jsyn
from spherical_bundle_adjuster_tpu.utils.config import MatchConfig, PipelineConfig, SurfConfig
from spherical_bundle_adjuster_tpu_torch.models import frontend as tfront, twoview as ttv
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig, synthetic as tsyn
from test_torch_integral import exact_reference_integral

torch.set_num_threads(1)

H, W = 128, 256
# the JAX batch tests' config, the backend-dependent modes pinned
CFG = PipelineConfig(
    surf=SurfConfig(max_keypoints=64, n_octaves=2, det_mode="xla", gather_mode="mxu",
                    topk_mode="exact"),
    match=MatchConfig(max_matches=128, ratio_thresh=0.5),
)
TCFG = tconfig.from_reference(CFG)
M = CFG.match.max_matches


def _pairs(key, eulers_deg):
    """The JAX tests' pairs: render_erp of each key, right view rotated."""
    keys = jax.random.split(key, len(eulers_deg))
    Rs = jax.vmap(jrot.euler_to_matrix)(jnp.asarray(np.deg2rad(eulers_deg), jnp.float32))
    lefts = jax.vmap(lambda k: jsyn.render_erp(k, jnp.eye(3), H, W))(keys)
    rights = jax.vmap(lambda k, R: jsyn.render_erp(k, R.T, H, W))(keys, Rs)
    return np.asarray(lefts), np.asarray(rights), np.asarray(Rs, np.float64)


# The three scenes of tests/test_twoview_e2e.py: 4 pairs (chunk 2 against
# chunk 0), a ragged batch of 3, and two easy pairs with one pitch-30 pair
# on the parity ladder's cliff (the auto ladder's dense re-run).
SCENES = {
    "chunked": (0, np.random.default_rng(0).uniform(-5, 5, (4, 3))),
    "ragged": (0, np.random.default_rng(1).uniform(-5, 5, (3, 3))),
    "auto": (3, np.asarray([[2.0, -3.0, 1.0], [1.0, 4.0, -2.0], [0.0, 30.0, 0.0]])),
}


def _draws(cfg, key):
    keys = jax.random.split(key, cfg.ransac.num_trials)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (M,)))(keys))


def _matched(fr, i):
    """(n, 4) matched pixel pairs of pair i of a (batched) front-end result."""
    v = np.asarray(fr.match_valid[i])
    xy = np.concatenate([np.asarray(fr.left_xy[i]), np.asarray(fr.right_xy[i])], -1)
    return xy[: int(v.sum())]


def _perm(pj, pt):
    """Slot permutation taking each of the port's matches to the same match
    (both pixels within 0.05 px) of the reference's list; unpaired slots
    take the reference's unused slots in order. Returns (perm, shared)."""
    perm, used = np.full(M, -1), set()
    for i, p in enumerate(pt):
        d = np.abs(pj - p).max(-1)
        j = int(np.argmin(d))
        if d[j] < 0.05 and j not in used:
            perm[i] = j
            used.add(j)
    free = iter([j for j in range(M) if j not in used])
    return np.asarray([p if p >= 0 else next(free) for p in perm]), len(used)


@pytest.fixture(scope="module")
def scenes():
    """Per scene: images, R_gt, the reference's batch result, the port's
    front-end match list and its draws (the reference's, assigned to the
    port's matches); and the reference's parity-ladder match count of the
    cliff pair."""
    out = {}
    with exact_reference_integral():
        for name, (k, eul) in SCENES.items():
            lefts, rights, Rs = _pairs(jax.random.PRNGKey(k), eul)
            rkeys = jax.random.split(jax.random.PRNGKey(7), len(eul))
            out_j = jtv.run_two_view_batch(jnp.asarray(lefts), jnp.asarray(rights), rkeys, CFG,
                                           batch_chunk=2)
            out[name] = dict(lefts=lefts, rights=rights, Rs=Rs, out_j=out_j,
                             draws=[_draws(CFG, rk) for rk in rkeys])
        parity = dataclasses.replace(CFG, frontend=dataclasses.replace(CFG.frontend,
                                                                       band_ladder="parity"))
        cliff = out["auto"]
        out["cliff_parity_j"] = int(jfront.band_frontend(
            jnp.asarray(cliff["lefts"][2]), jnp.asarray(cliff["rights"][2]), parity).match_count)
    for name in SCENES:
        sc = out[name]
        sc["lt"], sc["rt"] = (torch.from_numpy(sc[k].copy()) for k in ("lefts", "rights"))
        fr_t = tfront.frontend_pairs("band", sc["lt"], sc["rt"], TCFG)
        perms = [_perm(_matched(sc["out_j"], i), _matched(fr_t, i)) for i in range(len(sc["Rs"]))]
        sc["shared"] = [s for _, s in perms]
        sc["gumbel"] = torch.from_numpy(np.stack([d[:, p] for d, (p, _) in
                                                  zip(sc["draws"], perms)]))
        sc["out_t"] = ttv.run_two_view_batch(sc["lt"], sc["rt"], None, TCFG, batch_chunk=2,
                                             gumbel=sc["gumbel"])
    return out


def _assert_results_equal(a, b, atol=1e-5):
    """Every field of two (batched) TwoViewResults within atol (the JAX
    batch tests' own bound), match lists identical."""
    for f in ("match_valid", "left_xy", "right_xy", "num_matches"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    fa = [x for x in a[:-1]] + [x for rep in a.telemetry[:3] for x in rep] + list(a.telemetry[3:])
    fb = [x for x in b[:-1]] + [x for rep in b.telemetry[:3] for x in rep] + list(b.telemetry[3:])
    for i, (x, y) in enumerate(zip(fa, fb)):
        assert x.shape == y.shape, i
        np.testing.assert_allclose(x.double().numpy(), y.double().numpy(), atol=atol, err_msg=str(i))


@pytest.mark.parametrize("name", list(SCENES))
def test_batch_whole_pair_parity(scenes, name):
    """Each pair of the port's batch against the reference's batch row.

    Front end: match count +-2 and >= 90% of the reference's matches
    shared (test_torch_twoview's bounds). Solve: the port's batched
    adjust_from_matches from the reference's own matches and draws, all
    pairs of the scene at once, within 0.5 deg of the reference's rotation
    (PARITY.md's same-init bound; measured <= 0.01 deg). End to end, both
    packages within the bench's 512x1024 compat max gate (11.5 deg) of the
    ground truth.

    test_torch_twoview's end-to-end bounds (0.5 deg apart, 2.5 deg from
    the ground truth) do not hold on these 64-keypoint scenes, and the
    reference misses them itself: it errs 3.87 and 4.44 deg on the auto
    scene's pairs 1 and 2, and on the chunked scene's pair 0 the port
    finds 28 of the reference's 30 matches; the draws of the 2 others
    cannot be shared, and with 28 matches compat's consensus lands 3.70
    deg away (2.60 deg from the ground truth, the reference 1.22 deg)."""
    sc = scenes[name]
    out_j, out_t = sc["out_j"], sc["out_t"]
    p = len(sc["Rs"])
    for i in range(p):
        nj, nt = int(out_j.num_matches[i]), int(out_t.num_matches[i])
        assert nj >= 12 and abs(nj - nt) <= 2, (i, nj, nt)
        assert sc["shared"][i] >= 0.9 * nj, (i, sc["shared"][i], nj)
        assert bool(out_t.ok[i]) and bool(out_j.ok[i])
    fr_j = jtv.FrontendResult(out_j.left_xy, out_j.right_xy, out_j.match_valid,
                              out_j.match_distance, out_j.total_keypoints)
    banks = jax.vmap(lambda fr: jtv.lift_matches(fr, W, H))(fr_j)
    b_l, b_r = (torch.from_numpy(np.array(b)) for b in banks)
    r_same = ttv.adjust_from_matches(b_l, b_r, torch.from_numpy(np.array(out_j.match_valid)),
                                     None, TCFG, gumbel=torch.from_numpy(np.stack(sc["draws"])))[0]
    assert r_same.shape == (p, 3)
    for i, R in enumerate(sc["Rs"]):
        R_j = np.asarray(jrot.angle_axis_to_matrix(out_j.rotation_aa[i]), np.float64)
        same = bench.rot_err_deg_host(r_same[i].numpy()[None], R_j[None])[0]
        err_j = bench.rot_err_deg_host(np.asarray(out_j.rotation_aa[i])[None], R[None])[0]
        err_t = bench.rot_err_deg_host(out_t.rotation_aa[i].numpy()[None], R[None])[0]
        gate = bench.GATE_MAX_ROT_ERR_COMPAT
        assert same < 0.5 and err_j < gate and err_t < gate, (i, same, err_j, err_t)


@pytest.mark.parametrize("name", ["chunked", "ragged"])
def test_batch_chunking_matches_unchunked(scenes, name):
    """batch_chunk 2 (a ragged last chunk for 3 pairs) against the whole
    batch in one pass: identical match lists, every field within 1e-5."""
    sc = scenes[name]
    whole = ttv.run_two_view_batch(sc["lt"], sc["rt"], None, TCFG, batch_chunk=0,
                                   gumbel=sc["gumbel"])
    assert whole.rotation_aa.shape == (len(sc["Rs"]), 3)
    _assert_results_equal(sc["out_t"], whole)


@pytest.mark.parametrize("name", list(SCENES))
def test_batch_rows_equal_single_pair_runs(scenes, name):
    """Each batch row against the port's run_two_view on that pair with
    that pair's draws: identical match lists, r, t and d within 1e-5."""
    sc = scenes[name]
    out_t = sc["out_t"]
    for i in range(len(sc["Rs"])):
        one = ttv.run_two_view(sc["lt"][i], sc["rt"][i], None, TCFG, gumbel=sc["gumbel"][i])
        row = ttv.TwoViewResult(*(x[i] for x in out_t[:-1]),
                                telemetry=ttv.SolverTelemetry(
                                    *(ttv.lm.StageReport(*(f[i] for f in rep))
                                      for rep in out_t.telemetry[:3]),
                                    *(f[i] for f in out_t.telemetry[3:])))
        _assert_results_equal(row, one)


def test_batched_auto_ladder_two_pass(scenes):
    """The cliff pair (pitch 30) is short on the parity ladder in both
    packages and takes the dense re-run; the easy pairs keep their parity
    results, bit for bit, and only the short pair is re-run."""
    sc = scenes["auto"]
    parity = dataclasses.replace(TCFG, frontend=dataclasses.replace(TCFG.frontend,
                                                                    band_ladder="parity"))
    fr_par = tfront.frontend_pairs("band", sc["lt"], sc["rt"], parity)
    n_par = fr_par.match_count.tolist()
    short = [i for i, n in enumerate(n_par) if n < TCFG.frontend.auto_min_matches]
    assert short == [2], n_par
    assert scenes["cliff_parity_j"] < CFG.frontend.auto_min_matches
    out_t, out_j = sc["out_t"], sc["out_j"]
    assert int(out_t.num_matches[2]) > n_par[2] and int(out_j.num_matches[2]) > scenes["cliff_parity_j"]
    for i in (0, 1):
        assert torch.equal(out_t.left_xy[i], fr_par.left_xy[i])
        assert torch.equal(out_t.match_valid[i], fr_par.match_valid[i])
    dense = dataclasses.replace(TCFG, frontend=dataclasses.replace(TCFG.frontend,
                                                                   band_ladder="dense"))
    fr_dense = tfront.band_frontend(sc["lt"][2], sc["rt"][2], dense)
    assert torch.equal(out_t.left_xy[2], fr_dense.left_xy)
    assert torch.equal(out_t.right_xy[2], fr_dense.right_xy)


def test_batch_draws_come_from_the_generator_in_pair_order(scenes):
    """Without injected draws, the batch draws every pair's rows up front
    from the generator, so they do not depend on the chunking."""
    sc = scenes["ragged"]
    a = ttv.run_two_view_batch(sc["lt"], sc["rt"], torch.Generator().manual_seed(3), TCFG,
                               batch_chunk=2)
    b = ttv.run_two_view_batch(sc["lt"], sc["rt"], torch.Generator().manual_seed(3), TCFG,
                               batch_chunk=0)
    _assert_results_equal(a, b)
    g = torch.Generator().manual_seed(3)
    draws = ttv.epipolar.gumbel_draws(TCFG.ransac.num_trials, M, g, "cpu", (3,))
    c = ttv.run_two_view_batch(sc["lt"], sc["rt"], None, TCFG, gumbel=draws)
    _assert_results_equal(a, c)


def test_corrected_batch_equals_single_runs(scenes):
    """The ragged scene's 3 pairs in the bench's corrected mode as one
    batch against single-pair runs with the same draws: identical match
    lists and winning starts, rotations and translations within 1e-4.
    (On the CPU, a transcendental op's result can depend on the element's
    position in its vector loop, so a batch row and a single run differ by
    float32 rounding: on this fixture up to 2.2e-6 in r and 3.9e-6 in t.
    Corrected mode's depths on these pure-rotation pairs are set by the
    barrier alone and are not compared.)"""
    sc = scenes["ragged"]
    cfg = tconfig.from_reference(bench.corrected_mode(CFG))
    g = torch.Generator().manual_seed(5)
    draws = ttv.epipolar.gumbel_draws(cfg.ransac.num_trials, M, g, "cpu", (3,))
    out = ttv.run_two_view_batch(sc["lt"], sc["rt"], None, cfg, gumbel=draws)
    for i in range(3):
        one = ttv.run_two_view(sc["lt"][i], sc["rt"][i], None, cfg, gumbel=draws[i])
        assert torch.equal(out.match_valid[i], one.match_valid)
        assert torch.equal(out.left_xy[i], one.left_xy)
        assert int(out.telemetry.start[i]) == int(one.telemetry.start)
        assert bool(out.ok[i]) and bool(one.ok)
        np.testing.assert_allclose(out.rotation_aa[i].numpy(), one.rotation_aa.numpy(), atol=1e-4)
        np.testing.assert_allclose(out.translation[i].numpy(), one.translation.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def parallax():
    key = jax.random.PRNGKey(11)
    euler = np.deg2rad([1.5, -2.0, 3.0])
    t = np.asarray([0.3, -0.1, 0.05], np.float32)
    lj, rj, Rj, tj = jsyn.translation_pair(key, euler, t, H, W)
    params = tuple(np.asarray(p, np.float32) for p in jsyn._texture_params(key))
    dists = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), (params[3].shape[0],),
                                          minval=2.0, maxval=6.0), np.float32)
    lt, rt, Rt, tt = tsyn.translation_pair(params, dists, euler, t, H, W, "cpu")
    return (np.asarray(lj), np.asarray(rj), np.asarray(Rj), np.asarray(tj)), (lt, rt, Rt, tt)


def test_translation_pair_parity(parallax):
    """translation_pair (render_erp_at at the identity and at the right
    pose) against the reference's from the same texture parameters and
    disc distances: R and t within 1e-6, and under 0.1% of the pixel
    channels different (disc boundaries sit within ~1e-3 of the test's
    threshold, so float32 reassociation flips a few)."""
    (lj, rj, Rj, tj), (lt, rt, Rt, tt) = parallax
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-6)
    for a, b in ((lj, lt.numpy()), (rj, rt.numpy())):
        assert b.shape == a.shape == (H, W, 3) and b.dtype == np.uint8
        assert (a != b).mean() < 1e-3, (a != b).mean()
    assert (lj != rj).mean() > 0.1  # the right view moved


def test_render_erp_at_identity_matches_render_erp(parallax):
    """At the identity pose the discs sit where render_erp puts them, up to
    the cos(r) vs cos(asin(r)) angular-radius difference: the images
    differ in few pixels."""
    _, (lt, _, _, _) = parallax
    key = jax.random.PRNGKey(11)
    params = tuple(np.asarray(p, np.float32) for p in jsyn._texture_params(key))
    flat = tsyn.render_erp(params, np.eye(3, dtype=np.float32), H, W, "cpu")
    assert (flat.numpy() != lt.numpy()).mean() < 0.05
