"""Port parity: models/sequence (run_sequence: odometry batch, closures,
information weights, pose graph, the "auto" rule, merged tracks and the
global BA) against the JAX package on the CPU.

Both packages see the same frames (numpy) and the same RANSAC draws: the
reference's, split from its key as its run_sequence splits them, injected
into the port (odometry pair k: jax.random.split(key, N-1)[k]; every
closure: key itself). The reference runs on the port's band front end (a
host callback), so both solve from the same match lists: the front ends'
own divergence (a match or two near the ratio threshold, near-equal
matches in swapped slots) is pinned by tests/test_torch_batch.py and
tests/test_torch_bench_pair.py, and here by
test_sequence_front_end_matches_the_reference.

Tolerances (each test states its own, beside what it measured): the
corrected two-view solve from identical matches and draws agrees to
float32 steps along flat valleys (rotations within 7e-5 rad); the pose
graph carries that along the chain; the global BA's landmark step is
ill-conditioned (the reference's own jitted and eager steps differ by
3e-4, tests/test_torch_multiview.py) and amplifies its input gaps.
"""

import contextlib
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from spherical_bundle_adjuster_tpu.core import rotation as jrot
from spherical_bundle_adjuster_tpu.models import frontend as jfront
from spherical_bundle_adjuster_tpu.models import multiview as jmv
from spherical_bundle_adjuster_tpu.models import sequence as jseq
from spherical_bundle_adjuster_tpu.models import twoview as jtv
from spherical_bundle_adjuster_tpu.parallel import mesh as jmesh
from spherical_bundle_adjuster_tpu.solver import pose_graph as jpg
from spherical_bundle_adjuster_tpu.utils.config import (
    BaConfig, MatchConfig, PipelineConfig, SurfConfig,
)
from spherical_bundle_adjuster_tpu_torch import problems
from spherical_bundle_adjuster_tpu_torch.models import frontend as tfront
from spherical_bundle_adjuster_tpu_torch.models import sequence as tseq
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.parallel import launch
from spherical_bundle_adjuster_tpu_torch.solver import epipolar as tepi
from spherical_bundle_adjuster_tpu_torch.solver import pose_graph as tpg
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from spherical_bundle_adjuster_tpu_torch.utils import synthetic as tsyn
from test_sequence import render_sequence
from test_torch_integral import exact_reference_integral

torch.set_num_threads(1)

# tests/test_sequence.py::test_sequence_recovers_rotations: 4 frames of
# one scene through cumulative rotations, 96x192, corrected BA; the
# reference's backend-dependent modes pinned (config.from_reference)
ROT_EULERS_DEG = [[0, 0, 0], [1.5, -2.0, 3.0], [3.0, -3.5, 6.0], [4.0, -5.0, 9.0]]
ROT_KEY = 11
ROT_CFG = PipelineConfig(
    surf=SurfConfig(max_keypoints=128, n_octaves=2, det_mode="xla", gather_mode="mxu",
                    topk_mode="exact"),
    match=MatchConfig(max_matches=256, ratio_thresh=0.6),
    ba=BaConfig(reference_compat=False),
)
# a translating sequence: 5 frames along problems.trajectory_poses (3
# deg yaw and 0.25 units a frame) at 128x256, one closure, the global BA;
# the bench's corrected mode (80 trials)
TR_FRAMES, TR_H, TR_W = 5, 128, 256
TR_KEY = 5
TR_CLOSURES = [(0, 2)]
TR_CFG = dataclasses.replace(
    ROT_CFG, ba=BaConfig(reference_compat=False, joint_refine=True, outlier_reject=True,
                         multi_start=4))


def _draws(cfg, key):
    """The reference's RANSAC draws for one run_two_view call with `key`."""
    m = cfg.match.max_matches
    keys = jax.random.split(key, cfg.ransac.num_trials)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys))


def _odometry_draws(cfg, key, n_pairs):
    """(n_pairs, trials, M): the draws of the reference's pairwise_odometry."""
    return torch.from_numpy(np.stack([_draws(cfg, k) for k in jax.random.split(key, n_pairs)]))


@contextlib.contextmanager
def reference_on_port_matches():
    """Within the block, the reference's band front end is the port's (a
    host callback, one pair at a time under vmap), so both packages solve
    from the same match lists. The jit caches are cleared on entry and on
    exit, so no trace outlives the block or predates it."""

    def band(im_left, im_right, cfg):
        tcfg, m = tconfig.from_reference(cfg), cfg.match.max_matches

        def host(left, right):
            fr = tfront.band_frontend(torch.from_numpy(np.array(left)),
                                      torch.from_numpy(np.array(right)), tcfg)
            return (fr.left_xy.numpy(), fr.right_xy.numpy(), fr.match_valid.numpy(),
                    fr.match_distance.numpy(), np.int32(fr.total_keypoints))

        shapes = (jax.ShapeDtypeStruct((m, 2), jnp.float32),
                  jax.ShapeDtypeStruct((m, 2), jnp.float32),
                  jax.ShapeDtypeStruct((m,), jnp.bool_),
                  jax.ShapeDtypeStruct((m,), jnp.float32),
                  jax.ShapeDtypeStruct((), jnp.int32))
        return jfront.FrontendResult(*jax.pure_callback(host, shapes, im_left, im_right,
                                                        vmap_method="sequential"))

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtv.FRONTENDS, "band", band)
        yield
    jax.clear_caches()


def _run_both(frames, cfg, key, **kw):
    """The reference's run_sequence (on the port's matches) and the port's
    with the reference's draws, on the same frames."""
    n = frames.shape[0]
    with reference_on_port_matches():
        out_j = jseq.run_sequence(jnp.asarray(frames), jax.random.PRNGKey(key), cfg, **kw)
        out_j = jseq.SequenceResult(*(np.asarray(f) for f in out_j))
    jkey = jax.random.PRNGKey(key)
    closure = torch.from_numpy(_draws(cfg, jkey)) if kw.get("closures") else None
    out_t = tseq.run_sequence(torch.from_numpy(frames), None, tconfig.from_reference(cfg),
                              gumbel=_odometry_draws(cfg, jkey, n - 1), closure_gumbel=closure,
                              **kw)
    return out_j, out_t


@pytest.fixture(scope="module")
def rotation_case():
    """tests/test_sequence's 4 frames through both packages, global_ba=False."""
    frames = np.array(render_sequence(np.deg2rad(ROT_EULERS_DEG), jax.random.PRNGKey(ROT_KEY)))
    out_j, out_t = _run_both(frames, ROT_CFG, ROT_KEY, global_ba=False)
    return frames, out_j, out_t


def _trajectory_frames():
    rng = np.random.default_rng(problems.ODO_SEED)
    params = tsyn.texture_params_from_numpy(rng)
    dists = tsyn.disc_distances_from_numpy(rng)
    gt = problems.trajectory_poses(TR_FRAMES)
    return tsyn.render_trajectory(params, dists, gt, TR_H, TR_W, "cpu").numpy(), gt


@pytest.fixture(scope="module")
def translating_case():
    """The 5-frame translating sequence through both packages, one
    closure, global_ba=True."""
    frames, gt = _trajectory_frames()
    out_j, out_t = _run_both(frames, TR_CFG, TR_KEY, closures=TR_CLOSURES, global_ba=True)
    return frames, gt, out_j, out_t


def _rot_gap(aa_a, aa_b):
    """Largest angle (rad) between two stacks of angle-axis rotations, in
    float64 (arctan2 of the relative rotation's sine and cosine, exact
    near 0 where arccos of the trace is not)."""
    gaps = []
    for a, b in zip(np.asarray(aa_a, np.float64), np.asarray(aa_b, np.float64)):
        d = problems.angle_axis_matrix(a).T @ problems.angle_axis_matrix(b)
        sin = 0.5 * np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
        gaps.append(np.arctan2(sin, 0.5 * (np.trace(d) - 1)))
    return float(max(gaps))


def test_sequence_front_end_matches_the_reference(rotation_case):
    """The reference's own band front end on the rotation case's pairs
    (on the port's exactly rounded integral image) against the port's:
    match counts within 2 and >= 90% of the reference's matches shared
    (both pixels within 0.05 px), test_torch_batch's bounds."""
    frames, _, _ = rotation_case
    tcfg = tconfig.from_reference(ROT_CFG)
    with exact_reference_integral():
        fr_j = jax.vmap(lambda l, r: jfront.band_frontend(l, r, ROT_CFG))(
            jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]))
    ft = torch.from_numpy(frames)
    fr_t = tfront.frontend_pairs("band", ft[:-1], ft[1:], tcfg)
    for k in range(frames.shape[0] - 1):
        vj, vt = np.asarray(fr_j.match_valid[k]), fr_t.match_valid[k].numpy()
        pj = np.concatenate([np.asarray(fr_j.left_xy[k]), np.asarray(fr_j.right_xy[k])], -1)[vj]
        pt = torch.cat([fr_t.left_xy[k], fr_t.right_xy[k]], -1).numpy()[vt]
        shared = int((np.abs(pj[:, None] - pt[None]).max(-1).min(-1) < 0.05).sum())
        assert abs(len(pj) - len(pt)) <= 2 and shared >= 0.9 * len(pj), (k, len(pj), len(pt), shared)


def test_rotation_sequence_parity(rotation_case):
    """(a) From the same matches and draws: pairwise rotations within
    2e-4 rad and translations within 2e-3 (corrected mode on a pure
    rotation: the translation is the depth barrier's gauge direction, set
    by float32 steps along a flat valley); the pose graph's and the final
    poses' rotations within 3e-4 rad and translations within 2e-3; both
    cost traces under 1e-12 (the odometry chain without closures fits
    every edge: the costs are rounding noise). Measured: 6.7e-5 rad,
    4.9e-4; 9.5e-5 rad, 4.9e-4; costs 4.0e-17."""
    _, out_j, out_t = rotation_case
    assert _rot_gap(out_j.pairwise_rot, out_t.pairwise_rot.numpy()) < 2e-4
    np.testing.assert_allclose(out_t.pairwise_tran.numpy(), out_j.pairwise_tran, atol=2e-3)
    for name in ("pg_poses", "poses"):
        got, want = getattr(out_t, name).numpy(), getattr(out_j, name)
        assert _rot_gap(got[:, :3], want[:, :3]) < 3e-4, name
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=2e-3, err_msg=name)
    assert out_t.pg_costs.shape == out_j.pg_costs.shape == (20,)
    assert np.all(np.abs(out_t.pg_costs.numpy()) < 1e-12) and np.all(np.abs(out_j.pg_costs) < 1e-12)
    assert out_t.ba_costs.shape == (0,) and out_j.ba_costs.shape == (0,)


def test_rotation_sequence_meets_the_reference_test_bounds(rotation_case):
    """(a) The port's output on tests/test_sequence's own bounds: each
    pairwise rotation within 2 deg of the ground truth, the last pose
    within 4 deg, a pose-graph cost that does not rise."""
    _, _, out_t = rotation_case
    R = [np.asarray(jrot.euler_to_matrix(jnp.asarray(e, jnp.float32)), np.float64)
         for e in np.deg2rad(ROT_EULERS_DEG)]
    for k in range(3):
        err = problems.rot_err_deg_host(out_t.pairwise_rot[k].numpy(), R[k + 1] @ R[k].T)
        assert err < 2.0, (k, err)
    assert problems.rot_err_deg_host(out_t.poses[-1, :3].numpy(), R[-1]) < 4.0
    assert float(out_t.pg_costs[-1]) <= float(out_t.pg_costs[0]) + 1e-6


def _finite_gap(got, want):
    """Largest |got - want| over the entries finite in both, and the
    number of such entries."""
    both = np.isfinite(got) & np.isfinite(want)
    return float(np.abs(got - want)[both].max()), int(both.sum())


def test_translating_sequence_with_global_ba_parity(translating_case):
    """(b) One closure and the global BA, end to end from the same
    matches and draws. The pose graph's poses within 1e-4 rad and 5e-4
    units (measured 2.4e-5, 1.0e-4). The BA starts from landmarks
    triangulated over 0.25-unit baselines, so those input gaps move its
    first cost by 0.27%: its poses within 1.5e-3 rad and 3e-3 units
    (measured 6.0e-4, 1.4e-3), its cost trace within 1% of the first
    cost where both are finite (measured 0.27%). A GN step whose dense
    camera solve fails (not positive definite) is NaN, is rejected, and
    leaves NaN in the trace (min(cost0, NaN)) in both packages; which
    steps fail depends on rounding, so the traces' NaN entries may
    differ, but the last cost is finite and below the first."""
    _, _, out_j, out_t = translating_case
    got, want = out_t.pg_poses.numpy(), out_j.pg_poses
    assert _rot_gap(got[:, :3], want[:, :3]) < 1e-4
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=5e-4)
    assert out_t.ba_costs.shape == out_j.ba_costs.shape == (15,)
    gap, n = _finite_gap(out_t.ba_costs.numpy(), out_j.ba_costs)
    assert n >= 10 and gap < 1e-2 * float(out_j.ba_costs[0]), (gap, n)
    for costs in (out_t.ba_costs.numpy(), out_j.ba_costs):
        assert np.isfinite(costs[-1]) and costs[-1] < costs[0], costs
    assert _rot_gap(out_t.poses[:, :3].numpy(), out_j.poses[:, :3]) < 1.5e-3
    np.testing.assert_allclose(out_t.poses[:, 3:].numpy(), out_j.poses[:, 3:], atol=3e-3)


def test_global_ba_stage_matches_the_reference_on_the_same_inputs(translating_case):
    """(b) The BA stage alone: the reference's build_multiview_problem and
    solve_multiview on the port's own pose-graph poses and odometry
    tables, against the port's run_sequence output. Cost trace within
    1e-3 of the first cost where both are finite, poses within 1e-3 rad
    and 2e-3 units: the landmark step's conditioning (the reference's own
    jitted and eager steps differ by 3e-4) and one step that fails in one
    package and not in the other (measured 3.1e-4, 2.9e-4 rad, 5.8e-4)."""
    frames, _, _, out_t = translating_case
    cfg = tconfig.from_reference(TR_CFG)
    draws = _odometry_draws(TR_CFG, jax.random.PRNGKey(TR_KEY), TR_FRAMES - 1)
    res = tseq.pairwise_odometry(torch.from_numpy(frames), None, cfg, gumbel=draws)[3]
    tables = jtv.TwoViewResult(*(jnp.asarray(np.asarray(f)) for f in res[:-1]), telemetry=None)
    prob = jseq.build_multiview_problem(jnp.asarray(out_t.pg_poses.numpy()), tables, TR_W, TR_H)
    solved, costs = jmv.solve_multiview(prob, num_iters=15)
    costs = np.asarray(costs)
    gap, n = _finite_gap(out_t.ba_costs.numpy(), costs)
    assert n >= 10 and gap < 1e-3 * float(costs[0]), (gap, n)
    poses = np.asarray(solved.poses)
    assert _rot_gap(out_t.poses[:, :3].numpy(), poses[:, :3]) < 1e-3
    np.testing.assert_allclose(out_t.poses[:, 3:].numpy(), poses[:, 3:], atol=2e-3)


def test_auto_rule_takes_the_mean_of_the_two_middle_norms(monkeypatch):
    """(c) On an even number of pairs whose lower middle |t| is below
    MIN_BA_BASELINE and whose two middle values average at or above it,
    "auto" runs the BA, as np.median decides (torch.median would take the
    lower one and skip it); with the average below, it skips the BA."""
    frames, _ = _trajectory_frames()
    cfg = tconfig.from_reference(ROT_CFG)
    real = tseq.pairwise_odometry
    for norms, runs in (([0.05, 0.09, 0.12, 0.2], True), ([0.05, 0.09, 0.095, 0.2], False)):
        assert np.median(norms) >= 0.1 if runs else np.median(norms) < 0.1
        assert float(torch.median(torch.tensor(norms))) < 0.1

        def odometry(*args, norms=norms, **kw):
            rot, tran, ok, res = real(*args, **kw)
            tran = tran * (torch.tensor(norms)[:, None] / tran.norm(dim=-1, keepdim=True))
            return rot, tran, ok, res._replace(translation=tran)

        monkeypatch.setattr(tseq, "pairwise_odometry", odometry)
        tran = torch.tensor(norms)[:, None] * torch.tensor([[0.6, 0.0, 0.8]])
        assert tseq.median_baseline(tran) == pytest.approx(float(np.median(norms)))
        out = tseq.run_sequence(torch.from_numpy(frames), torch.Generator().manual_seed(0), cfg,
                                ba_iters=3)
        assert out.ba_costs.shape == ((3,) if runs else (0,)), norms
        if not runs:
            assert torch.equal(out.poses, out.pg_poses)


def test_information_weights_match_the_reference_formula():
    """(d) sqrt(matches), 0.1x where ok is false, over the mean odometry
    weight, against the reference's numpy formula (sequence.py): the
    odometry weights within one float32 rounding, the closure weights
    within 1e-15 relative (float64); and the chained graph's edge weights
    equal to the reference chain_with_loop_closures' from those weights."""
    nm = np.asarray([30, 0, 12, 45, 7], np.int32)
    ok = np.asarray([True, True, False, True, False])
    closure_nm = np.asarray([20, 0, 64], np.int32)
    w = np.sqrt(np.maximum(nm.astype(np.float64), 1.0)) * np.where(ok, 1.0, 0.1)
    norm = max(float(w.mean()), 1e-6)
    odo_ref = (w / norm).astype(np.float32)
    cw_ref = [float(np.sqrt(max(float(c), 1.0)) / norm) for c in closure_nm]
    odo, cw = tseq.information_weights(torch.from_numpy(nm), torch.from_numpy(ok),
                                       torch.from_numpy(closure_nm))
    assert odo.dtype == torch.float32 and cw.dtype == torch.float64
    np.testing.assert_allclose(odo.numpy(), odo_ref, rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(cw.numpy(), cw_ref, rtol=1e-15, atol=0)
    rng = np.random.default_rng(0)
    rot = rng.normal(scale=0.05, size=(5, 3)).astype(np.float32)
    tran = rng.normal(size=(5, 3)).astype(np.float32)
    closures = [(0, 2, rot[0], tran[0]), (1, 4, rot[1], tran[1]), (0, 5, rot[2], tran[2])]
    g_j = jpg.chain_with_loop_closures(jnp.asarray(rot), jnp.asarray(tran), closures,
                                       closure_weight=8.0, odometry_weights=odo_ref,
                                       closure_weights=cw_ref)
    g_t = tpg.chain_with_loop_closures(torch.from_numpy(rot), torch.from_numpy(tran), closures,
                                       closure_weight=8.0, odometry_weights=odo,
                                       closure_weights=cw)
    np.testing.assert_array_equal(g_t.edge_weight.numpy(), np.asarray(g_j.edge_weight))


def test_closures_share_one_draw_set(monkeypatch):
    """(e) The closures run as one batch after the odometry batch, and
    every closure gets the same draws: without injected draws, the
    generator's next (trials, M) set after the odometry pairs'; with
    closure_gumbel, that set."""
    frames, _ = _trajectory_frames()
    cfg = tconfig.from_reference(ROT_CFG)
    trials, m = cfg.ransac.num_trials, cfg.match.max_matches
    calls = []
    real = ttv.run_two_view_batch

    def recording(lefts, rights, generator, cfg, frontend="band", **kw):
        calls.append(kw["gumbel"])
        return real(lefts, rights, generator, cfg, frontend, **kw)

    monkeypatch.setattr(ttv, "run_two_view_batch", recording)
    closures = [(0, 2), (1, 3), (0, 4)]
    tseq.run_sequence(torch.from_numpy(frames), torch.Generator().manual_seed(4), cfg,
                      closures=closures, global_ba=False, pg_iters=2)
    g = torch.Generator().manual_seed(4)
    odo = tepi.gumbel_draws(trials, m, g, "cpu", (TR_FRAMES - 1,))
    one = tepi.gumbel_draws(trials, m, g, "cpu")
    assert len(calls) == 2
    assert torch.equal(calls[0], odo)
    assert calls[1].shape == (len(closures), trials, m)
    assert all(torch.equal(row, one) for row in calls[1])
    calls.clear()
    mine = torch.rand(trials, m)
    tseq.run_sequence(torch.from_numpy(frames), None, cfg, closures=closures, global_ba=False,
                      pg_iters=2, gumbel=odo, closure_gumbel=mine)
    assert torch.equal(calls[0], odo) and all(torch.equal(row, mine) for row in calls[1])


def test_sequence_over_a_two_rank_mesh(translating_case):
    """(f) run_sequence(mesh=...) on translating_case's frames and draws
    over 2 gloo ranks spawned on the CPU (tests/torch_ranks.sequence_case):
    every stage before the BA runs on both ranks, the BA is
    landmark-sharded (each of its 15 GN steps all-reduces the (C, 84)
    camera sums), and both ranks return the same bits. Against the port's
    mesh=None run: the pose graph's poses equal, the BA cost trace within
    1e-3 of its first cost where both are finite, the poses within 1e-3
    rad and 2e-3 units. Measured: equal bit for bit, because the tracks
    table keeps its 68 valid tracks among its first 512 of 1024 rows, so
    rank 1 adds exact zeros (tests/test_torch_dist_ba.py holds sharded
    solves whose ranks all hold landmarks). Against the JAX package's
    run_sequence(mesh=make_mesh(2)) on the same matches and draws,
    test_translating_sequence_with_global_ba_parity's tolerances: the pose
    graph's poses within 1e-4 rad and 5e-4, the BA trace within 1% of the
    first cost where both are finite, poses within 1.5e-3 rad and 3e-3
    (measured 0.27%, 6.0e-4 rad, 1.4e-3)."""
    frames, _, _, out_t = translating_case
    jkey = jax.random.PRNGKey(TR_KEY)
    gumbel = _odometry_draws(TR_CFG, jkey, TR_FRAMES - 1).numpy()
    kw = dict(closures=TR_CLOSURES, global_ba=True)
    outs = launch.run_ranks(torch_ranks.sequence_case, 2,
                            args=(frames, tconfig.from_reference(TR_CFG), gumbel,
                                  _draws(TR_CFG, jkey), kw, 240),
                            threads=1, timeout_s=240, deadline_s=600)
    for a, b in zip(outs[0][0], outs[1][0]):  # bit for bit, NaN costs included
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()
    got, traffic = outs[0]
    assert traffic[("all_reduce", TR_FRAMES * 84 * 4)] == 15
    assert torch.equal(got.pg_poses, out_t.pg_poses)
    assert got.ba_costs.shape == out_t.ba_costs.shape == (15,)
    gap, n = _finite_gap(got.ba_costs.numpy(), out_t.ba_costs.numpy())
    assert n >= 10 and gap < 1e-3 * float(out_t.ba_costs[0]), (gap, n)
    assert _rot_gap(got.poses[:, :3].numpy(), out_t.poses[:, :3].numpy()) < 1e-3
    np.testing.assert_allclose(got.poses[:, 3:].numpy(), out_t.poses[:, 3:].numpy(), atol=2e-3)

    with reference_on_port_matches():
        out_j = jseq.run_sequence(jnp.asarray(frames), jkey, TR_CFG, mesh=jmesh.make_mesh(2), **kw)
        out_j = jseq.SequenceResult(*(np.asarray(f) for f in out_j))
    assert _rot_gap(got.pg_poses[:, :3].numpy(), out_j.pg_poses[:, :3]) < 1e-4
    np.testing.assert_allclose(got.pg_poses[:, 3:].numpy(), out_j.pg_poses[:, 3:], atol=5e-4)
    assert out_j.ba_costs.shape == (15,)
    gap, n = _finite_gap(got.ba_costs.numpy(), out_j.ba_costs)
    assert n >= 10 and gap < 1e-2 * float(out_j.ba_costs[0]), (gap, n)
    for costs in (got.ba_costs.numpy(), out_j.ba_costs):
        assert np.isfinite(costs[-1]) and costs[-1] < costs[0], costs
    assert _rot_gap(got.poses[:, :3].numpy(), out_j.poses[:, :3]) < 1.5e-3
    np.testing.assert_allclose(got.poses[:, 3:].numpy(), out_j.poses[:, 3:], atol=3e-3)


@pytest.mark.parametrize("seed", [0, problems.SEED, 123456789])
def test_reference_draws_reproduce_jax_random(seed):
    """problems.reference_sequence_draws (numpy Threefry, no jax) against
    the reference's own draws for key PRNGKey(seed): split keys and
    uniform bits exactly; the Gumbel values to the last ulps of the two
    packages' float32 logs (measured: 4.8e-7 at most, tolerance 2e-6)."""
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(problems.reference_split(np.asarray(key), 7),
                                  np.asarray(jax.random.split(key, 7)))
    cfg = dataclasses.replace(ROT_CFG, ransac=dataclasses.replace(ROT_CFG.ransac, num_trials=16),
                              match=dataclasses.replace(ROT_CFG.match, max_matches=64))
    odo, closure = problems.reference_sequence_draws(seed, 3, 16, 64)
    assert odo.shape == (3, 16, 64) and closure.shape == (16, 64)
    np.testing.assert_allclose(odo, _odometry_draws(cfg, key, 3).numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(closure, _draws(cfg, key), rtol=0, atol=2e-6)
