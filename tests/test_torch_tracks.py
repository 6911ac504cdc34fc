"""Port parity: models/tracks (cross-pair track merging) against the JAX
package on the CPU, on hand-built chains, seeded random match tables,
tests/test_tracks._make_sequence_problem's recipe (problems.synth_tracks
in numpy) and real match tables from the port's run_two_view_batch.

Tolerances: track_id, slot, has_next, num_tracks, obs_cam, obs_valid and
lm_valid exact; obs_bearing within 2e-6; landmarks, where the root
match's midpoint det > 1e-3, within max(1e-4, 1e-6 / det) of their norm
(problems.problem_gaps). That is looser than 1e-4 for det < 1e-2
because det = 1 - (b1 . R^T b2)^2 cancels: one float32 step of the dot
moves det by ~1.2e-7 and the midpoint by that over det. The reference
triangulates in float32, the port in float64 rounded once; measured on
the (5, 24), (10, 80) and 10-keyframe recipes: gap x det <= 2.9e-7,
2.1e-7 and 8.1e-7, gaps up to 3.8e-4 at det 2.2e-3."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.models import multiview as jmv
from spherical_bundle_adjuster_tpu.models import tracks as jtr
from spherical_bundle_adjuster_tpu.utils import synthetic as jsyn
from spherical_bundle_adjuster_tpu_torch import problems
from spherical_bundle_adjuster_tpu_torch.models import multiview as tmv
from spherical_bundle_adjuster_tpu_torch.models import tracks as ttr
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.solver import pose_graph as tpg
from spherical_bundle_adjuster_tpu_torch.utils import synthetic as tsyn
from spherical_bundle_adjuster_tpu_torch.utils.config import (
    MatchConfig, PipelineConfig, SurfConfig,
)
import test_tracks as jtests

torch.set_num_threads(1)

W, H = 200, 100  # the hand-built and random tables' image size
_j_merge = jax.jit(jtr.merge_tracks)


def _both_merges(left_xy, right_xy, valid):
    got = ttr.merge_tracks(torch.from_numpy(left_xy), torch.from_numpy(right_xy),
                           torch.from_numpy(valid))
    want = _j_merge(jnp.asarray(left_xy), jnp.asarray(right_xy), jnp.asarray(valid))
    return got, want


def _assert_same_tracks(got, want):
    for f in ("track_id", "slot", "has_next", "num_tracks"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _both_builds(inputs, width, height):
    """(port problem, JAX problem as port tensors, midpoint dets) of
    build_multiview_problem on numpy inputs."""
    got = ttr.build_multiview_problem(*(torch.from_numpy(np.asarray(a)) for a in inputs),
                                      width, height, max_obs_per_track=6)
    want = jtr.build_multiview_problem(*(jnp.asarray(a) for a in inputs), width, height,
                                       max_obs_per_track=6)
    want = tmv.problem_from_numpy([np.asarray(f) for f in want], "cpu")
    return got, want, problems.landmark_det(inputs, width, height)


def _assert_same_problem(got, want, det):
    gaps = problems.problem_gaps(got, want, det)
    assert gaps["within"], gaps
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape


def _pair_poses(n_pairs, seed=0):
    """Per-pair relative poses (small rotation, unit-ish baseline) and the
    chained poses, float32 numpy."""
    rng = np.random.default_rng(seed)
    rot = rng.uniform(-0.05, 0.05, (n_pairs, 3)).astype(np.float32)
    tran = (np.array([0.3, 0.0, 0.05]) + rng.uniform(-0.05, 0.05, (n_pairs, 3))).astype(np.float32)
    poses = tpg.chain_with_loop_closures(torch.from_numpy(rot), torch.from_numpy(tran)).poses
    return poses.numpy(), rot, tran


def _hand_chain():
    """test_chain_three_pairs's chain: track A through all 4 frames, B
    through frames 1-3, C only in pair 2; 1e9 in the invalid slots."""
    M, junk = 4, 1e9

    def xy(*pts):
        out = np.full((M, 2), junk, np.float32)
        for i, p in enumerate(pts):
            out[i] = p
        return out

    left = np.stack([xy((10, 20)), xy((11, 20), (50, 61)), xy((12, 20), (50, 62), (80, 80))])
    right = np.stack([xy((11, 20)), xy((12, 20), (50, 62)), xy((13, 20), (50, 63), (81, 80))])
    valid = np.zeros((3, M), bool)
    for k in range(3):
        valid[k, :k + 1] = True
    return left, right, valid


def test_chain_three_pairs():
    """(a) The hand-built chain through both packages: the same tracks
    and, from chained poses, the same problem."""
    left, right, valid = _hand_chain()
    got, want = _both_merges(left, right, valid)
    _assert_same_tracks(got, want)
    assert int(got.num_tracks) == 3
    assert got.slot[:, 0].tolist() == [0, 1, 2]
    poses, rot, tran = _pair_poses(3)
    _assert_same_problem(*_both_builds((poses, left, right, valid, rot, tran), W, H))


def _tie_tables():
    """Hand-built ties over 3 pairs of 5 slots (cell 0.5 px):
      * pair 0's right keypoints 0 and 2 share a cell; pair 1's matches 1
        and 3 (left keypoints in that cell) both continue match 0, the
        lowest m', and pair 2's matches 0 and 2 both continue pair 1's
        match 1 (pair 1's right keypoints 1 and 3 share a cell);
      * so two left observations name (A, 1) and two name (A, 2); pair
        1's match 3 is a tail whose right observation names (A, 2) in the
        later scatter, and pair 2's matches 0 and 2 are tails whose right
        observations both name (A, 3).
    """
    J = 1e9
    left = np.array([
        [(5, 5), (60, 60), (150, 30), (90, 10), (J, J)],
        [(10, 10), (30.0, 40.0), (70, 70), (29.9, 39.95), (J, J)],
        [(31.0, 41.0), (71, 70), (31.05, 41.02), (J, J), (J, J)],
    ], np.float32)
    right = np.array([
        [(30.1, 40.0), (70, 70), (30.2, 40.1), (91, 11), (J, J)],
        [(11, 10), (31, 41), (71, 70), (31.1, 41.05), (J, J)],
        [(32.0, 42.0), (72, 70), (32.1, 42.3), (J, J), (J, J)],
    ], np.float32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    return left, right, valid


def test_ties_lowest_predecessor_and_last_write_wins():
    """(b) Two pair-k right keypoints in one cell: the lowest m' is
    continued. Two observations naming one (track, slot) cell: the last
    in flattened (pair, match) order wins, the right-observation scatter
    after the left one, as the reference's scatters give on the CPU."""
    left, right, valid = _tie_tables()
    got, want = _both_merges(left, right, valid)
    _assert_same_tracks(got, want)
    links = ttr.link_consecutive(*(torch.from_numpy(a) for a in (left, right, valid)))
    assert links.tolist() == [[-1, 0, 1, 0, -1], [1, 2, 1, -1, -1]]
    a = int(got.track_id[0, 0])
    assert got.track_id[1, [1, 3]].tolist() == [a, a] and got.track_id[2, [0, 2]].tolist() == [a, a]
    assert got.has_next[1].tolist() == [False, True, True, False, False]
    poses, rot, tran = _pair_poses(3, seed=1)
    p, q, det = _both_builds((poses, left, right, valid, rot, tran), W, H)
    _assert_same_problem(p, q, det)
    from spherical_bundle_adjuster_tpu_torch.core import sphere

    def bear(xy):
        return sphere.pixel_to_bearing(torch.tensor(xy, dtype=torch.float64), W, H).float()

    # the winners: slot 1 pair 1's match 3 (left), slot 2 pair 1's match 3
    # (right, over pair 2's left observations), slot 3 pair 2's match 2
    assert p.obs_cam[a].tolist() == [0, 1, 2, 3, 0, 0]
    for s, xy in ((1, left[1, 3]), (2, right[1, 3]), (3, right[2, 2])):
        torch.testing.assert_close(p.obs_bearing[a, s], bear(xy), atol=0, rtol=0)


def _random_tables(n_pairs, m, n_kp, seed, junk):
    """Seeded consecutive-pair tables: each frame has n_kp keypoints on a
    jittered grid (a few pairs of them within one cell); each pair's m
    slots match random keypoints of its two frames (the same keypoint
    often twice), ~15% of the slots invalid and filled with `junk`."""
    rng = np.random.default_rng(seed)
    kps = []
    for _ in range(n_pairs + 1):
        kp = np.stack([rng.integers(1, W // 2, n_kp), rng.integers(1, H // 2, n_kp)], -1) * 2.0
        kp = kp + rng.uniform(-0.4, 0.4, kp.shape)
        near = rng.integers(0, n_kp, 3)
        kp[near[1:]] = kp[near[0]] + rng.uniform(-0.1, 0.1, (2, 2))  # shared cells
        kps.append(kp.astype(np.float32))
    left = np.stack([kps[k][rng.integers(0, n_kp, m)] for k in range(n_pairs)])
    right = np.stack([kps[k + 1][rng.integers(0, n_kp, m)] for k in range(n_pairs)])
    valid = rng.uniform(size=(n_pairs, m)) > 0.15
    left[~valid] = junk
    right[~valid] = junk
    return left, right, valid


@pytest.mark.parametrize("junk", [1e9, -1e9, np.inf, np.nan])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_tables_with_junk_in_invalid_slots(seed, junk):
    """(c) Junk in the invalid slots (1e9 overflows int32 after / 0.5, and
    NaN): the port masks those slots before its integer cast, the
    reference after; every output agrees, on tables with ties, duplicate
    cells and chains through all 6 pairs."""
    left, right, valid = _random_tables(6, 48, 40, seed, junk)
    got, want = _both_merges(left, right, valid)
    _assert_same_tracks(got, want)
    assert int(got.slot.max()) >= 3
    poses, rot, tran = _pair_poses(6, seed)
    _assert_same_problem(*_both_builds((poses, left, right, valid, rot, tran), W, H))


@pytest.mark.parametrize("n_cams,n_lm,seed,noise", [(5, 24, 0, (0.0, 0.0)),
                                                    (10, 80, 1, (0.02, 0.08))])
def test_sequence_recipe_builds_the_same_problem(n_cams, n_lm, seed, noise):
    """(d) _make_sequence_problem's recipe at (5 cameras, 24 landmarks) and
    (10, 80): the numpy recipe rebuilds the JAX test's problem, and the
    port's build of its inputs equals the JAX build."""
    inputs, _ = problems.synth_tracks(n_cams, n_lm, seed, noise)
    got, want, det = _both_builds(inputs, problems.TRACKS_W, problems.TRACKS_H)
    _assert_same_problem(got, want, det)
    ref, _, _, _ = jtests._make_sequence_problem(n_cams=n_cams, n_landmarks=n_lm, seed=seed,
                                                 pose_noise=noise)
    for f in ("obs_cam", "obs_valid", "lm_valid"):
        np.testing.assert_array_equal(getattr(want, f).numpy(), np.asarray(getattr(ref, f)))
    # the recipe projects in float64, the JAX test in float32
    np.testing.assert_allclose(want.obs_bearing.numpy(), np.asarray(ref.obs_bearing), atol=2e-6)
    np.testing.assert_allclose(want.poses.numpy(), np.asarray(ref.poses), atol=1e-6)
    counts = got.obs_valid.sum(-1)
    assert int(counts.max()) >= 4 and int((counts >= 3).sum()) >= 5


def test_ba_on_merged_tracks_beats_the_noisy_poses():
    """(e) The port's solve_multiview on the (10, 80) problem meets
    test_ba_beats_pose_graph_only_10_frames's gates, and lands where the
    JAX solve does: rotations within 1e-5, translations within 1e-5 after
    the least-squares scale between the two, both final costs below 1e-10
    (the bearings are exact). Fixing camera 0 leaves bearing-only BA's
    scale free, and the damped steps along that gauge are where rounding
    shows (the reference's own jitted and eager landmark steps differ by
    3e-4, PERF.md): here the two solves end 3.3% apart in scale, and
    their first costs 4% apart."""
    inputs, gt = problems.synth_tracks(10, 80, 1)
    got, want, _ = _both_builds(inputs, problems.TRACKS_W, problems.TRACKS_H)
    solved, costs = tmv.solve_multiview(got, num_iters=25)
    vals, fails = problems.tracks_gates(costs.numpy(), solved.poses.numpy(), inputs[0], gt,
                                     int(got.obs_valid.sum(-1).max()))
    assert not fails, vals
    jprob = jmv.MultiViewProblem(*(jnp.asarray(f.numpy()) for f in want))
    jsolved, jcosts = jmv.solve_multiview(jprob, num_iters=25)
    a, b = solved.poses.numpy().astype(np.float64), np.asarray(jsolved.poses, np.float64)
    np.testing.assert_allclose(a[:, :3], b[:, :3], atol=1e-5)
    scale = np.sum(a[:, 3:] * b[:, 3:]) / np.sum(a[:, 3:] ** 2)
    np.testing.assert_allclose(scale * a[:, 3:], b[:, 3:], atol=1e-5)
    assert float(costs[-1]) < 1e-10 and float(np.asarray(jcosts)[-1]) < 1e-10


def test_render_trajectory_stacks_render_erp_at():
    """render_trajectory is render_erp_at's frames stacked, and renders
    the reference's frames from the same scene (under 0.1% of the pixel
    channels differ: disc edges within float32 reassociation)."""
    key = jax.random.PRNGKey(3)
    params = tuple(np.asarray(p, np.float32) for p in jsyn._texture_params(key))
    dists = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), (params[3].shape[0],),
                                          minval=2.0, maxval=6.0), np.float32)
    poses = problems.trajectory_poses(3)
    got = tsyn.render_trajectory(params, dists, poses, 48, 96, "cpu")
    assert got.shape == (3, 48, 96, 3) and got.dtype == torch.uint8
    for k in range(3):
        assert torch.equal(got[k], tsyn.render_erp_at(params, dists, poses[k], 48, 96, "cpu"))
    want = np.asarray(jsyn.render_trajectory(key, jnp.asarray(poses), 48, 96))
    assert (got.numpy() != want).mean() < 1e-3


@pytest.fixture(scope="module")
def odometry_tables():
    """A 4-frame rendered trajectory at 96x192 through the port's
    run_two_view_batch on the CPU (compat), chained into poses."""
    rng = np.random.default_rng(problems.ODO_SEED)
    params = tsyn.texture_params_from_numpy(rng)
    dists = tsyn.disc_distances_from_numpy(rng)
    frames = tsyn.render_trajectory(params, dists, problems.trajectory_poses(4), 96, 192, "cpu")
    cfg = PipelineConfig(surf=SurfConfig(max_keypoints=128, n_octaves=2),
                         match=MatchConfig(max_matches=256, ratio_thresh=0.6))
    out = ttv.run_two_view_batch(frames[:-1], frames[1:], torch.Generator().manual_seed(0), cfg)
    g = tpg.chain_with_loop_closures(out.rotation_aa, out.translation)
    return [g.poses, out.left_xy, out.right_xy, out.match_valid, out.rotation_aa,
            out.translation]


def test_real_match_tables(odometry_tables):
    """(f) Frame k's keypoints, as the right image of pair k-1 and the
    left image of pair k of one batch, agree bit for bit wherever they
    share a cell; every pair links to its predecessor; both packages
    build the same tracks and problem from the same tables."""
    inputs = odometry_tables
    cells = problems.shared_cells(*inputs[1:4])
    assert all(n > 0 for n in cells["same_cell"]), cells
    assert not any(cells["same_cell_not_bit_identical"]), cells
    arrays = [t.numpy() for t in inputs]
    got, want = _both_merges(*arrays[1:4])
    _assert_same_tracks(got, want)
    assert all(n > 0 for n in (got.slot[1:] > 0).sum(-1).tolist())
    _assert_same_problem(*_both_builds(arrays, 192, 96))


def test_build_makes_no_per_pair_loop():
    """The build's torch calls do not grow with the number of pairs (no
    per-pair launches): 4 and 64 pairs take the same number, apart from
    pointer doubling's rounds (log2 of the pairs)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    calls = []
    for n_pairs in (5, 65):
        inputs = [torch.from_numpy(np.asarray(a)) for a in problems.synth_tracks(n_pairs + 1, 40, 2)[0]]
        with Count() as c:
            ttr.build_multiview_problem(*inputs, problems.TRACKS_W, problems.TRACKS_H)
        calls.append(c.n)
    rounds = 4  # ceil(log2(64)) - ceil(log2(4)) pointer-doubling rounds
    assert calls[1] - calls[0] == rounds * 3, calls  # two gathers and an add a round
