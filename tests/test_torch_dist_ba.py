"""Port parity: parallel/dist_ba (the landmark-sharded Schur BA, the 2-D
mesh batch, the sharded two-view batch and the collective accounting)
over gloo ranks spawned on the CPU, against the JAX package's sharded
solves on its 8-device virtual CPU mesh and against the port's own
single-process solves.

One spawn of 4 ranks (tests/torch_ranks.dist_ba_cases, with a
process-group timeout of 60 s and a deadline for the whole run) computes
every sharded case; the tests read its results. The sharded solves differ
from the single-process one only by the order of their sums."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from spherical_bundle_adjuster_tpu.parallel import dist_ba as jdist, mesh as jmesh
from spherical_bundle_adjuster_tpu.utils import synthetic as jsyn
from spherical_bundle_adjuster_tpu.utils.config import MatchConfig, PipelineConfig, SurfConfig
from spherical_bundle_adjuster_tpu_torch.models import multiview as tmv
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.parallel import dist_ba as tdist, launch
from spherical_bundle_adjuster_tpu_torch.parallel import mesh as tmesh
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from test_multiview import pose_errors, synth_problem
from test_torch_batch import _assert_results_equal
from test_torch_sequence import _rot_gap, reference_on_port_matches

torch.set_num_threads(1)

WORLD = 4
DEADLINE_S = 300
# __graft_entry__.dryrun_multichip's two-view config, on 4 rendered
# 64x128 rotation pairs (its random-noise images give no match at all)
PAIR_CFG = PipelineConfig(surf=SurfConfig(max_keypoints=32, n_octaves=1),
                          match=MatchConfig(max_matches=64, ratio_thresh=0.6))
PAIR_H, PAIR_W, N_PAIRS = 64, 128, 4


def _fields(prob):
    return [np.asarray(f) for f in prob]


def _pair_draws(key):
    """The reference's run_two_view draws for `key`."""
    m = PAIR_CFG.match.max_matches
    keys = jax.random.split(key, PAIR_CFG.ransac.num_trials)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys))


@pytest.fixture(scope="module")
def inputs():
    small, gt, _ = synth_problem(C=4, L=64, P=4)
    batch = [synth_problem(C=4, L=64, P=4, seed=s) for s in (5, 6)]
    big, big_gt, _ = synth_problem(C=256, L=8192, P=4, pose_noise=0.03, seed=3)
    lefts, rights = [], []
    for i in range(N_PAIRS):
        euler = np.deg2rad(np.random.default_rng(i).uniform(-5, 5, 3))
        left, right, _ = jsyn.rotation_pair(jax.random.PRNGKey(100 + i), euler, PAIR_H, PAIR_W)
        lefts.append(np.asarray(left))
        rights.append(np.asarray(right))
    keys = jax.random.split(jax.random.PRNGKey(0), N_PAIRS)
    return dict(small=small, gt=gt, batch=[p for p, _, _ in batch], batch_gt=[g for _, g, _ in batch],
                big=big, big_gt=big_gt, lefts=np.stack(lefts), rights=np.stack(rights), keys=keys,
                draws=np.stack([_pair_draws(k) for k in keys]))


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's results of tests/torch_ranks.dist_ba_cases."""
    batch = [np.stack(f) for f in zip(*(_fields(p) for p in inputs["batch"]))]
    pairs = (inputs["lefts"], inputs["rights"], inputs["draws"], tconfig.from_reference(PAIR_CFG))
    return launch.run_ranks(torch_ranks.dist_ba_cases, WORLD,
                            args=(_fields(inputs["small"]), batch, _fields(inputs["big"]), pairs),
                            threads=1, timeout_s=torch_ranks.TIMEOUT.total_seconds(),
                            deadline_s=DEADLINE_S)


def _single(prob, **kw):
    return tmv.solve_multiview(tmv.problem_from_numpy(_fields(prob), "cpu"), **kw)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_single_device(inputs, ranks, world):
    """tests/test_multiview.py::TestDistributed::test_sharded_matches_single_device
    over 2 and 4 ranks: its gates (max rotation error < 0.5 deg, last cost
    < 1e-5, last cost within rtol 0.5 / atol 1e-6 of the single solve),
    the poses within 1e-6 of the port's single-process solve (measured
    6.0e-8) and within 5e-6 of the JAX package's 8-device sharded solve
    (measured 8.0e-7), the last cost on the JAX test's bound to both."""
    got = ranks[0]["small", world, "dense"]
    ang, _ = pose_errors(got["poses"].numpy(), inputs["gt"])
    assert np.max(ang) < 0.5
    assert float(got["costs"][-1]) < 1e-5
    single, costs_1 = _single(inputs["small"], num_iters=12)
    np.testing.assert_allclose(float(got["costs"][-1]), float(costs_1[-1]), rtol=0.5, atol=1e-6)
    np.testing.assert_allclose(got["poses"].numpy(), single.poses.numpy(), rtol=0, atol=1e-6)
    j_solved, j_costs = jdist.solve_multiview_sharded(inputs["small"], jmesh.make_mesh(8),
                                                      num_iters=12)
    np.testing.assert_allclose(got["poses"].numpy(), np.asarray(j_solved.poses), rtol=0, atol=5e-6)
    np.testing.assert_allclose(float(got["costs"][-1]), float(j_costs[-1]), rtol=0.5, atol=1e-6)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_one_rank_mesh_is_bit_identical(inputs, ranks, solver):
    """A 1-rank mesh gives solve_multiview's bits: over a 1-rank gloo group
    (rank 0 of the spawned job) and without any process group (here)."""
    single, costs = _single(inputs["small"], num_iters=12, linear_solver=solver)
    local = tdist.solve_multiview_sharded(
        tmv.problem_from_numpy(_fields(inputs["small"]), "cpu"), tmesh.make_mesh(1),
        num_iters=12, linear_solver=solver)
    for got in (ranks[0]["small", 1, solver],
                dict(poses=local[0].poses, landmarks=local[0].landmarks, costs=local[1])):
        assert torch.equal(got["poses"], single.poses)
        assert torch.equal(got["landmarks"], single.landmarks)
        assert torch.equal(got["costs"], costs)


def _tensors(x):
    """Every tensor in a (nested) result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x, key=str) for t in _tensors(x[k])]
    if isinstance(x, tuple):
        return [t for f in x for t in _tensors(f)]
    return []


def test_every_rank_ends_with_the_same_bits(ranks):
    """Every result that several ranks return (solves, the 2-D batch, the
    two-view batch) is bit-identical on each of them to rank 0's."""
    checked = 0
    for key, want in ranks[0].items():
        if key == "batch" or key[0] == "traffic" or isinstance(want, str):
            continue
        for r in range(1, WORLD):
            if key in ranks[r]:
                got = _tensors(ranks[r][key])
                assert len(got) == len(_tensors(want)) > 0, key
                assert all(torch.equal(a, b) for a, b in zip(got, _tensors(want))), (key, r)
                checked += 1
    for r in range(1, WORLD):
        for f in ("poses", "landmarks", "costs"):
            assert torch.equal(ranks[r]["batch"][f], ranks[0]["batch"][f]), (f, r)
    # the small solves over 4 ranks (3 others) and over 2 (1 other), dense
    # and PCG; the moved poses; c256; the two-view batch (1 other)
    assert checked == 2 * 3 + 2 * 1 + 3 + 3 + 1


def test_replicated_poses_come_from_the_first_rank(ranks):
    """Every rank but the first passes poses moved by 1e-3 x its rank: the
    solve broadcasts the first rank's, so every rank solves the problem
    as rank 0 holds it, bit for bit."""
    want = ranks[0]["small", 4, "dense"]
    for r in range(WORLD):
        got = ranks[r]["small_moved_poses"]
        assert all(torch.equal(got[f], want[f]) for f in ("poses", "landmarks", "costs")), r


def test_landmarks_that_do_not_divide_raise(ranks):
    """62 landmarks over 4 ranks: ValueError on every rank (the JAX
    contract), before any collective."""
    for r in range(WORLD):
        assert "62 landmarks do not divide" in ranks[r]["indivisible"]


def test_2d_mesh_batch_of_problems(inputs, ranks):
    """TestDistributed::test_2d_mesh_batch_of_problems over a 2 x 2 mesh
    of ranks (seeds 5 and 6, PCG, 100 CG iterations): costs (2, 12), each
    problem on its own gates (last cost < 1e-5, max rotation error < 0.5
    deg), its poses within 1e-6 of its own single-process solve (measured
    1.5e-7) and within 5e-6 of the JAX package's batch on its 2 x 4 mesh
    (measured 1.5e-6)."""
    got = ranks[0]["batch"]
    assert got["costs"].shape == (2, 12)
    assert got["poses"].shape == (2, 4, 6) and got["landmarks"].shape == (2, 64, 3)
    assert [r["batch"]["coords"] for r in ranks] == [
        {"pairs": i, "data": j} for i in (0, 1) for j in (0, 1)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *inputs["batch"])
    j_solved, j_costs = jdist.solve_multiview_batch_sharded(
        batched, jmesh.make_mesh_2d(2, 4), num_iters=12, linear_solver="pcg", cg_iters=100)
    for i in (0, 1):
        assert float(got["costs"][i, -1]) < 1e-5
        ang, _ = pose_errors(got["poses"][i].numpy(), inputs["batch_gt"][i])
        assert np.max(ang) < 0.5, (i, ang)
        single, _ = _single(inputs["batch"][i], num_iters=12, linear_solver="pcg", cg_iters=100)
        np.testing.assert_allclose(got["poses"][i].numpy(), single.poses.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["poses"][i].numpy(), np.asarray(j_solved.poses[i]),
                                   rtol=0, atol=5e-6)


def test_c256_l8192_sharded_pcg(inputs, ranks):
    """tests/test_multiview.py::test_c256_l8192_sharded_pcg's problem over
    4 ranks, on its gates: cost ratio < 1e-4, median rotation error < 0.2
    deg, median translation error < 0.02."""
    got = ranks[0]["c256"]
    c0, c1 = float(got["costs"][0]), float(got["costs"][-1])
    assert c1 < 1e-4 * c0, (c0, c1)
    ang, terr = pose_errors(got["poses"].numpy(), inputs["big_gt"])
    assert np.median(ang) < 0.2, np.median(ang)
    assert np.median(terr) < 0.02, np.median(terr)


@pytest.mark.parametrize("C,solver,cg_iters", [
    (4, "dense", 100), (4, "pcg", 100), (256, "pcg", 60), (256, "dense", 60),
    (1024, "pcg", 60), (10, "dense", 7), (512, "pcg", 1)])
def test_collective_bytes_per_gn_iter_equals_the_reference(C, solver, cg_iters):
    assert tdist.collective_bytes_per_gn_iter(C, solver, cg_iters) == \
        jdist.collective_bytes_per_gn_iter(C, solver, cg_iters)
    assert tdist.collective_bytes_per_gn_iter(C, solver, cg_iters, dtype_bytes=8) == \
        jdist.collective_bytes_per_gn_iter(C, solver, cg_iters, dtype_bytes=8)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_all_reduce_traffic_of_one_gn_step(ranks, world, solver):
    """The bytes the all-reduces of a one-iteration sharded solve carry
    (counted by the mesh axis): the Schur setup is one (C, 84) all-reduce,
    the formula's setup bytes exactly; dense adds the (C, C, 6, 6) pair
    sum, PCG one (C, 6) vector a CG iteration; with the solve's two cost
    all-reduces (its start and its one step) the total stays at or under
    collective_bytes_per_gn_iter."""
    C, cg_iters = 4, 100
    for r in range(world):
        traffic = ranks[r]["traffic", world, solver]
        reduces = {b: n for (op, b), n in traffic.items() if op == "all_reduce"}
        setup = (2 * C * 36 + 2 * C * 6) * 4
        assert reduces.pop(setup) == 1
        assert reduces.pop(4) == 2  # the scalar costs
        if solver == "dense":
            assert reduces == {C * C * 36 * 4: 1}
        else:
            assert set(reduces) == {C * 6 * 4} and 1 <= reduces[C * 6 * 4] <= cg_iters
        total = sum(b * n for (op, b), n in traffic.items() if op == "all_reduce")
        assert total <= tdist.collective_bytes_per_gn_iter(C, solver, cg_iters)
        if solver == "dense":
            assert total == tdist.collective_bytes_per_gn_iter(C, solver, cg_iters)


def test_batched_two_view_sharded(inputs, ranks):
    """The sharded two-view batch (4 rendered 64x128 pairs under
    dryrun_multichip's config, 2 ranks of 2 pairs, the JAX package's draws
    injected): row for row against the port's unsharded
    run_two_view_batch, identical match lists and every field within 1e-5
    (tests/test_torch_batch.py's bound); against the JAX package's
    batched_two_view_sharded on a 2-device mesh, run on the port's band
    matches (a host callback, as in tests/test_torch_sequence.py), the
    same match lists and rotations within 0.5 deg (test_torch_batch's
    same-matches bound; measured 2.0e-5 rad, 0.0011 deg)."""
    got = ranks[0]["twoview"]
    tcfg = tconfig.from_reference(PAIR_CFG)
    lefts, rights = torch.from_numpy(inputs["lefts"]), torch.from_numpy(inputs["rights"])
    whole = ttv.run_two_view_batch(lefts, rights, None, tcfg, gumbel=torch.from_numpy(inputs["draws"]))
    assert got.rotation_aa.shape == (N_PAIRS, 3)
    assert int(got.num_matches.min()) >= 10
    _assert_results_equal(got, whole)
    with reference_on_port_matches():
        out_j = jdist.batched_two_view_sharded(jnp.asarray(inputs["lefts"]),
                                               jnp.asarray(inputs["rights"]), inputs["keys"],
                                               jmesh.make_mesh(2), PAIR_CFG, "band")
    for i in range(N_PAIRS):
        assert np.array_equal(np.asarray(out_j.match_valid[i]), got.match_valid[i].numpy())
        assert np.array_equal(np.asarray(out_j.left_xy[i]), got.left_xy[i].numpy())
        gap = _rot_gap(np.asarray(out_j.rotation_aa[i])[None], got.rotation_aa[i].numpy()[None])
        assert np.degrees(gap) < 0.5, (i, gap)
