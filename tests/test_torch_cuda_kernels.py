"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions on
the card, and the global solvers on the card against their CPU runs.
Marked `cuda`: without a GPU they skip (a CUDA kernel has no interpret
mode); run them on the card with `python -m pytest tests -m cuda`."""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from spherical_bundle_adjuster_tpu_torch.ops import cuda_match, cuda_surf, integral
from spherical_bundle_adjuster_tpu_torch.utils.config import (
    MatchConfig, PipelineConfig, SurfConfig,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _bands(dev, b=3, h=64, w=200, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    return integral.integral_image(torch.from_numpy(g).to(dev))


# (bands, rows, width): widths that are not a multiple of the kernels'
# column tiles (200, 2047: edge tiles narrower than the tile, clamped
# edge copies) and one that is (2048); 64 and 40 rows are shorter than the
# largest filters, so whole layers are -inf.
SHAPES = [(1, 64, 200), (3, 64, 2047), (2, 40, 2048)]


@pytest.mark.parametrize("n_octaves", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_det_octave_kernel_matches_plain(dev, n_octaves, shape):
    """Every octave bit-identical to the plain version, -inf mask
    included, from one launch."""
    b, h, w = shape
    cfg = SurfConfig(n_octaves=n_octaves)
    ii = _bands(dev, b, h, w, seed=n_octaves)
    before = cuda_surf.DET_PYRAMID.launches
    got = cuda_surf.det_pyramid(ii, cfg)
    torch.cuda.synchronize()
    assert cuda_surf.DET_PYRAMID.launches == before + 1 and len(got) == n_octaves
    empty = 0
    for o, k in enumerate(got):
        p = cuda_surf.det_octave_plain(ii, o, cfg)
        assert torch.equal(k, p), (o, (k - p).abs().nan_to_num().max().item())
        empty += int(torch.isinf(p).flatten(2).all(-1).any())
    assert empty > 0  # a layer whose filter does not fit the band


@pytest.mark.parametrize("n_octaves", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_haar_trace_kernel_matches_plain(dev, n_octaves, shape):
    """hx, hy and the trace sign bit-identical to the plain version."""
    b, h, w = shape
    cfg = SurfConfig(n_octaves=n_octaves)
    ii = _bands(dev, b, h, w, seed=10 + n_octaves)
    before = cuda_surf.HAAR_TRACE.launches
    hx, hy, tr = cuda_surf.haar_trace_maps(ii, cfg)
    torch.cuda.synchronize()
    assert cuda_surf.HAAR_TRACE.launches == before + 1
    px, py, pt = cuda_surf.haar_trace_maps_plain(ii, cfg)
    assert torch.equal(hx, px) and torch.equal(hy, py) and torch.equal(tr, pt)


def test_surf_kernels_take_only_integral_images_layout(dev):
    """A dense integral image (row stride 2049 floats, not 16-byte
    aligned) is refused before any launch; integral_image's layout of the
    same values gives the plain version's results."""
    cfg = SurfConfig(n_octaves=2)
    ii = _bands(dev, 2, 48, 2048, seed=5)
    dense = ii.contiguous()
    assert dense.stride(1) == 2049 and torch.equal(dense, ii)
    before = (cuda_surf.DET_PYRAMID.launches, cuda_surf.HAAR_TRACE.launches)
    with pytest.raises(ValueError):
        cuda_surf.det_pyramid(dense, cfg)
    with pytest.raises(ValueError):
        cuda_surf.haar_trace_maps(dense, cfg)
    assert (cuda_surf.DET_PYRAMID.launches, cuda_surf.HAAR_TRACE.launches) == before
    for k, p in zip(cuda_surf.det_pyramid(ii, cfg), cuda_surf.det_pyramid_plain(dense, cfg)):
        assert torch.equal(k, p)
    for a, b in zip(cuda_surf.haar_trace_maps(ii, cfg), cuda_surf.haar_trace_maps_plain(dense, cfg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k1,k2", [(2048, 2048), (100, 333), (1, 64), (7, 50), (300, 2100),
                                   (1000, 2100), (8192, 8192)])
def test_top2_kernel_matches_plain(dev, k1, k2):
    """Identical indices and distances within 2e-3, from one launch: a bank
    smaller than one 128-row sub-tile (50, 64), a ragged one (333), a
    query tile whose last blocks take no rows (2100), ragged query tiles
    (100, 300, 1000), and an 8192-row bank whose blocks loop over 8
    sub-tiles each."""
    rng = np.random.default_rng(k1 + k2)
    d1 = torch.from_numpy(rng.normal(size=(k1, 64)).astype(np.float32)).to(dev)
    d2 = torch.from_numpy(rng.normal(size=(k2, 64)).astype(np.float32)).to(dev)
    v2 = torch.from_numpy(rng.random(k2) > 0.1).to(dev)
    before = cuda_match.TOP2.launches
    dist, idx = cuda_match.top2_distances(d1, d2, v2)
    torch.cuda.synchronize()
    assert cuda_match.TOP2.launches == before + 1
    pd, pi = cuda_match.top2_distances_plain(d1, d2, v2)
    assert torch.equal(idx, pi)
    torch.testing.assert_close(dist, pd, atol=2e-3, rtol=0)


@pytest.mark.parametrize("k2", [2048, 2100])
def test_top2_kernel_ties_across_lanes_and_blocks(dev, k2):
    """Exact duplicates of query 0 at rows 1 and 16 (two lanes of one
    sub-tile, the higher lane index holding the lower row), 1025 and k2 - 1
    (other blocks of the query tile); of query 1 at rows 6, 700 (invalid),
    1500 and 2047. The lower indices win, the second slot is the next valid
    duplicate, and every index equals the plain version's. Unit rows, as
    SURF descriptors are: the distance of a duplicate is then the square
    root of a rounding residual of |q|^2 + |t|^2 - 2 q.t near 1e-7, within
    the tolerance (for rows of norm 8 it would be near 3e-3)."""
    rng = np.random.default_rng(k2)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    d1 = torch.from_numpy(unit(rng.normal(size=(2048, 64))).astype(np.float32)).to(dev)
    d2 = torch.from_numpy(unit(rng.normal(size=(k2, 64))).astype(np.float32)).to(dev)
    v2 = torch.from_numpy(rng.random(k2) > 0.1).to(dev)
    d2[[1, 16, 1025, k2 - 1]] = d1[0]
    d2[[6, 700, 1500, 2047 if k2 > 2048 else 2046]] = d1[1]
    v2[[1, 16, 1025, k2 - 1, 6, 1500]] = True
    v2[700] = False
    dist, idx = cuda_match.top2_distances(d1, d2, v2)
    torch.cuda.synchronize()
    assert idx[0].tolist() == [1, 16] and idx[1].tolist() == [6, 1500]
    assert dist[0, 0] == dist[0, 1] and dist[1, 0] == dist[1, 1]
    pd, pi = cuda_match.top2_distances_plain(d1, d2, v2)
    assert torch.equal(idx, pi)
    torch.testing.assert_close(dist, pd, atol=2e-3, rtol=0)


def test_top2_kernel_on_two_streams_at_once(dev):
    """Launches on two streams overlap, and each still gives the plain
    version's result: the blocks of one launch count their arrivals apart
    from the other's. Both streams wait on one event recorded behind a
    spin, so their launches start together, in pairs of equal work whose
    blocks arrive at their counters at the same time; every launch takes
    its own banks, so a merge that read another launch's partial results,
    or a row left unwritten, cannot pass for right by repeating an
    earlier launch's values."""
    rng = np.random.default_rng(3)
    banks = []
    for _ in range(16):
        d1 = torch.from_numpy(rng.normal(size=(512, 64)).astype(np.float32)).to(dev)
        d2 = torch.from_numpy(rng.normal(size=(2048, 64)).astype(np.float32)).to(dev)
        banks.append((d1, d2, torch.from_numpy(rng.random(2048) > 0.1).to(dev)))
    want = [cuda_match.top2_distances_plain(*b) for b in banks]
    torch.cuda._sleep(10**7)
    go = torch.cuda.Event()
    go.record()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for s in streams:
        s.wait_event(go)
    got = []
    for k, b in enumerate(banks):
        with torch.cuda.stream(streams[k % 2]):
            got.append(cuda_match.top2_distances(*b))
    torch.cuda.synchronize()
    for k, ((dist, idx), (pd, pi)) in enumerate(zip(got, want)):
        assert torch.equal(idx, pi), k
        torch.testing.assert_close(dist, pd, atol=2e-3, rtol=0)


def test_top2_counters_are_per_stream(dev):
    """K3's arrival counters: one buffer for each stream, reused on the
    same stream. Two overlapping launches that shared one could count each
    other's blocks, a race test_top2_kernel_on_two_streams_at_once does not
    reliably provoke (it passed against a shared buffer on an H100)."""
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    ptrs = []
    for s in streams:
        with torch.cuda.stream(s):
            ptrs.append(cuda_match._counters(dev, 16).data_ptr())
            assert cuda_match._counters(dev, 16).data_ptr() == ptrs[-1]
    assert ptrs[0] != ptrs[1]


@pytest.mark.parametrize("pairs", [1, 3, 64])
def test_top2_batched_launch_equals_separate_launches(dev, pairs):
    """One launch over P pairs of ragged banks (1000 queries against 2100
    train rows, ~10% invalid, exact ties planted per pair) gives each pair
    bit for bit what a launch of that pair alone gives."""
    g = torch.Generator(dev).manual_seed(pairs)
    d1 = torch.randn(pairs, 1000, 64, device=dev, generator=g)
    d2 = torch.randn(pairs, 2100, 64, device=dev, generator=g)
    v2 = torch.rand(pairs, 2100, device=dev, generator=g) > 0.1
    d2[:, [1, 16, 1025, 2099]] = d1[:, :1]
    v2[:, [1, 16, 1025, 2099]] = True
    before = cuda_match.TOP2.launches
    dist, idx = cuda_match.top2_distances(d1, d2, v2)
    torch.cuda.synchronize()
    assert cuda_match.TOP2.launches == before + 1
    assert dist.shape == (pairs, 1000, 2) and idx.shape == (pairs, 1000, 2)
    for p in range(pairs):
        one_d, one_i = cuda_match.top2_distances(d1[p], d2[p], v2[p])
        assert torch.equal(dist[p], one_d) and torch.equal(idx[p], one_i), p
        assert idx[p, 0].tolist() == [1, 16]


def test_top2_batched_counters_are_per_pair_tile_and_left_zero(dev):
    """A batched launch counts on one entry per (pair, query tile) of its
    stream's buffer and leaves every entry zero; launches on another
    stream use another buffer."""
    pairs, k1, k2 = 5, 700, 1500
    tiles = pairs * cuda_match.top2_plan(k1, k2).q_tiles
    g = torch.Generator(dev).manual_seed(1)
    d1 = torch.randn(pairs, k1, 64, device=dev, generator=g)
    d2 = torch.randn(pairs, k2, 64, device=dev, generator=g)
    v2 = torch.ones(pairs, k2, dtype=torch.bool, device=dev)
    cuda_match.top2_distances(d1, d2, v2)
    torch.cuda.synchronize()
    buf = cuda_match._counters(dev, tiles)
    assert buf.numel() >= tiles and not bool(buf.any())
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        cuda_match.top2_distances(d1, d2, v2)
        other = cuda_match._counters(dev, tiles)
    torch.cuda.synchronize()
    assert other.data_ptr() != buf.data_ptr() and not bool(other.any())


def test_match_descriptors_mutual_check_on_the_card(dev):
    """The same matches on the card as on the CPU, with mutual_check."""
    from spherical_bundle_adjuster_tpu_torch.ops import match

    rng = np.random.default_rng(9)
    d2 = rng.normal(size=(2048, 64))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    d1 = d2[rng.permutation(2048)] + rng.normal(scale=0.1, size=(2048, 64))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    banks = [torch.from_numpy(x.astype(np.float32)) for x in (d1, d2)]
    v1, v2 = (torch.from_numpy(rng.random(2048) > 0.1) for _ in range(2))
    cfg = MatchConfig(max_matches=1024, ratio_thresh=0.8, mutual_check=True)
    mc = match.match_descriptors(banks[0].to(dev), v1.to(dev), banks[1].to(dev), v2.to(dev), cfg)
    mh = match.match_descriptors(banks[0], v1, banks[1], v2, cfg)
    assert int(mc.count) == int(mh.count) > 100
    for a, b in zip(mc, mh):
        torch.testing.assert_close(a.cpu(), b, atol=2e-3, rtol=0)


def test_top2_kernel_all_invalid_and_ties(dev):
    d1 = torch.zeros((5, 64), device=dev)
    d1[:, 0] = 1.0
    d2 = torch.zeros((70, 64), device=dev)
    d2[[3, 9, 66], 0] = 1.0
    dist, idx = cuda_match.top2_distances(d1, d2, torch.ones(70, dtype=torch.bool, device=dev))
    assert (idx[:, 0] == 3).all() and (idx[:, 1] == 9).all()
    dist, idx = cuda_match.top2_distances(d1, d2, torch.zeros(70, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    assert torch.isinf(dist).all() and (idx[:, 0] == 0).all()


@pytest.mark.parametrize("j", [0, 1500])
def test_top2_kernel_single_valid_row(dev, j):
    """One valid row, in the first block or a later one: the same winner
    and distances as the plain version, the second distance inf (its index
    is unspecified then)."""
    rng = np.random.default_rng(j)
    d1 = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).to(dev)
    d2 = torch.from_numpy(rng.normal(size=(2048, 64)).astype(np.float32)).to(dev)
    v2 = torch.zeros(2048, dtype=torch.bool, device=dev)
    v2[j] = True
    dist, idx = cuda_match.top2_distances(d1, d2, v2)
    torch.cuda.synchronize()
    pd, pi = cuda_match.top2_distances_plain(d1, d2, v2)
    assert (idx[:, 0] == j).all() and torch.equal(idx[:, 0], pi[:, 0])
    assert torch.isinf(dist[:, 1]).all()
    torch.testing.assert_close(dist, pd, atol=2e-3, rtol=0)


def test_wrappers_raise_on_bad_input(dev):
    ii = _bands(dev)
    with pytest.raises(ValueError):
        cuda_surf.det_pyramid(ii.double(), SurfConfig())
    with pytest.raises(ValueError):
        cuda_surf.haar_trace_maps(ii[:, :, ::2], SurfConfig())
    d = torch.zeros((4, 32), device=dev)
    with pytest.raises(ValueError):
        cuda_match.top2_distances(d, d, torch.ones(4, dtype=torch.bool, device=dev))


def test_run_two_view_on_the_card_uses_every_kernel(dev):
    from spherical_bundle_adjuster_tpu_torch.models import twoview
    from spherical_bundle_adjuster_tpu_torch.utils import synthetic

    cfg = PipelineConfig(surf=SurfConfig(max_keypoints=128, n_octaves=2),
                         match=MatchConfig(max_matches=256, ratio_thresh=0.5)).parity()
    params = synthetic.texture_params_from_numpy(np.random.default_rng(0))
    euler = np.deg2rad([1.0, -2.0, 3.0]).astype(np.float32)
    left, right, R = synthetic.rotation_pair(params, euler, 128, 256, dev)
    kernels = (cuda_surf.DET_PYRAMID, cuda_surf.HAAR_TRACE, cuda_match.TOP2)
    before = [k.launches for k in kernels]
    out = twoview.run_two_view(left, right, torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert bool(out.ok) and int(out.num_matches) >= 16
    assert out.rotation_aa.device.type == "cuda"


def test_run_two_view_batch_on_the_card(dev):
    """Three pairs in chunks of 2: one K1 / K2 / K3 launch per chunk, and
    each pair's match list that of its single-pair run with its draws."""
    from spherical_bundle_adjuster_tpu_torch.models import twoview
    from spherical_bundle_adjuster_tpu_torch.solver import epipolar
    from spherical_bundle_adjuster_tpu_torch.utils import synthetic

    cfg = PipelineConfig(surf=SurfConfig(max_keypoints=128, n_octaves=2),
                         match=MatchConfig(max_matches=256, ratio_thresh=0.5)).parity()
    pairs = [synthetic.rotation_pair(synthetic.texture_params_from_numpy(np.random.default_rng(i)),
                                     np.deg2rad([1.0, -2.0, 3.0 * i]).astype(np.float32),
                                     128, 256, dev) for i in range(3)]
    lefts, rights = (torch.stack([p[k] for p in pairs]) for k in (0, 1))
    gumbel = epipolar.gumbel_draws(cfg.ransac.num_trials, 256, torch.Generator(dev).manual_seed(0),
                                   dev, (3,))
    kernels = (cuda_surf.DET_PYRAMID, cuda_surf.HAAR_TRACE, cuda_match.TOP2)
    before = [k.launches for k in kernels]
    out = twoview.run_two_view_batch(lefts, rights, None, cfg, batch_chunk=2, gumbel=gumbel)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2]
    for i in range(3):
        one = twoview.run_two_view(lefts[i], rights[i], None, cfg, gumbel=gumbel[i])
        assert torch.equal(one.match_valid, out.match_valid[i])
        assert torch.equal(one.left_xy, out.left_xy[i]) and torch.equal(one.right_xy, out.right_xy[i])
        assert bool(out.ok[i])


# The global solvers (plain PyTorch on the card): small problems from
# chip_smoke.py's numpy recipes, each solver route.
SOLVER_CASES = [
    ("multiview", (8, 128, 4, 0.05, 2), dict(num_iters=8)),                      # auto -> dense
    ("multiview", (40, 160, 4, 0.05, 1), dict(num_iters=8)),                     # auto -> pcg
    ("pose_graph", (24, 4, 4), dict(num_iters=10)),                              # auto -> dense
    ("pose_graph", (80, 6, 5), dict(num_iters=10, robust_delta=0.05, tran_weight=0.2)),  # pcg
    ("pose_graph_chain", (80, 6, 5), dict(num_iters=10)),  # chain_with_loop_closures, pcg
]


def _solver_case(kind, args, kw, device):
    import chip_smoke
    from spherical_bundle_adjuster_tpu_torch.models import multiview
    from spherical_bundle_adjuster_tpu_torch.solver import pose_graph

    if kind == "multiview":
        fields, _ = chip_smoke.synth_multiview(*args)
        return multiview.problem_from_numpy(fields, device), lambda p: multiview.solve_multiview(p, **kw)
    fields, _ = chip_smoke.synth_pose_graph(*args)

    def solve(g):
        return pose_graph.optimize_pose_graph(g, **kw)

    if kind == "pose_graph":
        return pose_graph.graph_from_numpy(fields, device), solve
    # the same edges as odometry (the first n - 1) and closures, chained
    n, (_, ei, ej, rot, tran, _) = args[0], fields
    closures = [(int(i), int(j), r, t) for i, j, r, t in
                zip(ei[n - 1:], ej[n - 1:], rot[n - 1:], tran[n - 1:])]
    odo = [torch.as_tensor(x[:n - 1], device=device) for x in (rot, tran)]
    return pose_graph.chain_with_loop_closures(*odo, closures, closure_weight=2.0,
                                               odometry_weights=np.linspace(0.5, 2.0, n - 1)), solve


@pytest.mark.parametrize("kind,args,kw", SOLVER_CASES)
def test_solvers_on_the_card_match_the_cpu(dev, kind, args, kw):
    """Poses within 1e-4 and final costs within 1e-3 relative (or 1e-9) of
    the port's CPU run of the same problem; two runs on the card give the
    same bits (the fixed-order segment sums)."""
    inputs, solve = _solver_case(kind, args, kw, dev)
    assert all(t.device.type == "cuda" for t in inputs)
    out, costs = solve(inputs)
    again, costs2 = solve(inputs)
    torch.cuda.synchronize()
    assert out.poses.device.type == "cuda" and costs.device.type == "cuda"
    assert torch.equal(out.poses, again.poses) and torch.equal(costs, costs2)
    cpu_inputs, _ = _solver_case(kind, args, kw, "cpu")
    cpu, cpu_costs = solve(cpu_inputs)
    np.testing.assert_allclose(out.poses.cpu().numpy(), cpu.poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(costs[-1]), float(cpu_costs[-1]), rtol=1e-3, atol=1e-9)


class _CpuTensors(TorchFunctionMode):
    """Records the torch calls that return a CPU tensor."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(o, torch.Tensor) and o.device.type == "cpu" for o in outs):
            self.calls.append(getattr(func, "__name__", repr(func)))
        return out


@pytest.mark.parametrize("kind,args,kw", [SOLVER_CASES[1], SOLVER_CASES[3], SOLVER_CASES[4]])
def test_solver_inputs_on_the_card_never_move_to_the_cpu(dev, kind, args, kw):
    """Inputs built for the card and their solve stay there: no torch call
    returns a CPU tensor, from the problem's build (problem_from_numpy,
    graph_from_numpy, chain_with_loop_closures) to the solve's end (the
    segment-sum orders are built on the device too)."""
    _solver_case(kind, args, kw, dev)  # imports outside the watch
    mode = _CpuTensors()
    with mode:
        inputs, solve = _solver_case(kind, args, kw, dev)
        out, costs = solve(inputs)
    assert mode.calls == []
    assert all(t.device.type == "cuda" for t in (*out, costs))
