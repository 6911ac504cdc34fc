"""The shared-memory staging plan of K1 and K2 (ops/cuda_surf.py), on the
CPU. A CUDA kernel cannot run here, so these tests replay, in numpy, how
csrc/surf_maps.cu stages each tile's lattice into shared memory from the
part table and where it then reads each corner, and hold the result bit
for bit against the plain versions: a slot the plan leaves out or maps to
the wrong image position shows as a mismatch."""

import numpy as np
import pytest
import torch

from spherical_bundle_adjuster_tpu_torch import problems
from spherical_bundle_adjuster_tpu_torch.ops import cuda_surf, integral
from spherical_bundle_adjuster_tpu_torch.utils.config import SurfConfig

torch.set_num_threads(1)

F = np.float32
K = cuda_surf.MAX_OFFS


HEAD = ("first", "ty", "tx", "nty", "ntx", "pitch", "nr", "nc",
        "shift", "oh", "ow", "out_off", "band_stride")


def _parts(table):
    """struct Part fields of each table row (csrc/surf_maps.cu)."""
    out = []
    n = len(HEAD)
    for row in table:
        p = dict(zip(HEAD, (int(v) for v in row[:n])))
        arr = [row[n + i * K: n + (i + 1) * K].astype(int) for i in range(8)]
        p.update(zip(("r0", "ro", "re", "c0", "co", "ce", "rb", "cb"), arr))
        p["size"], p["half"] = int(row[n + 8 * K]), int(row[n + 8 * K + 1])
        p["wt"] = row[n + 8 * K + 2:].view(np.float32)
        out.append(p)
    return out


def _tiles(parts, b):
    """(part, band, y0, x0, ny, nx) of every tile, in launch order."""
    for pi, p in enumerate(parts):
        for band in range(b):
            for ty in range(p["nty"]):
                for tx in range(p["ntx"]):
                    y0, x0 = ty * p["ty"], tx * p["tx"]
                    yield pi, band, y0, x0, min(p["ty"], p["oh"] - y0), min(p["tx"], p["ow"] - x0)


def _plane(flat, p, band, y0, ny, x0, nx):
    """The tile's outputs in the launch's flat output buffer."""
    base = p["out_off"] + band * p["band_stride"]
    return flat[base: base + p["oh"] * p["ow"]].reshape(p["oh"], p["ow"])[y0:y0 + ny, x0:x0 + nx]


def _stage(img, h, w, step, p, y0, ny, x0, nx):
    """The block's shared memory after stage_lattice: NaN where nothing
    was staged. Checks that no slot is copied twice, that the copies stay
    inside the buffer, and that the 16-byte copies of step 1 are
    aligned."""
    rows = max(p["r0"][i] + p["ty"] + p["re"][i] for i in range(p["nr"]))
    S = np.full((rows, p["pitch"]), np.nan, F)
    written = np.zeros(S.shape, bool)
    for i in range(p["nr"]):
        m = np.arange(ny + p["re"][i])
        src = np.clip((y0 + m) * step + p["ro"][i], 0, h)
        for j in range(p["nc"]):
            n = nx + p["ce"][j]
            c = x0 * step + p["co"][j]
            if step == 1:  # whole 16-byte chunks from a 4-float aligned column
                assert c % 4 == 0 and p["c0"][j] % 4 == 0 and p["pitch"] % 4 == 0
                n = -(-n // 4) * 4
            mm = np.arange(n)
            cols = np.clip(c + mm * step, 0, w)
            at = np.ix_(p["r0"][i] + m, p["c0"][j] + mm)
            assert p["c0"][j] + n <= p["pitch"] and not written[at].any()
            written[at] = True
            S[at] = img[np.ix_(src, cols)]
    return S


def _box(a, b, c, d):
    return ((a - b) - c) + d


def _corner_reader(S, p, ys, xs):
    def P(r, c):
        v = S[np.ix_(p["rb"][r] + ys, p["cb"][c] + xs)]
        assert not np.isnan(v).any(), (r, c)
        return v
    return P


def det_emulated(ii, cfg):
    """K1's whole pyramid as the single launch computes it."""
    b, h, w = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    n_l = cfg.n_octave_layers + 2
    table, shapes, n_tiles, _ = cuda_surf._det_plan(cfg.n_octaves, n_l, b, h, w)
    parts = _parts(table)
    flat = np.full(sum(int(np.prod(s)) for s in shapes), np.nan, F)
    tiles = list(_tiles(parts, b))
    assert len(tiles) == n_tiles
    for l, band, y0, x0, ny, nx in tiles:
        p = parts[l]
        size, half, wt, step = p["size"], p["half"], p["wt"], 1 << p["shift"]
        ylo = (half + step - 1) // step
        lim = h - (size - half)
        yhi = lim // step if lim >= 0 else -1
        va, vb = max(ylo - y0, 0), min(yhi - y0 + 1, ny)
        tile = np.full((ny, nx), -np.inf, F)
        if va < vb:
            S = _stage(ii[band], h, w, step, p, y0 + va, vb - va, x0, nx)
            P = _corner_reader(S, p, np.arange(vb - va), np.arange(nx))
            dxx = wt[0] * _box(P(7, 3), P(2, 3), P(7, 0), P(2, 0))
            dxx = dxx + wt[1] * _box(P(7, 6), P(2, 6), P(7, 3), P(2, 3))
            dxx = dxx + wt[2] * _box(P(7, 9), P(2, 9), P(7, 6), P(2, 6))
            dyy = wt[3] * _box(P(3, 7), P(0, 7), P(3, 2), P(0, 2))
            dyy = dyy + wt[4] * _box(P(6, 7), P(3, 7), P(6, 2), P(3, 2))
            dyy = dyy + wt[5] * _box(P(9, 7), P(6, 7), P(9, 2), P(6, 2))
            dxy = wt[6] * _box(P(4, 4), P(1, 4), P(4, 1), P(1, 1))
            dxy = dxy + wt[7] * _box(P(4, 8), P(1, 8), P(4, 5), P(1, 5))
            dxy = dxy + wt[8] * _box(P(8, 4), P(5, 4), P(8, 1), P(5, 1))
            dxy = dxy + wt[9] * _box(P(8, 8), P(5, 8), P(8, 5), P(5, 5))
            det = dxx * dyy - (F(0.81) * dxy) * dxy
            xd = (x0 + np.arange(nx)) * step
            tile[va:vb] = np.where((xd >= half) & (xd <= w - (size - half)), det, -np.inf)
        out = _plane(flat, p, band, y0, ny, x0, nx)
        assert np.isnan(out).all()  # each output once
        out[:] = tile
    assert not np.isnan(flat).any()
    sizes = [int(np.prod(s)) for s in shapes]
    return [v.reshape(s) for v, s in zip(np.split(flat, np.cumsum(sizes)[:-1]), shapes)]


def haar_emulated(ii, cfg):
    b, h, w = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    table, n_tiles, _ = cuda_surf._haar_plan(cfg.n_octaves, cfg.n_octave_layers, b, h, w)
    parts = _parts(table)
    q = len(parts)
    hx = np.full(b * q * h * w, np.nan, F)
    hy, tr = hx.copy(), hx.copy()
    tiles = list(_tiles(parts, b))
    assert len(tiles) == n_tiles
    for s, band, y0, x0, ny, nx in tiles:
        p = parts[s]
        S = _stage(ii[band], h, w, 1, p, y0, ny, x0, nx)
        P = _corner_reader(S, p, np.arange(ny), np.arange(nx))
        at = [_plane(m, p, band, y0, ny, x0, nx) for m in (hx, hy, tr)]
        assert np.isnan(at[0]).all()
        at[0][:] = (_box(P(2, 2), P(0, 2), P(2, 1), P(0, 1))
                    - _box(P(2, 1), P(0, 1), P(2, 0), P(0, 0)))
        at[1][:] = (_box(P(2, 2), P(1, 2), P(2, 0), P(1, 0))
                    - _box(P(1, 2), P(0, 2), P(1, 0), P(0, 0)))
        t = _box(P(4, 8), P(3, 8), P(4, 7), P(3, 7))
        t = t + F(-2) * _box(P(5, 8), P(4, 8), P(5, 7), P(4, 7))
        t = t + _box(P(6, 8), P(5, 8), P(6, 7), P(5, 7))
        t = t + _box(P(8, 4), P(7, 4), P(8, 3), P(7, 3))
        t = t + F(-2) * _box(P(8, 5), P(7, 5), P(8, 4), P(7, 4))
        t = t + _box(P(8, 6), P(7, 6), P(8, 5), P(7, 5))
        at[2][:] = np.sign(t)
    assert not np.isnan(hx).any()
    shape = (b, q, h, w)
    return (torch.from_numpy(hx.reshape(shape)).to(torch.bfloat16),
            torch.from_numpy(hy.reshape(shape)).to(torch.bfloat16),
            torch.from_numpy(tr.reshape(shape)).to(torch.int8))


@pytest.fixture
def budget(request, monkeypatch):
    """Run under a given staging budget (small budgets force small tiles
    and split runs), with fresh plans."""
    monkeypatch.setattr(cuda_surf, "STAGE_BYTES", request.param)
    cuda_surf._det_plan.cache_clear()
    cuda_surf._haar_plan.cache_clear()
    yield request.param
    cuda_surf._det_plan.cache_clear()
    cuda_surf._haar_plan.cache_clear()


# (bands, rows, width, n_octaves, staging budget in bytes): edge tiles
# narrower than the tile, bands shorter than the largest filters (whole
# -inf layers), and budgets from the default down to a few KB.
CASES = [
    (1, 40, 70, 2, 48 * 1024),
    (2, 30, 45, 3, 48 * 1024),
    (1, 20, 300, 1, 48 * 1024),
    (1, 70, 90, 2, 8 * 1024),
    (3, 50, 61, 3, 16 * 1024),
    (1, 33, 200, 4, 48 * 1024),
]


def _ii(b, h, w, seed):
    g = np.random.default_rng(seed).uniform(0, 255, (b, h, w)).astype(np.float32)
    return integral.integral_image(torch.from_numpy(g))


@pytest.mark.parametrize("b,h,w,n_octaves,budget", CASES, indirect=["budget"])
def test_det_staging_plan_reproduces_the_plain_version(b, h, w, n_octaves, budget):
    cfg = SurfConfig(n_octaves=n_octaves)
    ii = _ii(b, h, w, seed=h + w)
    got = det_emulated(ii.numpy(), cfg)
    assert len(got) == n_octaves
    for o in range(n_octaves):
        np.testing.assert_array_equal(got[o], cuda_surf.det_octave_plain(ii, o, cfg).numpy())


@pytest.mark.parametrize("b,h,w,n_octaves,budget", CASES, indirect=["budget"])
def test_haar_staging_plan_reproduces_the_plain_version(b, h, w, n_octaves, budget):
    cfg = SurfConfig(n_octaves=n_octaves)
    ii = _ii(b, h, w, seed=h * w)
    for got, want in zip(haar_emulated(ii.numpy(), cfg), cuda_surf.haar_trace_maps_plain(ii, cfg)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("offs,step,t,want", [
    # one residue, gaps within reach: one run of t + extent slots
    ([-4, 0, 4], 1, 8, (((0, -4, 8),), (0, 4, 8), 16)),
    # gaps beyond reach: a run per offset
    ([-4, 0, 4], 1, 2, (((0, -4, 0), (2, 0, 0), (4, 4, 0)), (0, 2, 4), 6)),
    # duplicates share a slot
    ([5, -4, 5], 1, 1, (((0, -4, 0), (1, 5, 0)), (1, 0, 1), 2)),
    # step 8: runs per residue (0 and 5), split where a gap exceeds 8 t
    ([0, 13, 40], 8, 4, (((0, 0, 0), (4, 40, 0), (8, 13, 0)), (0, 8, 4), 12)),
    ([0, 13, 40], 8, 5, (((0, 0, 5), (10, 13, 0)), (0, 10, 5), 15)),
])
def test_lattice_runs_examples(offs, step, t, want):
    assert tuple(cuda_surf.lattice_runs(offs, step, t)) == want


def test_lattice_runs_align_to_16_byte_copies():
    """Aligned runs start at a multiple of 4 (offset and slot) and hold a
    multiple of 4 slots; the offsets keep their places."""
    runs = cuda_surf.lattice_runs([-7, 5, -6], 1, 8, 4)
    assert tuple(runs) == (((0, -8, 2), (12, 4, 1)), (1, 13, 2), 24)


def test_plans_at_the_2k_shapes_fit_the_card():
    """Every layer and scale of the 2K slice (8 bands of 256 x 2048, 4
    octaves) finds a tiling, and two buffers fit an H100 block's 227 KB."""
    table, shapes, n_tiles, smem = cuda_surf._det_plan(4, 5, 8, 256, 2048)
    assert len(table) == 20 and n_tiles >= 132 and smem <= 232448
    assert shapes == tuple((8, 5, 256 >> o, 2048 >> o) for o in range(4))
    table, n_tiles, smem = cuda_surf._haar_plan(4, 3, 8, 256, 2048)
    assert n_tiles >= 132 and smem <= 232448


@pytest.mark.parametrize("w", [3, 4, 61, 2047, 2048])
def test_integral_image_rows_are_aligned(w):
    """integral_image's rows start 16-byte aligned (the layout the kernels
    stage with 16-byte copies); a dense copy of it has the same values
    (the float64 prefix sums rounded once to float32) and is not in that
    layout unless W+1 is a multiple of 4."""
    g = torch.from_numpy(np.random.default_rng(w).uniform(0, 255, (2, 5, w)).astype(np.float32))
    ii = integral.integral_image(g)
    assert ii.shape == (2, 6, w + 1) and ii.stride(2) == 1
    assert ii.stride(1) % integral.ROW_ALIGN == 0 and ii.stride(0) == 6 * ii.stride(1)
    assert integral.is_row_aligned(ii)
    dense = ii.contiguous()
    assert torch.equal(dense[:, 1:, 1:], torch.cumsum(torch.cumsum(g.double(), 1), 2).float())
    assert not dense[:, 0].any() and not dense[:, :, 0].any()
    assert integral.is_row_aligned(dense) == ((w + 1) % integral.ROW_ALIGN == 0)


# The front ends' and the batch's launch shapes: (bands, rows, width,
# octaves). At 512x1024, bands of 128 x 1024 (3 octaves): one pair on the
# parity ladder (8) and on the dense ladder (16), the dense re-run of 2
# pairs (32), a pass of 8, 16, 32 and all 64 pairs of a batch (64,
# 128, 256, 512), and the 7 consecutive pairs of an 8-frame odometry
# batch (56); the ERP front end at 2K: 2 images of 1024 x 2048; the
# cubemap front end at 2K: 2 strips of 600 x 3600 (4 octaves); and every
# shape that the sequence runs (problems.SEQ_RUNS) can launch
# (problems.sequence_launch_shapes: the orbit's bands of 64 x 512 with 2
# octaves, 8 a pair on the parity ladder and 16 on the dense one, the
# 10-keyframe run's bands of 128 x 1024, in passes of 1 to 16 pairs).
_BASE = [(b, 128, 1024, 3) for b in (8, 16, 32, 56, 64, 128, 256, 512)]
_SEQUENCE = sorted({key[:4] for _, cfg, (h, w) in problems.SEQ_RUNS
                    for key in problems.sequence_launch_shapes(cfg, h, w)[0]} - set(_BASE))
LAUNCHES = _BASE + [(2, 1024, 2048, 4), (2, 600, 3600, 4)] + _SEQUENCE


@pytest.mark.parametrize("b,h,w,n_octaves", LAUNCHES)
def test_plans_at_the_batch_and_front_end_shapes(b, h, w, n_octaves):
    """Every layer and scale finds a tiling whose buffers fit an H100
    block, the tiles cover each band's grid, and the (part, band) output
    planes tile the launch's output buffer without overlap, inside K1's
    32-bit offsets."""
    cfg = SurfConfig(n_octaves=n_octaves)
    n_l = cfg.n_octave_layers + 2
    table, shapes, n_tiles, smem = cuda_surf._det_plan(n_octaves, n_l, b, h, w)
    htable, h_tiles, hsmem = cuda_surf._haar_plan(n_octaves, cfg.n_octave_layers, b, h, w)
    assert smem <= 232448 and hsmem <= 232448
    total = sum(int(np.prod(s)) for s in shapes)
    assert total < 2**31 and b * len(htable) * h * w < 2**31
    for parts, tiles, size in ((_parts(table), n_tiles, total),
                               (_parts(htable), h_tiles, b * len(htable) * h * w)):
        first, planes = 0, []
        for p in parts:
            assert p["first"] == first
            first += b * p["nty"] * p["ntx"]
            assert (p["nty"] - 1) * p["ty"] < p["oh"] <= p["nty"] * p["ty"]
            assert (p["ntx"] - 1) * p["tx"] < p["ow"] <= p["ntx"] * p["tx"]
            planes += [(p["out_off"] + band * p["band_stride"], p["oh"] * p["ow"])
                       for band in range(b)]
        assert first == tiles
        planes.sort()
        assert planes[0][0] == 0 and sum(n for _, n in planes) == size
        assert all(a + n == c for (a, n), (c, _) in zip(planes, planes[1:]))


@pytest.mark.parametrize("b,h,w,n_octaves", LAUNCHES)
def test_staging_plans_at_the_batch_and_front_end_shapes(b, h, w, n_octaves, monkeypatch):
    """One band replayed with the tiles its whole launch gives it (the
    tile size grows with the launch's outputs), bit for bit against the
    plain versions."""
    grow = cuda_surf._max_outputs
    monkeypatch.setattr(cuda_surf, "_max_outputs", lambda total: grow(total * b))
    cuda_surf._det_plan.cache_clear()
    cuda_surf._haar_plan.cache_clear()
    try:
        cfg = SurfConfig(n_octaves=n_octaves)
        ii = _ii(1, h, w, seed=h + w)
        for o, got in enumerate(det_emulated(ii.numpy(), cfg)):
            np.testing.assert_array_equal(got, cuda_surf.det_octave_plain(ii, o, cfg).numpy())
        for got, want in zip(haar_emulated(ii.numpy(), cfg), cuda_surf.haar_trace_maps_plain(ii, cfg)):
            assert torch.equal(got, want)
    finally:
        cuda_surf._det_plan.cache_clear()
        cuda_surf._haar_plan.cache_clear()
