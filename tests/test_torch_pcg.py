"""Port parity: the unrolled Cholesky (core/smallmat) and the PCG solver
with its block-Jacobi preconditioner (solver/pcg), against the JAX
package on the same seeded inputs; and the global solvers' LM loops,
which read nothing on the host per GN step but the PCG's stop test."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode

from spherical_bundle_adjuster_tpu.core import smallmat as jsm
from spherical_bundle_adjuster_tpu.solver import pcg as jpcg
from spherical_bundle_adjuster_tpu_torch.core import smallmat as tsm
from spherical_bundle_adjuster_tpu_torch.solver import pcg as tpcg

torch.set_num_threads(1)


def _spd_blocks(rng, n, batch=7, cond=1e3):
    """(batch, n, n) SPD blocks with eigenvalues spread over `cond`."""
    q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    ev = np.geomspace(1.0, cond, n) * rng.uniform(0.5, 2.0, (batch, 1))
    return np.einsum("bij,bj,bkj->bik", q, ev, q).astype(np.float32)


@pytest.mark.parametrize("n", [6, 9])
def test_cholesky_unrolled_parity(n):
    """Factor and solve within float32 rounding of the JAX package's
    (rtol 1e-5 of the largest entry), and of torch.linalg.cholesky."""
    rng = np.random.default_rng(n)
    A = _spd_blocks(rng, n)
    b = rng.normal(size=(A.shape[0], n)).astype(np.float32)
    L = tsm.cholesky_unrolled(torch.from_numpy(A))
    Lj = np.asarray(jsm.cholesky_unrolled(jnp.asarray(A)))
    scale = np.abs(Lj).max()
    np.testing.assert_allclose(L.numpy(), Lj, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(L.numpy(), torch.linalg.cholesky(torch.from_numpy(A)).numpy(),
                               rtol=0, atol=1e-5 * scale)
    x = tsm.cholesky_solve_unrolled(L, torch.from_numpy(b)).numpy()
    xj = np.asarray(jsm.cholesky_solve_unrolled(jnp.asarray(Lj), jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-4 * np.abs(xj).max())
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x), b, rtol=0, atol=1e-3 * np.abs(b).max())


def test_cholesky_unrolled_keeps_the_pivot_clamp():
    """A block that is not positive definite gives the same finite factor
    in both packages (pivots clamped to 1e-30), where cholesky_ex fails."""
    A = np.eye(6, dtype=np.float32)[None].repeat(2, 0)
    A[0, 2, 2] = -1.0   # negative pivot
    A[1, 4, 4] = 0.0    # zero pivot
    L = tsm.cholesky_unrolled(torch.from_numpy(A)).numpy()
    Lj = np.asarray(jsm.cholesky_unrolled(jnp.asarray(A)))
    assert np.isfinite(L).all()
    np.testing.assert_array_equal(L, Lj)
    assert L[0, 2, 2] == np.float32(np.sqrt(np.float32(1e-30)))
    assert (torch.linalg.cholesky_ex(torch.from_numpy(A)).info > 0).all()


def _system(seed, n_blocks=12, bdim=6):
    """A seeded SPD system of n_blocks coupled (bdim, bdim) blocks, A =
    M M^T + diag, and its diagonal blocks."""
    rng = np.random.default_rng(seed)
    n = n_blocks * bdim
    M = rng.normal(size=(n, n // 2)) / np.sqrt(n)
    A = (M @ M.T + np.diag(rng.uniform(0.05, 5.0, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    blocks = np.stack([A[i * bdim:(i + 1) * bdim, i * bdim:(i + 1) * bdim] for i in range(n_blocks)])
    return A, b, blocks


def _run_both(A, b, blocks, precond, max_iters, tol):
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    Aj = jnp.asarray(A)
    pt = tpcg.block_jacobi_precond(torch.from_numpy(blocks)) if precond else None
    pj = jpcg.block_jacobi_precond(jnp.asarray(blocks)) if precond else None
    rt = tpcg.pcg(lambda x: At @ x, bt, pt, max_iters=max_iters, tol=tol)
    rj = jpcg.pcg(lambda x: jnp.dot(Aj, x, precision="highest"), jnp.asarray(b), pj,
                  max_iters=max_iters, tol=tol)
    return rt, rj


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "block_jacobi"])
@pytest.mark.parametrize("max_iters,tol", [(200, 1e-4), (5, 1e-12), (40, 1e-6)],
                         ids=["past_convergence", "cut_at_max_iters", "to_tol"])
def test_pcg_parity(precond, max_iters, tol):
    """x within 1e-4 (relative to |x|), the same number of applied
    iterations, rel_residual within 1e-3 relative (or 1e-7)."""
    A, b, blocks = _system(seed=1)
    rt, rj = _run_both(A, b, blocks, precond, max_iters, tol)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-4 * np.abs(xj).max())
    assert int(rt.iters) == int(rj.iters)
    np.testing.assert_allclose(float(rt.rel_residual), float(rj.rel_residual), rtol=1e-3, atol=1e-7)
    if max_iters == 5:
        assert int(rt.iters) == 5
    else:
        assert int(rt.iters) < max_iters and float(rt.rel_residual) <= tol


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "block_jacobi"])
def test_pcg_freezes_x_at_convergence(precond):
    """The while_loop's semantics: running past convergence applies no
    further iteration, so x and iters equal those of a run whose
    max_iters stops exactly there (bit for bit), whatever the host's
    check interval."""
    A, b, blocks = _system(seed=2)
    pt = tpcg.block_jacobi_precond(torch.from_numpy(blocks)) if precond else None
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    done = tpcg.pcg(lambda x: At @ x, bt, pt, max_iters=300, tol=1e-5)
    k = int(done.iters)
    assert 0 < k < 300 and k % tpcg.CHECK_EVERY != 0
    exact = tpcg.pcg(lambda x: At @ x, bt, pt, max_iters=k, tol=1e-5)
    assert int(exact.iters) == k
    assert torch.equal(exact.x, done.x) and torch.equal(exact.rel_residual, done.rel_residual)
    short = tpcg.pcg(lambda x: At @ x, bt, pt, max_iters=k - 1, tol=1e-5)
    assert int(short.iters) == k - 1 and not torch.equal(short.x, done.x)


def test_pcg_zero_rhs_runs_no_iteration():
    """b = 0: the stop test holds before the first iteration."""
    A, _, blocks = _system(seed=3)
    At = torch.from_numpy(A)
    out = tpcg.pcg(lambda x: At @ x, torch.zeros(A.shape[0]), max_iters=50)
    assert int(out.iters) == 0 and not out.x.any()


def test_block_jacobi_precond_parity():
    """M^-1 r within float32 rounding of the reference's unrolled
    substitutions (per block, atol 1e-5 of the block's max |M^-1 r|; the
    blocks' condition numbers reach 1e4), for (N*B,) and (N, B) inputs,
    with a block that is not positive definite kept finite."""
    rng = np.random.default_rng(4)
    blocks = _spd_blocks(rng, 6, batch=10, cond=1e4)
    blocks[3] = np.diag([1.0, 1.0, -2.0, 1.0, 1.0, 1.0]).astype(np.float32)
    r = rng.normal(size=(10, 6)).astype(np.float32)
    pt = tpcg.block_jacobi_precond(torch.from_numpy(blocks))
    pj = jpcg.block_jacobi_precond(jnp.asarray(blocks))
    want = np.asarray(pj(jnp.asarray(r)))
    assert np.isfinite(want).all()
    for shape in [(60,), (10, 6)]:
        got = pt(torch.from_numpy(r).reshape(shape))
        assert got.shape == shape
        gap = np.abs(got.reshape(10, 6).numpy() - want)
        assert (gap <= 1e-5 * np.abs(want).max(-1, keepdims=True)).all(), gap.max(-1)


class _HostReads(TorchFunctionMode):
    """Counts the torch calls that read a tensor's value on the host."""

    READS = {"__bool__", "__float__", "__int__", "item", "tolist", "numpy", "cpu"}

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.reads += getattr(func, "__name__", "") in self.READS
        return func(*args, **(kwargs or {}))


def _solver(kind, solver_kw):
    from spherical_bundle_adjuster_tpu_torch.models import multiview
    from spherical_bundle_adjuster_tpu_torch.solver import pose_graph
    import chip_smoke

    if kind == "multiview":
        fields, _ = chip_smoke.synth_multiview(8, 64, 4, 0.05, 0)
        prob = multiview.problem_from_numpy(fields, "cpu")
        return lambda n: multiview.solve_multiview(prob, num_iters=n, **solver_kw)
    fields, _ = chip_smoke.synth_pose_graph(30, 3, 0)
    g = pose_graph.graph_from_numpy(fields, "cpu")
    return lambda n: pose_graph.optimize_pose_graph(g, num_iters=n, **solver_kw)


@pytest.mark.parametrize("kind", ["multiview", "pose_graph"])
@pytest.mark.parametrize("linear_solver", ["dense", "pcg"])
def test_lm_loops_read_nothing_on_the_host_per_iteration(kind, linear_solver):
    """The LM loops decide on the device: with the dense solver a solve
    reads no value on the host at 2 GN steps nor at 6 (the segment
    orders are built on the device); with PCG each GN step adds only the PCG's stop
    test reads, at most ceil(cg_iters / CHECK_EVERY) of them."""
    cg_iters = 40
    solve = _solver(kind, dict(linear_solver=linear_solver, cg_iters=cg_iters))
    counts = []
    for n in (2, 6):
        with _HostReads() as mode:
            solve(n)
        counts.append(mode.reads)
    per_step = (counts[1] - counts[0]) / 4
    if linear_solver == "dense":
        assert counts == [0, 0], counts
    else:
        assert 0 < per_step <= -(-cg_iters // tpcg.CHECK_EVERY), counts
