"""The JAX package's corrected-mode behaviour tests (tests/test_solver.py),
run against the port with the same data, the same RANSAC draws (the
reference's, injected) and the same bounds as their JAX originals."""

import dataclasses

import numpy as np
import jax
import torch

from spherical_bundle_adjuster_tpu.utils.config import BaConfig, PipelineConfig
from spherical_bundle_adjuster_tpu_torch.core import rotation as trot
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.solver import lm as tlm
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from test_solver import corrupt_matches, geodesic_deg, synth_two_view

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _adjust(b1, b2, valid, cfg, key=jax.random.PRNGKey(1)):
    """The port's adjust_from_matches with the reference's draws for `key`."""
    m = b1.shape[0]
    keys = jax.random.split(key, cfg.ransac.num_trials)
    g = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys)))
    return ttv.adjust_from_matches(_t(b1), _t(b2), _t(valid), None,
                                   tconfig.from_reference(cfg), gumbel=g)


def _err_deg(r, R):
    return geodesic_deg(trot.angle_axis_to_matrix(r).numpy().astype(np.float64), R)


def test_joint_schur_converges():
    """Under 0.5 deg from a perturbed init and a final cost under 1e-4 on
    a noise-free bank (tests/test_solver.py::TestBCD)."""
    b1, b2, valid, R, t, d1, d2 = synth_two_view(n=48, cap=64)
    aa_gt = trot.matrix_to_angle_axis(torch.from_numpy(R.astype(np.float32))).numpy()
    cfg = tconfig.from_reference(BaConfig(reference_compat=False))
    r0 = _t(aa_gt + np.asarray([0.03, -0.02, 0.02], np.float32))
    t0 = _t((t + np.asarray([0.03, -0.03, 0.01])).astype(np.float32))
    d0 = torch.stack([_t(d1), _t(d2)], dim=-1) + 0.3
    r, t_est, d, costs = tlm.solve_joint_schur(_t(b1), _t(b2), d0, r0, t0, _t(valid), cfg,
                                               num_iters=25)
    assert _err_deg(r, R) < 0.5
    assert float(costs[-1]) < 1e-4


class TestJointScaleGauge:
    def test_depths_keep_entry_scale_pure_rotation(self):
        """On a pure rotation the barrier holds the depths above the bound
        (mean > 0.5, under 5% at <= 1e-3) and the pose stays at its exact
        init (< 0.05 deg)."""
        euler = (0.02, np.deg2rad(60.0), -0.01)
        b1, b2, valid, R, _, _, _ = synth_two_view(n=80, cap=128, euler=euler, t=(0, 0, 0))
        cfg = tconfig.from_reference(BaConfig(reference_compat=False))
        d0 = torch.full((128, 2), 1.0)
        r0 = trot.matrix_to_angle_axis(torch.from_numpy(R.astype(np.float32)))
        r, t, d, costs = tlm.solve_joint_schur(_t(b1), _t(b2), d0, r0, torch.zeros(3),
                                               _t(valid), cfg, num_iters=20)
        dv = d[:, 0].numpy()[np.asarray(valid)]
        assert dv.mean() > 0.5, dv.mean()
        assert (dv <= 1e-3).mean() < 0.05, (dv <= 1e-3).mean()
        assert _err_deg(r, R) < 0.05


def test_rejection_improves_corrected_pose():
    """With 12 gross outliers the gates improve the corrected pose, to
    under 0.1 deg."""
    b1, b2, valid, R, t, _, _ = synth_two_view(n=96, cap=128)
    b2c, _ = corrupt_matches(b1, b2, valid, n_bad=12)
    base = BaConfig(reference_compat=False, joint_refine=True)
    errs = {}
    for rej in (False, True):
        cfg = PipelineConfig(ba=dataclasses.replace(base, outlier_reject=rej))
        r, *_ = _adjust(b1, b2c, valid, cfg)
        errs[rej] = _err_deg(r, R)
    assert errs[True] < errs[False]
    assert errs[True] < 0.1, errs


def test_multi_start_recovers_under_heavy_outliers():
    """Multi-start with the gates and the joint polish stays under 0.1 deg
    at 25% gross outliers."""
    b1, b2, valid, R, t, _, _ = synth_two_view(n=96, cap=128)
    b2c, _ = corrupt_matches(b1, b2, valid, n_bad=24)
    cfg = PipelineConfig(ba=BaConfig(reference_compat=False, joint_refine=True,
                                     outlier_reject=True, multi_start=4))
    r, *_ = _adjust(b1, b2c, valid, cfg)
    err = _err_deg(r, R)
    assert err < 0.1, err


def test_corrected_mode_recovers_pure_rotation_pose():
    """A 60-deg near-pure rotation with 10 outliers: the Kabsch start puts
    the corrected pose under 0.1 deg."""
    euler = (0.02, np.deg2rad(60.0), -0.03)
    b1, b2, valid, R, _, _, _ = synth_two_view(n=96, cap=128, euler=euler, t=(0, 0, 0))
    b2c, _ = corrupt_matches(b1, b2, valid, n_bad=10)
    cfg = PipelineConfig(ba=BaConfig(reference_compat=False, joint_refine=True,
                                     outlier_reject=True, multi_start=4))
    r, t_est, d, guess, tel = _adjust(b1, b2c, valid, cfg)
    err = _err_deg(r, R)
    assert err < 0.1, err
    assert bool(tel.rot_dominant)
