"""The JAX package's sequence test (tests/test_sequence.py), run against
the port with the same frames, the same RANSAC draws (the reference's,
split from its key as its pairwise_odometry splits them, injected) and
the same bounds as its JAX original."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from spherical_bundle_adjuster_tpu.core import rotation as jrot
from spherical_bundle_adjuster_tpu.utils.config import (
    BaConfig, MatchConfig, PipelineConfig, SurfConfig,
)
from spherical_bundle_adjuster_tpu_torch.core import rotation as trot
from spherical_bundle_adjuster_tpu_torch.models import sequence as tseq
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from test_sequence import render_sequence

torch.set_num_threads(1)


def _geodesic_deg(R_est, R_gt):
    cos = (np.trace(R_est.T @ R_gt) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def test_sequence_recovers_rotations():
    cfg = PipelineConfig(
        surf=SurfConfig(max_keypoints=128, n_octaves=2),
        match=MatchConfig(max_matches=256, ratio_thresh=0.6),
        ba=BaConfig(reference_compat=False),
    )
    key = jax.random.PRNGKey(11)
    eulers = np.deg2rad(
        [[0, 0, 0], [1.5, -2.0, 3.0], [3.0, -3.5, 6.0], [4.0, -5.0, 9.0]]
    )
    frames = torch.from_numpy(np.array(render_sequence(eulers, key)))
    m = cfg.match.max_matches
    draws = [np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(
        jax.random.split(k, cfg.ransac.num_trials))) for k in jax.random.split(key, 3)]

    out = tseq.run_sequence(frames, None, tconfig.from_reference(cfg), frontend="band",
                            global_ba=False, gumbel=torch.from_numpy(np.stack(draws)))
    # pairwise odometry rotations should match the incremental GT rotation
    for k in range(3):
        R_prev = np.asarray(jrot.euler_to_matrix(jnp.asarray(eulers[k], jnp.float32)))
        R_next = np.asarray(jrot.euler_to_matrix(jnp.asarray(eulers[k + 1], jnp.float32)))
        R_rel_gt = R_next @ R_prev.T
        R_est = trot.angle_axis_to_matrix(out.pairwise_rot[k]).numpy()
        geo = _geodesic_deg(R_est, R_rel_gt)
        assert geo < 2.0, f"pair {k}: rel rotation off by {geo:.2f} deg"

    # chained pose-graph rotation of the last frame ~ GT cumulative
    R_last_est = trot.angle_axis_to_matrix(out.poses[-1, :3]).numpy()
    R_last_gt = np.asarray(jrot.euler_to_matrix(jnp.asarray(eulers[-1], jnp.float32)))
    geo = _geodesic_deg(R_last_est, R_last_gt)
    assert geo < 4.0, f"final pose rotation drift {geo:.2f} deg"
    assert float(out.pg_costs[-1]) <= float(out.pg_costs[0]) + 1e-6
