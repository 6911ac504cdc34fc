"""Port parity: the plain version of kernel K3 (top-2 nearest descriptors)
and match_descriptors, against the Pallas kernel in interpret mode and
the reference's jnp matcher."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.ops import match as jmatch, pallas_match
from spherical_bundle_adjuster_tpu.utils.config import MatchConfig
from spherical_bundle_adjuster_tpu_torch.ops import cuda_match, match as tmatch
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)


def _banks(rng, k1, k2, p_invalid):
    d1 = rng.normal(size=(k1, 64)).astype(np.float32)
    d2 = rng.normal(size=(k2, 64)).astype(np.float32)
    valid2 = rng.random(k2) > p_invalid
    return d1, d2, valid2


def _jnp_top2(d1, d2, valid2):
    dist2 = jnp.sum((d1[:, None, :] - d2[None, :, :]) ** 2, axis=-1)
    dist2 = jnp.where(valid2[None, :], dist2, jnp.inf)
    neg, idx = jax.lax.top_k(-dist2, 2)
    return np.asarray(jnp.sqrt(-neg)), np.asarray(idx)


@pytest.mark.parametrize("k1,k2,p_invalid", [(96, 256, 0.2), (64, 512, 0.1)])
def test_top2_plain_matches_references(k1, k2, p_invalid):
    """Identical indices, distances within 2e-3, against both the Pallas
    kernel (interpret mode) and the jnp top_k path."""
    d1, d2, valid2 = _banks(np.random.default_rng(k1 + k2), k1, k2, p_invalid)
    dist_p, idx_p = pallas_match.top2_distances(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2),
        block_m=32, block_n=64, interpret=True,
    )
    dist_r, idx_r = _jnp_top2(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2))
    dist_t, idx_t = cuda_match.top2_distances(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(valid2)
    )
    assert idx_t.dtype == torch.int32
    for dist_ref, idx_ref in ((np.asarray(dist_p), np.asarray(idx_p)), (dist_r, idx_r)):
        np.testing.assert_array_equal(idx_t.numpy(), idx_ref)
        np.testing.assert_allclose(dist_t.numpy(), dist_ref, atol=2e-3)


def test_top2_all_invalid():
    d1, d2, _ = _banks(np.random.default_rng(1), 32, 64, 0.0)
    valid2 = np.zeros(64, bool)
    dist_p, _ = pallas_match.top2_distances(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2),
        block_m=32, block_n=64, interpret=True,
    )
    dist_t, idx_t = cuda_match.top2_distances(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(valid2)
    )
    assert np.isinf(np.asarray(dist_p)).all()
    assert torch.isinf(dist_t).all()
    assert (idx_t[:, 0] == 0).all()


@pytest.mark.parametrize("j", [0, 37, 100])
def test_top2_single_valid_row(j):
    """One valid train row: the winner and both distances (the second is
    inf) agree with both references. The second index is unspecified when
    its distance is inf; the references disagree on it too (the Pallas
    kernel gives 0, 37, 0 for j = 0, 37, 100, lax.top_k 1, 0, 0), and
    match_descriptors rejects such a query either way."""
    d1, d2, _ = _banks(np.random.default_rng(3), 32, 128, 0.0)
    valid2 = np.zeros(128, bool)
    valid2[j] = True
    dist_p, idx_p = pallas_match.top2_distances(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2),
        block_m=32, block_n=64, interpret=True,
    )
    dist_r, idx_r = _jnp_top2(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2))
    dist_t, idx_t = cuda_match.top2_distances(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(valid2)
    )
    assert (idx_t[:, 0] == j).all()
    assert torch.isinf(dist_t[:, 1]).all()
    for dist_ref, idx_ref in ((np.asarray(dist_p), np.asarray(idx_p)), (dist_r, idx_r)):
        np.testing.assert_array_equal(idx_t[:, 0].numpy(), idx_ref[:, 0])
        np.testing.assert_allclose(dist_t.numpy(), dist_ref, atol=2e-3)
    valid1 = np.ones(32, bool)
    mt = tmatch.match_descriptors(torch.from_numpy(d1), torch.from_numpy(valid1),
                                  torch.from_numpy(d2), torch.from_numpy(valid2),
                                  tconfig.from_reference(MatchConfig()))
    mj = jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(valid1), jnp.asarray(d2),
                                  jnp.asarray(valid2), MatchConfig())
    assert int(mt.count) == int(mj.count) == 0


def test_top2_ties_go_to_lower_index():
    d1 = np.zeros((4, 64), np.float32)
    d1[:, 0] = 1.0
    d2 = np.zeros((6, 64), np.float32)
    d2[[1, 3, 4], 0] = 1.0  # three exact duplicates of every query
    dist, idx = cuda_match.top2_distances(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.ones(6, dtype=torch.bool)
    )
    assert (idx[:, 0] == 1).all() and (idx[:, 1] == 3).all()
    assert (dist == 0).all()


def _planted_banks(seed, k1=200, k2=256):
    """Unit descriptors where a subset of queries has a noisy twin in the
    train bank, so the ratio test passes for them and fails elsewhere."""
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(k2, 64))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    src = rng.permutation(k2)[:k1]
    d1 = d2[src] + rng.normal(scale=np.where(rng.random(k1) < 0.5, 0.05, 2.0)[:, None], size=(k1, 64))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    valid1 = rng.random(k1) > 0.1
    valid2 = rng.random(k2) > 0.1
    return d1.astype(np.float32), valid1, d2.astype(np.float32), valid2


@pytest.mark.parametrize("max_matches,ratio", [(128, 0.5), (512, 0.8)])
def test_match_descriptors_parity(max_matches, ratio):
    """Identical (query, train) pairs, in the same packed order."""
    d1, v1, d2, v2 = _planted_banks(max_matches)
    cfg = MatchConfig(max_matches=max_matches, ratio_thresh=ratio)
    mj = jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                                  jnp.asarray(v2), cfg)
    mt = tmatch.match_descriptors(torch.from_numpy(d1), torch.from_numpy(v1),
                                  torch.from_numpy(d2), torch.from_numpy(v2),
                                  tconfig.from_reference(cfg))
    n = int(mj.count)
    assert n > 20 and int(mt.count) == n
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(mt.query_idx.numpy(), np.asarray(mj.query_idx))
    np.testing.assert_array_equal(mt.train_idx.numpy(), np.asarray(mj.train_idx))
    np.testing.assert_allclose(mt.distance.numpy(), np.asarray(mj.distance), atol=2e-3)


@pytest.mark.parametrize("seed,max_matches,ratio", [(128, 128, 0.5), (7, 512, 0.95)])
def test_mutual_check_parity(seed, max_matches, ratio):
    """The back-match over the dense matrix: identical (query, train) pairs
    in the same packed order; at ratio 0.95 it drops one-way matches."""
    d1, v1, d2, v2 = _planted_banks(seed)
    counts = []
    for mutual in (False, True):
        cfg = MatchConfig(max_matches=max_matches, ratio_thresh=ratio, mutual_check=mutual)
        mj = jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                                      jnp.asarray(v2), cfg)
        mt = tmatch.match_descriptors(torch.from_numpy(d1), torch.from_numpy(v1),
                                      torch.from_numpy(d2), torch.from_numpy(v2),
                                      tconfig.from_reference(cfg))
        np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
        np.testing.assert_array_equal(mt.query_idx.numpy(), np.asarray(mj.query_idx))
        np.testing.assert_array_equal(mt.train_idx.numpy(), np.asarray(mj.train_idx))
        np.testing.assert_allclose(mt.distance.numpy(), np.asarray(mj.distance), atol=2e-3)
        counts.append(int(mt.count))
    assert counts[1] > 20 and counts[1] <= counts[0]
    assert (counts[1] < counts[0]) == (ratio > 0.9)


def test_top2_cuda_wrapper_rejects_cpu_tensors():
    d1, d2, v2 = _banks(np.random.default_rng(2), 8, 8, 0.0)
    with pytest.raises(ValueError):
        cuda_match.top2_distances_cuda(torch.from_numpy(d1), torch.from_numpy(d2),
                                       torch.from_numpy(v2))
    assert cuda_match.TOP2.launches == 0
