"""Port parity: utils/native (the host library built from the repo's
csrc/sba_native.cpp into the port's build/ directory): codecs, the
threaded loader, io through native, and the float64 oracle against the
port's float32 epipolar / lm stages (tests/test_native.py through the
port), plus the port's oracle against the JAX package's binary.

The port never writes under csrc/: the last test checks that
csrc/sba_native.so kept its bytes and mtime."""

import hashlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from spherical_bundle_adjuster_tpu.utils import native as jnative
from spherical_bundle_adjuster_tpu_torch.core import rotation
from spherical_bundle_adjuster_tpu_torch.solver import epipolar, lm
from spherical_bundle_adjuster_tpu_torch.utils import native
from spherical_bundle_adjuster_tpu_torch.utils.config import BaConfig

torch.set_num_threads(1)

TRACKED_SO = Path(__file__).resolve().parent.parent / "csrc" / "sba_native.so"


def _stamp():
    return hashlib.sha256(TRACKED_SO.read_bytes()).hexdigest(), TRACKED_SO.stat().st_mtime_ns


BEFORE = _stamp()  # at import, before this file builds or loads anything

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native library not built: {native.unavailable_reason()}"
)


def synth(n=64, euler=(0.08, -0.12, 0.2), t=(0.2, 0.1, -0.05), seed=0):
    """tests/test_native.synth with the port's euler_to_matrix."""
    rng = np.random.default_rng(seed)
    b1 = rng.normal(size=(n, 3))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    d1 = rng.uniform(2, 6, n)
    R = rotation.euler_to_matrix(torch.tensor(euler, dtype=torch.float32)).numpy().astype(np.float64)
    x2 = (R @ (b1 * d1[:, None]).T).T - np.asarray(t)
    d2 = np.linalg.norm(x2, axis=-1)
    b2 = x2 / d2[:, None]
    return b1, b2, d1, d2, R, np.asarray(t)


def test_library_is_built_into_the_ports_build_dir():
    lib = Path(native._load()._name)
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libsba_native_")
    assert lib.resolve() != TRACKED_SO.resolve()


class TestCodecs:
    def test_png_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
        p = str(tmp_path / "x.png")
        assert native.save_png_native(p, img)
        np.testing.assert_array_equal(native.load_image_native(p), img)
        # the JAX package's binary decodes the port's file to the same pixels
        if jnative.available():
            np.testing.assert_array_equal(jnative.load_image_native(p), img)

    def test_save_takes_a_tensor(self, tmp_path):
        img = torch.from_numpy(np.random.default_rng(4).integers(0, 255, (8, 12, 3), dtype=np.uint8))
        p = str(tmp_path / "t.png")
        assert native.save_png_native(p, img)
        np.testing.assert_array_equal(native.load_image_native(p), img.numpy())

    def test_unreadable_file_gives_none(self, tmp_path):
        p = tmp_path / "bad.png"
        p.write_bytes(b"not an image")
        assert native.load_image_native(str(p)) is None

    def test_loader_prefetch(self, tmp_path):
        rng = np.random.default_rng(2)
        imgs = [rng.integers(0, 255, (16, 24, 3), dtype=np.uint8) for _ in range(6)]
        paths = []
        for i, im in enumerate(imgs):
            p = str(tmp_path / f"{i}.png")
            native.save_png_native(p, im)
            paths.append(p)
        ld = native.NativeImageLoader(paths, n_threads=2)
        seen = dict(ld)
        ld.close()
        assert len(seen) == 6
        for i, im in enumerate(imgs):
            np.testing.assert_array_equal(seen[i], im)

    def test_io_module_uses_native(self, tmp_path, monkeypatch):
        from spherical_bundle_adjuster_tpu_torch.utils import io

        rng = np.random.default_rng(3)
        img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
        p = str(tmp_path / "y.png")
        native.save_png_native(p, img)
        calls = []
        real = native.load_image_native
        monkeypatch.setattr(native, "load_image_native", lambda path: calls.append(path) or real(path))
        np.testing.assert_array_equal(io.load_image(p), img)
        assert calls == [p]


class TestGoldenOracle:
    def test_eight_point_agrees(self):
        """f32 port essential estimation vs the f64 oracle on the same
        sample (tests/test_native.py's bounds: 5e-3 on the valid Euler
        candidates, 1e-3 on the translation axis)."""
        b1, b2, _, _, R, t = synth()
        w = torch.ones(b1.shape[0])
        E = epipolar.essential_from_bearings(torch.tensor(b1, dtype=torch.float32),
                                             torch.tensor(b2, dtype=torch.float32), w)
        r1, r2, tt = epipolar.decompose_essential(E)
        e_port = np.stack([rotation.matrix_to_euler(r1).numpy(),
                           rotation.matrix_to_euler(r2).numpy()])
        e1_o, e2_o, t_o, v1, v2 = native.oracle_eight_point(b1, b2)
        valid_orc = [e for e, v in zip((e1_o, e2_o), (v1, v2)) if v]
        assert valid_orc, "oracle produced no valid candidate"
        for eo in valid_orc:
            best = np.linalg.norm(e_port - eo, axis=-1).min()
            assert best < 5e-3, f"oracle euler {eo} not found in the port's {e_port}"
        assert abs(abs(float(np.dot(tt.numpy(), t_o))) - 1.0) < 1e-3

    def test_bcd_agrees(self):
        """f32 port BCD stages vs the f64 oracle BCD from the same init
        (tests/test_native.py's bounds: 2e-2 rotation, 3e-2 translation)."""
        b1, b2, d1, d2, R, t = synth()
        aa = rotation.matrix_to_angle_axis(torch.tensor(R, dtype=torch.float32)).numpy()
        rot0 = aa.astype(np.float64) + 0.02
        tran0 = t + 0.02
        d0 = np.stack([d1, d2], -1) + 0.2
        rot_o, tran_o, _ = native.oracle_bcd(b1, b2, rot0, tran0, d0, iters=50, compat=False)
        cfg = BaConfig(reference_compat=False)
        valid = torch.ones(b1.shape[0], dtype=torch.bool)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32)
        d_p, _ = lm.solve_depths(f32(b1), f32(b2), f32(d0), f32(rot0), f32(tran0), valid, cfg)
        rot_p, _ = lm.solve_rotation(f32(b1), f32(b2), d_p, f32(rot0), f32(tran0), valid, cfg)
        tran_p, _ = lm.solve_translation(f32(b1), f32(b2), d_p, rot_p, f32(tran0), valid, cfg)
        np.testing.assert_allclose(rot_p.numpy(), rot_o, atol=2e-2)
        np.testing.assert_allclose(tran_p.numpy(), tran_o, atol=3e-2)

    @pytest.mark.parametrize("compat", [True, False])
    def test_oracle_equals_the_reference_binary(self, compat):
        """The port's build of the oracle gives the JAX package's binary's
        numbers on the same float64 inputs (one source), and takes
        tensors as well as arrays."""
        if not jnative.available():
            pytest.skip("the JAX package's native library does not load here")
        b1, b2, d1, d2, R, t = synth(seed=3)
        for a, b in zip(native.oracle_eight_point(torch.from_numpy(b1), b2),
                        jnative.oracle_eight_point(b1, b2)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        d0 = np.stack([d1, d2], -1) + 0.1
        for a, b in zip(native.oracle_bcd(b1, b2, np.zeros(3), t + 0.01, d0, 20, compat),
                        jnative.oracle_bcd(b1, b2, np.zeros(3), t + 0.01, d0, 20, compat)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_tracked_binary_untouched():
    """csrc/sba_native.so has the bytes and mtime it had before this
    file's tests built and ran the port's library."""
    assert _stamp() == BEFORE
