"""The port's own config against the reference's: the same field names and
defaults, except exactly the five TPU-only SurfConfig knobs; the same
presets and band ladder; and `from_reference` carrying a config across."""

import dataclasses

import pytest

from spherical_bundle_adjuster_tpu.utils import config as jconfig
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig

TPU_ONLY = {"gather_mode", "mxu_gather_chunk", "topk_mode", "topk_recall", "det_mode"}
CLASSES = ["SurfConfig", "MatchConfig", "FrontendConfig", "RansacConfig", "BaConfig",
           "PipelineConfig"]


def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_the_reference(name):
    ref, port = _fields(getattr(jconfig, name)), _fields(getattr(tconfig, name))
    omitted = TPU_ONLY if name == "SurfConfig" else set()
    assert set(ref) - set(port) == omitted
    assert set(port) <= set(ref)
    for k, v in port.items():
        if dataclasses.is_dataclass(v):  # PipelineConfig's default sub-configs
            want = {f: d for f, d in dataclasses.asdict(ref[k]).items() if f not in TPU_ONLY}
            assert dataclasses.asdict(v) == want, k
        else:
            assert v == ref[k] and type(v) is type(ref[k]), k
    assert dataclasses.is_dataclass(getattr(tconfig, name))
    assert getattr(tconfig, name).__dataclass_params__.frozen


def test_presets_match_the_reference():
    ref, port = jconfig.PipelineConfig(), tconfig.PipelineConfig()
    for preset in ("parity", "quality"):
        assert getattr(port, preset)() == tconfig.from_reference(getattr(ref, preset)())


def test_dense_band_pitches_match_the_reference():
    assert tconfig.DENSE_BAND_PITCHES == jconfig.DENSE_BAND_PITCHES


def test_from_reference_round_trips_a_non_default_config():
    ref = jconfig.PipelineConfig(
        surf=jconfig.SurfConfig(n_octaves=2, max_keypoints=77, upright=True, det_mode="xla",
                                gather_mode="mxu", topk_mode="exact"),
        match=jconfig.MatchConfig(ratio_thresh=0.61, max_matches=99, mutual_check=True),
        frontend=jconfig.FrontendConfig(band_pitches_deg=jconfig.DENSE_BAND_PITCHES,
                                        band_ladder="dense", cube_size=123),
        ransac=jconfig.RansacConfig(num_trials=17, scoring="inlier_count", seed=5),
        ba=jconfig.BaConfig(max_iterations=7, outlier_reject=True, multi_start=3),
        eval_trim_frac=0.25,
    ).quality()
    port = tconfig.from_reference(ref)
    assert isinstance(port, tconfig.PipelineConfig)
    assert isinstance(port.surf, tconfig.SurfConfig)
    want = dataclasses.asdict(ref)
    for k in TPU_ONLY:
        del want["surf"][k]
    assert dataclasses.asdict(port) == want
    # and back: the reference's own class rebuilt from the port's values,
    # the TPU-only knobs taken as given
    back = dataclasses.replace(
        ref, **{k: getattr(ref, k).__class__(**dataclasses.asdict(getattr(port, k)),
                                             **({f: getattr(ref.surf, f) for f in TPU_ONLY}
                                                if k == "surf" else {}))
                for k in ("surf", "match", "frontend", "ransac", "ba")},
    )
    assert back == ref
    assert tconfig.from_reference(ref.surf) == port.surf
    assert tconfig.from_reference(ref.ba, tconfig.BaConfig) == port.ba
