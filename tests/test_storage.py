"""Watermark JSON store tests (reference: examples/main.rs:110-131, 321-344)."""

import json

import numpy as np
import pytest

from spread_spectrum_watermarking_tpu.config import InsertExtract, Method, Ordering
from spread_spectrum_watermarking_tpu.utils import storage


def test_version1_roundtrip(tmp_path):
    st = storage.WatermarkStorage(
        config=storage.Configuration(
            insert_extract=InsertExtract(alpha=0.25, method=Method.OPTION3),
            ordering=Ordering.ENERGY_ORTHOGONAL,
        ),
        watermarks=[
            storage.DescribedWatermark(values=[1.0, -2.5, 0.125], description="abc"),
            storage.DescribedWatermark(values=[0.0], description=""),
        ],
    )
    path = tmp_path / "wm.json"
    storage.save_watermark_file(path, st)
    back = storage.load_watermark_file(path)
    assert back.config == st.config
    assert len(back.watermarks) == 2
    np.testing.assert_array_equal(back.watermarks[0].values, st.watermarks[0].values)
    assert back.watermarks[0].description == "abc"


def test_json_shape_matches_reference_serde():
    # The envelope must be {"Version1": {"config": {...}, "watermarks": [...]}}
    # with serde enum spellings (Option2/Energy), so files interchange with
    # the reference CLI.
    st = storage.WatermarkStorage(
        config=storage.Configuration(),
        watermarks=[storage.DescribedWatermark(values=[1.5], description="d")],
    )
    obj = json.loads(st.to_json())
    assert set(obj) == {"Version1"}
    v1 = obj["Version1"]
    assert v1["config"]["insert_extract"] == {"alpha": 0.1, "method": "Option2"}
    assert v1["config"]["ordering"] == "Energy"
    assert v1["watermarks"] == [{"values": [1.5], "description": "d"}]


def test_legacy_wm_interpretation(tmp_path):
    # Legacy 2013 files map to Option2 + Legacy ordering
    # (reference: examples/main.rs:321-344).
    legacy = {"alpha": 0.3, "length": 3, "version": "legacy", "wm": [0.1, -0.2, 0.3]}
    path = tmp_path / "old.wm"
    path.write_text(json.dumps(legacy))
    st = storage.load_watermark_file(path)
    assert st.config.insert_extract.method == Method.OPTION2
    assert st.config.insert_extract.alpha == pytest.approx(0.3)
    assert st.config.ordering == Ordering.LEGACY
    np.testing.assert_allclose(st.watermarks[0].values, [0.1, -0.2, 0.3])


def test_unknown_version_rejected():
    with pytest.raises(ValueError, match="version"):
        storage.WatermarkStorage.from_json('{"Version2": {}}')


def test_precision_field_roundtrip():
    # The embedding tier is recorded so extraction runs at the same tier
    # (fast-tier rank order is per-tier deterministic); absent -- as in every
    # reference-written file -- means HIGHEST (None here, resolved by the CLI).
    # The spelling carries the fast-tier ranking GENERATION: current builds
    # write "Default2"/"High2" (gather-free ranking, config.RANK_VERSION 2).
    from spread_spectrum_watermarking_tpu.config import RANK_VERSION, Precision

    st = storage.WatermarkStorage(
        config=storage.Configuration(),
        watermarks=[storage.DescribedWatermark(values=[1.0])],
        precision=Precision.DEFAULT,
    )
    obj = json.loads(st.to_json())
    assert obj["Version1"]["precision"] == "Default2"
    back = storage.WatermarkStorage.from_json(st.to_json())
    assert back.precision is Precision.DEFAULT
    assert back.rank_version == RANK_VERSION == 2

    st_hi = storage.WatermarkStorage(
        config=storage.Configuration(),
        watermarks=[storage.DescribedWatermark(values=[1.0])],
    )
    assert "precision" not in json.loads(st_hi.to_json())["Version1"]
    assert storage.WatermarkStorage.from_json(st_hi.to_json()).precision is None


def test_unknown_spellings_rejected_loudly():
    # Forward-compat failure mode (the ops/ranking.py COMPATIBILITY CONTRACT
    # scenario): a file written by a future generation must fail with a
    # ValueError naming the offending spelling and the supported set -- like
    # the reference's serde error (examples/main.rs:363-365) -- not a bare
    # KeyError traceback.
    def envelope(method="Option2", ordering="Energy", precision=None):
        v1 = {"config": {"insert_extract": {"alpha": 0.1, "method": method},
                         "ordering": ordering},
              "watermarks": [{"values": [1.0], "description": ""}]}
        if precision is not None:
            v1["precision"] = precision
        return json.dumps({"Version1": v1})

    with pytest.raises(ValueError, match=r"'Default3'.*High2"):
        storage.WatermarkStorage.from_json(envelope(precision="Default3"))
    with pytest.raises(ValueError, match=r"method 'Option9'.*Option1"):
        storage.WatermarkStorage.from_json(envelope(method="Option9"))
    with pytest.raises(ValueError, match=r"ordering 'Entropy'.*Energy"):
        storage.WatermarkStorage.from_json(envelope(ordering="Entropy"))
    # Non-string garbage must take the same path, not die in sorted()/format.
    with pytest.raises(ValueError, match="ordering"):
        storage.WatermarkStorage.from_json(envelope(ordering=3))


def test_legacy_fast_tier_spelling_maps_to_rank_version_1():
    # "Default"/"High" (written by generation-1 builds, before the
    # gather-free ranking) must read back as rank_version=1 so those marks
    # keep extracting with their original tie/boundary rank order
    # (ops/ranking.py COMPATIBILITY CONTRACT; ADVICE r3 item 1).
    from spread_spectrum_watermarking_tpu.config import Precision

    for spelling, tier in (("Default", Precision.DEFAULT),
                           ("High", Precision.HIGH)):
        text = json.dumps({"Version1": {
            "config": {"insert_extract": {"alpha": 0.1, "method": "Option2"},
                       "ordering": "Energy"},
            "watermarks": [{"values": [1.0], "description": ""}],
            "precision": spelling,
        }})
        st = storage.WatermarkStorage.from_json(text)
        assert st.precision is tier
        assert st.rank_version == 1
        # and the legacy pair re-serializes under the legacy spelling
        assert json.loads(st.to_json())["Version1"]["precision"] == spelling
