"""The reader of encode_banded_share.viewer on hand-made frame_timings()
records: the share of the window's published frames whose PNG was
deflated in more than one band, and None where the records carry no
encode_bands (a server that does not band its encode)."""

import pytest

from bhbench import harness

NAME = "encode_banded_share.viewer"


def _read(rows):
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    run.data["frame_timings"] = rows
    return harness.reader(NAME)(run)


@pytest.mark.parametrize("bands,share", [
    ([8, 8, 4, 2], 100.0),
    ([8, 1, 4, 1], 50.0),
    ([1, 1, 1], 0.0),
])
def test_share_of_frames_deflated_in_bands(bands, share):
    rows = [{"seq": i + 1, "encode_ms": 5.0, "encode_bands": b}
            for i, b in enumerate(bands)]
    assert _read(rows) == share


def test_none_without_the_field():
    assert _read([{"seq": 1, "encode_ms": 30.0},
                  {"seq": 2, "encode_ms": 29.0}]) is None
    assert _read([]) is None
    run = harness.Run("x", {}, {}, 1, 1.0, True, None, 0.0)
    assert harness.reader(NAME)(run) is None
    per_layer = {m["name"]: m for m in harness.manifest()["per_layer"]}
    assert per_layer[NAME]["workloads"] == ["viewer_drag",
                                            "viewer_drag_particles"]
