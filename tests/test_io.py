"""IO format tests (report.txt format identical to ``src/io.rs:21-31``)."""

from ccrs_jax.io import object_from_json, object_to_json, write_report


def test_write_report(tmp_path):
    p = tmp_path / "report.txt"
    write_report(str(p), True, [(0.123456, 0.1), (0.2, 0.25)])
    text = p.read_text()
    assert text == (
        "Calibrate with extrinsics: true\n\n"
        "cam0:\n"
        "    average reprojection error: 0.12346 px\n"
        "    median  reprojection error: 0.10000 px\n\n"
        "cam1:\n"
        "    average reprojection error: 0.20000 px\n"
        "    median  reprojection error: 0.25000 px\n\n"
    )


def test_json_roundtrip(tmp_path):
    p = tmp_path / "x.json"
    obj = {"a": 1, "b": [1.5, 2.5]}
    object_to_json(str(p), obj)
    assert object_from_json(str(p)) == obj


def test_recorder_logs_keyframes(monkeypatch, tmp_path):
    """The /cam{i}/keyframe{j} topics are emitted for the init frames
    (parity with src/util.rs:898-908; r02 verdict #6)."""
    from types import SimpleNamespace

    from ccrs_jax import visualization as viz

    calls = []
    fake = SimpleNamespace(
        init=lambda *a, **k: None,
        save=lambda *a, **k: None,
        log=lambda topic, *a, **k: calls.append(topic),
        set_time=lambda *a, **k: None,
        TextLog=lambda *a, **k: None,
        ViewCoordinates=SimpleNamespace(RDF=None),
    )
    monkeypatch.setattr(viz, "rr", fake)
    monkeypatch.setattr(viz, "HAVE_RERUN", True)
    rec = viz.Recorder(str(tmp_path / "log.rrd"))
    assert rec.active
    rec.log_keyframes(0, [1000, 2000])
    assert "/cam0/keyframe0" in calls and "/cam0/keyframe1" in calls
