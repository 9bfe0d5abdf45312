"""benchmarks/artifacts.py: CPU runs never write an artifact, and the
breakdown compression every artifact shares."""

from benchmarks import artifacts


def test_write_artifact_refuses_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(artifacts, "RESULTS_DIR", str(tmp_path / "results"))
    assert artifacts.write_artifact("probe", {"x": 1.0}) is False
    assert not (tmp_path / "results").exists()


def test_clean_breakdown_rounds_and_drops_chunk_lists():
    bd = {"prep_s": 0.123456789, "chunk_dispatch_s": [0.1, 0.2], "n_chunks": 2}
    assert artifacts.clean_breakdown(bd) == {"prep_s": 0.1235, "n_chunks": 2}
