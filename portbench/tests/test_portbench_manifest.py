"""The manifest and every file it names, found by name; a cell added by
adding files alone."""
import json
import shutil

import pytest

from portbench import manifest, run


def test_every_name_has_its_file():
    mf = manifest.Manifest()
    names = {c["name"] for c in mf.data["configs"]}
    for w in mf.data["workloads"]:
        assert w["config"] in names
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        mf.config(w["config"])
        mf.traffic(w["traffic"])
        limits = mf.check(w["name"])["limits"]
        assert set(limits) >= set(run.check.NAMES)
    for kind in ("end_to_end", "per_layer"):
        for m in mf.data[kind]:
            assert callable(manifest.reader(m["name"]))


def test_each_cell_reports_what_it_must():
    mf = manifest.Manifest()
    e2e = {m["name"] for m in mf.data["end_to_end"]}
    for w in mf.data["workloads"]:
        mine = {m["name"] for m in mf.metrics(w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        assert mf.metrics(w["name"], True)
        for m in mf.metrics(w["name"], True):
            assert m["moves"] in e2e


def test_config_files_match_their_entries():
    mf = manifest.Manifest()
    for c in mf.data["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        body = mf.config(c["name"])
        assert body["name"] == c["name"]
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains the cell hero.tiny from a new traffic
    file, a new check file and a new entry; no file that was there
    changes, and the cell runs."""
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "hero.tiny", "config": "hero",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    traffic = json.loads((bench / "traffic" / "final-1080p.json")
                         .read_text())
    traffic.update(name="tiny", width=16, height=16, passes_per_update=2)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (bench / "checks" / "hero.tiny.json").write_text(
        (bench / "checks" / "hero.final-1080p.json").read_text())
    mf = manifest.Manifest(tmp_path, bench)
    result = run.run_cell("hero.tiny", 5, 1e9, False, device="cpu",
                          max_updates=3, mf=mf).result
    assert result["correct"]
    assert result["attempted"] == 3
    assert set(result["metrics"]) == {m["name"]
                                      for m in data["end_to_end"]}
    with pytest.raises(KeyError):
        manifest.Manifest().workload("hero.tiny")
