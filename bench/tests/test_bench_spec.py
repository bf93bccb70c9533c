"""BENCHMARK.json against the rules the harness and its contract rely on,
and every configuration, cell and metric found by name -- also ones added
as new files only."""

import json
import re
import shutil

import pytest

from bench import spec
from bench.flops import work

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expand|experts_per_tok")


def test_benchmark_json_holds_the_rules():
    assert spec.problems(BENCH) == []
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert [m["name"] for m in BENCH["end_to_end"]].count("setup_s") == 1


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_with_its_files(cell):
    c = spec.find_cell(cell)
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert c.chips == 1
    assert set(c.limits["limits"]) == (
        {"loss", "grad", "change"} if c.traffic["kind"] == "train"
        else {"gap"})
    for m in c.end_to_end + c.per_layer:
        mod = spec.reader(m.name)
        assert callable(mod.read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_state_their_cuts(entry):
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert not WIDTH.search(key), key
        assert key in cfg and key in cfg["published"]
    for key in ("deployment", "precision", "assumed", "tiny"):
        assert cfg[key]
    assert work.matmul_params(cfg) > 0


def test_names_and_units_keep_to_the_allowed_characters():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME_RE.match(m["name"]), m["name"]
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
    for w in BENCH["workloads"]:
        assert spec.NAME_RE.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\t" not in w["why"]
    bad = dict(BENCH, end_to_end=[dict(BENCH["end_to_end"][0],
                                       unit="tokens per second")])
    assert any("unit" in p for p in spec.problems(bad))
    bad = dict(BENCH, workloads=[dict(BENCH["workloads"][0],
                                      name="a b")] + BENCH["workloads"][1:])
    assert any("workload name" in p for p in spec.problems(bad))


def test_per_layer_metrics_move_one_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", CELLS))
        assert m["unit"] != "%" or "_roofline" in m["name"] \
            or "mfu" in m["name"] or "idle" in m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"step", "model", "device", "optimizer", "blocks",
                           "kernels"}


def test_a_cell_metric_and_configuration_added_as_files_only(tmp_path):
    """A later PR adds a configuration, a traffic mix, a cell and a
    per-layer metric by new files and new entries alone."""
    shutil.copytree(spec.BENCH, tmp_path / "bench")
    new = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(spec.BENCH / "configs" / "granite-3-2b.json")
    cfg["name"] = "granite-3-2b-half"
    cfg["num_hidden_layers"] = 20
    (tmp_path / "bench" / "configs" / "granite-3-2b-half.json").write_text(
        json.dumps(cfg))
    traffic = spec.load_json(spec.BENCH / "traffic" /
                             "train-adamw.2x4096.json")
    traffic["batch"] = 4
    (tmp_path / "bench" / "traffic" / "train-adamw.4x4096.json").write_text(
        json.dumps(traffic))
    cell = "granite-3-2b-half.train-adamw.4x4096"
    (tmp_path / "bench" / "workloads" / f"{cell}.json").write_text(
        json.dumps({"limits": {"loss": 1, "grad": 1, "change": 1}}))
    (tmp_path / "bench" / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['units'])\n")
    new["configs"].append(dict(new["configs"][0], name="granite-3-2b-half",
                               file="bench/configs/granite-3-2b-half.json"))
    new["workloads"].append({"name": cell, "config": "granite-3-2b-half",
                             "traffic": "train-adamw.4x4096", "chips": 1,
                             "why": "a new cell"})
    new["end_to_end"][0]["workloads"].append(cell)
    new["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "step", "moves": "train_tokens_per_s",
                             "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    assert spec.problems(new, tmp_path) == []
    c = spec.find_cell(cell, tmp_path)
    assert c.config["num_hidden_layers"] == 20
    assert c.traffic["batch"] == 4
    assert [m.name for m in c.per_layer][-1] == "steps_seen.train"
    reader = spec.reader("steps_seen.train", tmp_path)
    assert reader.read({"window": {"units": 7}}) == 7.0
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell", tmp_path)


def test_a_traffic_kind_added_as_a_file_only(tmp_path):
    """A later PR adds a traffic kind by a new ``bench/traffic/<kind>.py``
    and a mix naming it; the harness finds both by name."""
    shutil.copytree(spec.BENCH, tmp_path / "bench")
    new = json.loads(json.dumps(BENCH))
    (tmp_path / "bench" / "traffic" / "replay.py").write_text(
        "class Kind:\n    pass\n\n\n"
        "def check_outputs(cfg, traffic, seed, device, outputs, look=None):\n"
        "    return {'same': 0.0}\n\n\n"
        "def control(cfg, traffic, seed, device):\n"
        "    return {'same': 1.0}\n\n\nFAULTS = {}\n")
    (tmp_path / "bench" / "traffic" / "replay.1x64.json").write_text(
        json.dumps({"kind": "replay", "batch": 1, "seq": 64}))
    cell = "granite-3-2b.replay.1x64"
    (tmp_path / "bench" / "workloads" / f"{cell}.json").write_text(
        json.dumps({"limits": {"same": 0.5}}))
    new["workloads"].append({"name": cell, "config": "granite-3-2b",
                             "traffic": "replay.1x64", "chips": 1,
                             "why": "a new kind"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    assert spec.problems(new, tmp_path) == []
    c = spec.find_cell(cell, tmp_path)
    kmod = spec.kind(c.traffic["kind"], tmp_path)
    assert kmod.check_outputs(None, c.traffic, 1, None, {}) == {"same": 0.0}
    assert kmod.control(None, c.traffic, 1, None) == {"same": 1.0}
    (tmp_path / "bench" / "traffic" / "replay.py").unlink()
    assert any("replay.py missing" in p for p in spec.problems(new, tmp_path))
