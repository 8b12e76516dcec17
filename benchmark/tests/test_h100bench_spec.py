"""Every cell, configuration, driver, traffic mix and metric loads by the
name BENCHMARK.json gives it, and the two agree."""

import json

import pytest

from h100bench import spec

BENCHMARK = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
DRIVER_API = ("build", "departures", "warm_up", "file", "serve", "stretch",
              "kept", "judge")


def _driven_by(name):
    return [c for c in BENCHMARK["configs"]
            if spec.config(c["name"])["driver"] == name]


@pytest.mark.parametrize("cell", BENCHMARK["workloads"],
                         ids=lambda c: c["name"])
def test_cell_loads_and_agrees(cell):
    w = spec.workload(cell["name"])
    driver = spec.driver(w["config"]["driver"])
    assert w["name"] == cell["name"]
    assert w["config"]["name"] == cell["config"]
    assert w["chips"] == cell["chips"]
    assert w["why"] == cell["why"]
    assert spec.traffic(cell["traffic"]) == w["traffic"]
    assert w["limits"] and set(w["limits"]) <= set(driver.NUMBERS)
    assert w["limits"].get("departures", 0.0) == 0.0
    assert all(isinstance(v, float) for v in w["limits"].values())
    assert w["control"] in driver.CONTROLS
    assert set(w["program_controls"]) <= set(driver.PROGRAM_CONTROLS)


@pytest.mark.parametrize("cell", [
    w for w in BENCHMARK["workloads"]
    if w["config"] in {c["name"] for c in _driven_by("whisper")}],
    ids=lambda c: c["name"])
def test_whisper_cell_compares_each_stage(cell):
    limits = spec.workload(cell["name"])["limits"]
    assert {"encoder_err", "decoder_gap", "departures"} <= set(limits)


@pytest.mark.parametrize("cfg", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_names_a_driver_that_exists(cfg):
    name = spec.config(cfg["name"])["driver"]
    assert name in spec.names("drivers")
    driver = spec.driver(name)
    assert all(callable(getattr(driver, f)) for f in DRIVER_API)
    assert driver.NUMBERS and isinstance(driver.CONTROLS, tuple)
    assert isinstance(driver.PROGRAM_CONTROLS, tuple)


@pytest.mark.parametrize("cfg", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_loads_and_agrees(cfg):
    c = spec.config(cfg["name"])
    assert c["name"] == cfg["name"]
    assert c["source"] == cfg["source"]
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cfg", _driven_by("whisper"), ids=lambda c: c["name"])
def test_config_loads_at_published_sizes(cfg):
    c = spec.config(cfg["name"])
    assert cfg["reduced"] == c["reduced"] == []
    m, src = c["model"], c["source_config"]
    assert (m["n_mels"], m["d_model"], m["attention_heads"],
            m["encoder_layers"], m["decoder_layers"], m["vocab_size"],
            m["n_audio_ctx"], m["n_text_ctx"]) == (
        src["num_mel_bins"], src["d_model"], src["encoder_attention_heads"],
        src["encoder_layers"], src["decoder_layers"], src["vocab_size"],
        src["max_source_positions"], src["max_target_positions"])
    assert src["encoder_ffn_dim"] == src["decoder_ffn_dim"] == 4 * m["d_model"]


@pytest.mark.parametrize("entry", BENCHMARK["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_loads_and_agrees(entry):
    mod = spec.metric(entry["name"])
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"],
        entry["moves"])
    assert callable(mod.read)
    assert set(entry.get("workloads", [])) <= {
        w["name"] for w in BENCHMARK["workloads"]}


def test_every_file_is_named_in_benchmark_json():
    assert spec.names("workloads") == sorted(
        w["name"] for w in BENCHMARK["workloads"])
    assert spec.names("configs") == sorted(
        c["name"] for c in BENCHMARK["configs"])
    assert spec.names("metrics") == sorted(
        m["name"] for m in BENCHMARK["per_layer"])
    assert set(spec.names("traffic")) == {
        w["traffic"] for w in BENCHMARK["workloads"]}
    assert set(spec.names("drivers")) == {
        spec.config(c["name"])["driver"] for c in BENCHMARK["configs"]}


@pytest.mark.parametrize("kind,name", [
    ("workload", "no-such-cell"), ("config", "no-such-config"),
    ("traffic", "no-such-mix"), ("metric", "no_such_metric"),
    ("driver", "no_such_driver"), ("driver", "no-such-driver")])
def test_unknown_names_raise(kind, name):
    with pytest.raises(KeyError):
        getattr(spec, kind)(name)
