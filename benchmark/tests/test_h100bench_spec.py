"""Every cell, configuration, traffic mix and metric loads by the name
BENCHMARK.json gives it, and the two agree."""

import json

import pytest

import calibrate
from h100bench import check, spec
from reference.whisper import CONTROLS

BENCHMARK = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", BENCHMARK["workloads"],
                         ids=lambda c: c["name"])
def test_cell_loads_and_agrees(cell):
    w = spec.workload(cell["name"])
    assert w["name"] == cell["name"]
    assert w["config"]["name"] == cell["config"]
    assert w["chips"] == cell["chips"]
    assert w["why"] == cell["why"]
    assert spec.traffic(cell["traffic"]) == w["traffic"]
    assert {"encoder_err", "decoder_gap", "departures"} <= set(w["limits"])
    assert set(w["limits"]) <= set(check.NUMBERS)
    assert w["limits"]["departures"] == 0.0
    assert all(isinstance(v, float) for v in w["limits"].values())
    assert w["control"] in CONTROLS
    assert set(w["program_controls"]) <= set(calibrate.PROGRAM_CONTROLS)


@pytest.mark.parametrize("cfg", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_loads_at_published_sizes(cfg):
    c = spec.config(cfg["name"])
    assert c["source"] == cfg["source"]
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
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


def test_every_file_is_named_in_benchmark_json():
    assert spec.names("workloads") == sorted(
        w["name"] for w in BENCHMARK["workloads"])
    assert spec.names("configs") == sorted(
        c["name"] for c in BENCHMARK["configs"])
    assert spec.names("metrics") == sorted(
        m["name"] for m in BENCHMARK["per_layer"])
    assert set(spec.names("traffic")) == {
        w["traffic"] for w in BENCHMARK["workloads"]}


@pytest.mark.parametrize("kind,name", [
    ("workload", "no-such-cell"), ("config", "no-such-config"),
    ("traffic", "no-such-mix"), ("metric", "no_such_metric")])
def test_unknown_names_raise(kind, name):
    with pytest.raises(KeyError):
        getattr(spec, kind)(name)
