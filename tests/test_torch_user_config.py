"""The port's user config and preset store
(``whisperjav_tpu_torch/config/user_config.py``) against the JAX
package's: the JAX scenario tests run on the port, one call sequence
writes the same file in both, and a file either package wrote is read by
the other."""

import json
import re

import pytest

from whisperjav_tpu.config import user_config as juc
from whisperjav_tpu_torch.config import user_config as puc
from whisperjav_tpu_torch.config.user_config import UserConfigManager


@pytest.fixture
def mgr(tmp_path):
    return UserConfigManager(tmp_path / "config.json")


def test_fresh_config_defaults(mgr):
    assert mgr.list_presets() == []
    assert mgr.get_pref("theme") is None


def test_preferences_persist(tmp_path):
    m1 = UserConfigManager(tmp_path / "c.json")
    m1.set_pref("default_mode", "balanced")
    m2 = UserConfigManager(tmp_path / "c.json")
    assert m2.get_pref("default_mode") == "balanced"


def test_preset_crud(mgr):
    mgr.save_preset("night run", {"mode": "fidelity", "batch_size": 16})
    assert mgr.list_presets() == ["night run"]
    assert mgr.get_preset("night run")["mode"] == "fidelity"
    mgr.rename_preset("night run", "overnight")
    assert mgr.get_preset("night run") is None
    assert mgr.get_preset("overnight")["batch_size"] == 16
    assert mgr.delete_preset("overnight")
    assert not mgr.delete_preset("overnight")


def test_unicode_preset_names(mgr):
    mgr.save_preset("夜間バッチ🌙", {"mode": "qwen"})
    assert "夜間バッチ🌙" in UserConfigManager(mgr.path).list_presets()


def test_invalid_names_rejected(mgr):
    with pytest.raises(ValueError):
        mgr.save_preset("", {})
    with pytest.raises(ValueError):
        mgr.save_preset("   ", {})
    mgr.save_preset("x", {})
    with pytest.raises(ValueError):
        mgr.rename_preset("x", "")
    with pytest.raises(KeyError):
        mgr.rename_preset("missing", "y")


@pytest.mark.parametrize("module", [juc, puc], ids=["jax", "torch"])
@pytest.mark.parametrize("content", ["{not valid json", "[1, 2, 3]",
                                     '{"presets": {}}'])
def test_bad_file_quarantined(tmp_path, module, content):
    """Invalid JSON, a non-object and an object without a schema version
    are each moved to ``*.json.corrupt``; the manager starts fresh and
    can still save."""
    p = tmp_path / "c.json"
    p.write_text(content, encoding="utf-8")
    m = module.UserConfigManager(p)
    assert m.list_presets() == []
    assert m.data["schema_version"] == "1.0"
    assert (tmp_path / "c.json.corrupt").read_text(
        encoding="utf-8") == content
    m.set_pref("a", 1)
    assert json.loads(p.read_text())["preferences"]["a"] == 1


def test_atomic_write_no_partial(mgr):
    mgr.save_preset("p1", {"k": "v"})
    assert [f for f in mgr.path.parent.iterdir() if f.suffix == ".tmp"] == []


def test_export_import(tmp_path, mgr):
    mgr.save_preset("p1", {"mode": "fast"})
    mgr.set_pref("lang", "ja")
    out = mgr.export_to(tmp_path / "export.json")
    other = UserConfigManager(tmp_path / "other.json")
    other.save_preset("p2", {"mode": "qwen"})
    other.import_from(out, merge=True)
    assert set(other.list_presets()) == {"p1", "p2"}
    assert other.get_pref("lang") == "ja"
    other.import_from(out, merge=False)
    assert other.list_presets() == ["p1"]


def test_default_path_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert puc.default_config_path() == juc.default_config_path() \
        == tmp_path / "whisperjav-tpu" / "config.json"
    assert UserConfigManager().path == juc.UserConfigManager().path


def _calls(module, path):
    m = module.UserConfigManager(path)
    m.set_pref("default_mode", "balanced")
    m.save_preset("夜間", {"mode": "fidelity", "batch_size": 16,
                           "vad_args": {"threshold": 0.3}})
    m.save_preset("b", {"ensemble": True})
    m.rename_preset("b", "c")
    m.delete_preset("missing")
    return m


def test_one_call_sequence_writes_the_same_file(tmp_path):
    """The same calls write byte-identical files but for the ``updated``
    time stamp."""
    texts = []
    for module, name in ((juc, "jax.json"), (puc, "torch.json")):
        m = _calls(module, tmp_path / name)
        texts.append(re.sub(r'"updated": "[^"]+"', '"updated": "T"',
                            m.path.read_text(encoding="utf-8")))
    assert texts[0] == texts[1]
    assert '"updated": "T"' in texts[0]


@pytest.mark.parametrize("writer,reader", [(juc, puc), (puc, juc)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_config_cross_reads(tmp_path, monkeypatch, writer, reader):
    """A preset saved through one package's default path (the GUI's) is
    read, renamed and exported by the other's."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    w = _calls(writer, None)
    r = reader.UserConfigManager()
    assert r.path == w.path
    assert r.list_presets() == w.list_presets() == ["c", "夜間"]
    assert r.get_preset("夜間") == w.get_preset("夜間")
    assert r.get_pref("default_mode") == "balanced"
    r.rename_preset("c", "d")
    assert writer.UserConfigManager().list_presets() == ["d", "夜間"]
    out = r.export_to(tmp_path / "export.json")
    back = writer.UserConfigManager(tmp_path / "imported.json")
    back.import_from(out, merge=False)
    assert back.data["presets"] == r.data["presets"]
