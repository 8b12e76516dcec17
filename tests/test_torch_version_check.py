"""The port's update checker (``whisperjav_tpu_torch/utils/
version_check.py``, ``whisperjav-torch-upgrade``) against the JAX
package's on the same release answers. The port's release poll is the
injected ``fetch``; the JAX module's ``urllib.request.urlopen`` is
replaced. No test reaches the network: the one real poll goes to a proxy
on a closed local port."""

import io
import json
import socket
import sys
import threading
import time
import urllib.error

import pytest

from whisperjav_tpu.utils import version_check as jvc
from whisperjav_tpu_torch.utils import version_check as pvc


@pytest.mark.parametrize("tag", [
    "v1.3.0rc1", "1.2.9", "v1.3.0", "0.1.0", "v0.1.0", "v2.0", "2",
    "v1.10.0b2", "1.2.3.4", "v1.3.0-beta.1", "release", "", " v0.2.0 ",
    "v1.2.x", "1..2", "v10.0.0.dev3"])
def test_parse_version_parity(tag):
    assert pvc.parse_version(tag) == jvc.parse_version(tag)


def test_parse_version_orders_prereleases():
    assert pvc.parse_version("v1.3.0rc1") == (1, 3, 0)
    assert pvc.parse_version("1.2.9") < pvc.parse_version("v1.3.0")


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# release answers: (name, JSON body or None for offline)
RELEASES = [
    ("offline", None),
    ("newer", {"tag_name": "v99.0.0", "html_url": "https://example/r"}),
    ("up-to-date", {"tag_name": "v0.1.0", "html_url": "https://example/s"}),
    ("older", {"tag_name": "v0.0.9"}),
    ("prerelease", {"tag_name": "v0.2.0rc1"}),
    ("unparseable", {"tag_name": "nightly"}),
    ("no-tag", {}),
]


def _patch_jax(monkeypatch, body):
    def urlopen(url, timeout=None):
        assert url == jvc.RELEASES_URL
        if body is None:
            raise urllib.error.URLError("offline")
        return _Response(json.dumps(body).encode())
    monkeypatch.setattr(jvc.urllib.request, "urlopen", urlopen)


def _fetch(body):
    def fetch(timeout):
        if body is None:
            raise urllib.error.URLError("offline")
        return body
    return fetch


def test_release_url_is_the_jax_packages():
    assert pvc.RELEASES_URL == jvc.RELEASES_URL


@pytest.mark.parametrize("name,body", RELEASES, ids=[r[0] for r in RELEASES])
def test_check_latest_version_parity(monkeypatch, name, body):
    _patch_jax(monkeypatch, body)
    want = jvc.check_latest_version(timeout=0.5)
    assert pvc.check_latest_version(timeout=0.5, fetch=_fetch(body)) == want
    assert (want is None) == (name in ("offline", "unparseable", "no-tag"))


@pytest.mark.parametrize("argv", [[], ["--dry-run"], ["--run"]],
                         ids=["check", "dry-run", "run"])
@pytest.mark.parametrize("name,body", RELEASES[:3],
                         ids=[r[0] for r in RELEASES[:3]])
def test_upgrade_main_parity(monkeypatch, capsys, name, body, argv):
    """The same output, exit code and pip calls for each release answer
    and each flag (pip itself is replaced by a recorder)."""
    results = []
    for module in (jvc, pvc):
        calls = []
        monkeypatch.setattr(module, "run_pip_upgrade",
                            lambda dry_run=False, calls=calls:
                            calls.append(dry_run) or 0)
        if module is jvc:
            _patch_jax(monkeypatch, body)
            rc = jvc.upgrade_main(list(argv))
        else:
            rc = pvc.upgrade_main(list(argv), fetch=_fetch(body))
        results.append((rc, capsys.readouterr().out, calls))
    assert results[0] == results[1]
    if name == "offline" and not argv:
        assert "update check unavailable (offline)" in results[1][1]
        assert results[1][2] == []


def test_dry_run_pip_command_parity(capsys):
    assert jvc.run_pip_upgrade(dry_run=True) == 0
    want = capsys.readouterr().out
    assert pvc.run_pip_upgrade(dry_run=True) == 0
    assert capsys.readouterr().out == want
    assert want == (f"would run: {sys.executable} -m pip install --upgrade "
                    "whisperjav-tpu\n")


def _closed_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_real_poll_offline_returns_none(monkeypatch, capsys):
    """The default fetch, sent to a proxy on a closed local port (so no
    outside host is contacted), fails: None, and the upgrade entry point
    prints the offline line and exits 0."""
    proxy = f"http://127.0.0.1:{_closed_port()}"
    for var in ("https_proxy", "HTTPS_PROXY"):
        monkeypatch.setenv(var, proxy)
    for var in ("no_proxy", "NO_PROXY"):
        monkeypatch.delenv(var, raising=False)
    assert pvc.check_latest_version(timeout=2.0) is None
    assert pvc.upgrade_main([]) == 0
    assert capsys.readouterr().out == (
        "whisperjav-tpu 0.1.0 — update check unavailable (offline)\n")


def test_a_hanging_poll_returns_none_within_the_timeout():
    """A fetch that never answers (a name lookup that hangs) leaves the
    check after ``timeout`` with None."""
    release = threading.Event()

    def hang(timeout):
        release.wait(60)
        return {"tag_name": "v99.0.0"}
    t0 = time.monotonic()
    try:
        assert pvc.check_latest_version(timeout=0.2, fetch=hang) is None
    finally:
        release.set()
    assert time.monotonic() - t0 < 30
