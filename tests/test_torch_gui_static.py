"""Static integrity checks of the port's GUI page
(``whisperjav_tpu_torch/gui/app_page.py``): the checks of
``tests/test_gui_static.py`` applied to it (delimiters, DOM ids, routes
served by the port's server, schema keys, escapes), and the same DOM ids
and ``fetch`` routes as the JAX page."""

import inspect
import re

from whisperjav_tpu.gui import app_page as japp
from whisperjav_tpu.gui import server as jserver
from whisperjav_tpu_torch.gui import server
from whisperjav_tpu_torch.gui.app_page import APP_HTML


def _split_page(page=APP_HTML):
    m = re.search(r"<script>(.*)</script>", page, re.S)
    assert m, "no <script> block in APP_HTML"
    return page[: m.start()] + page[m.end():], m.group(1)


def _strip_js(js: str) -> str:
    """Remove string literals, template strings, and comments so
    delimiter counting sees only code."""
    out = []
    i, n = 0, len(js)
    while i < n:
        c = js[i]
        if c in "'\"`":
            q = c
            i += 1
            while i < n and js[i] != q:
                i += 2 if js[i] == "\\" else 1
            i += 1
            out.append("''")
        elif js.startswith("//", i):
            while i < n and js[i] != "\n":
                i += 1
        elif js.startswith("/*", i):
            j = js.find("*/", i + 2)
            i = n if j < 0 else j + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _js_strings(js: str):
    return [m.group(2) for m in
            re.finditer(r"""(['"])((?:\\.|(?!\1).)*)\1""", js)]


def _called_routes(js: str) -> set:
    called = set()
    for s in _js_strings(js):
        m = re.match(r"(/api/[a-z_]+)", s)
        if m:
            called.add(m.group(1))
    return called


def _served_routes(module) -> set:
    return set(re.findall(r'url\.path == "(/api/[^"]+)"',
                          inspect.getsource(module)))


def test_js_delimiters_balanced():
    code = _strip_js(_split_page()[1])
    for o, c in ("()", "[]", "{}"):
        assert code.count(o) == code.count(c), f"unbalanced {o}{c}"


def test_dom_id_references_resolve():
    html, js = _split_page()
    static_ids = set(re.findall(r'id="([^"]+)"', html))
    dynamic_ids = {"adv_vad", "adv_scene", "adv_enhancer"}
    refs = set(re.findall(r"\$\('([^']+)'\)", js))
    for lst in re.findall(r"for \(const k of \[([^\]]+)\]", js):
        refs.update(re.findall(r"'([^']+)'", lst))
    assert refs
    for ref in sorted(refs):
        assert ref in static_ids or ref in dynamic_ids \
            or ref.startswith("advf_"), f"JS references missing id {ref!r}"
    for sel_id in re.findall(r"\['(\w+)', '\w+', '\w+_args'\]", js):
        assert sel_id in static_ids, f"ADV select id {sel_id!r} missing"


def test_fetch_routes_served():
    served = _served_routes(server)
    called = _called_routes(_split_page()[1])
    assert served and called
    assert called <= served, sorted(called - served)


def test_schema_fill_keys_exist_in_schema_payload():
    """Every ``s.<key>`` the page reads is a key of the port's
    ``schema()``."""
    keys = set(server.schema())
    _, js = _split_page()
    read = set(re.findall(r"(?<![\w.$])s\.(\w+)", js))
    assert read and read <= keys, sorted(read - keys)


def test_no_python_escape_artifacts():
    for s in _js_strings(_split_page()[1]):
        assert "\n" not in s, f"JS string literal holds a raw newline: {s!r}"


def test_same_ids_and_routes_as_the_jax_page():
    html, js = _split_page()
    jhtml, jjs = _split_page(japp.APP_HTML)
    assert re.findall(r'id="([^"]+)"', html) == re.findall(
        r'id="([^"]+)"', jhtml)
    assert re.findall(r"\$\('([^']+)'\)", js) == re.findall(
        r"\$\('([^']+)'\)", jjs)
    assert _called_routes(js) == _called_routes(jjs)
    assert _served_routes(server) == _served_routes(jserver)
    # the script is the JAX page's, character for character
    assert js == jjs
