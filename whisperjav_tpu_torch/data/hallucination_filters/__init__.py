"""Bundled hallucination filter databases (ported DATA from the
reference — whisperjav/data/hallucination_filters/: filter_list_v08.json
= per-language exact-match phrase lists (3,590 JA / 100 EN / …),
regexp_v09.json = categorized regex patterns with confidence and
aggressiveness metadata). The loader chain lives in
whisperjav_tpu/modules/sanitize/hallucinations.py.
"""

from pathlib import Path

_HERE = Path(__file__).parent

FILTER_LIST_VERSION = "v08"
REGEXP_VERSION = "v09"


def bundled_filter_list_path() -> Path:
    return _HERE / "filter_list_v08.json"


def bundled_regexp_path() -> Path:
    return _HERE / "regexp_v09.json"
