"""SRT post-processing router: language → sanitizer chain.

Role parity with reference ``whisperjav/modules/srt_postprocessing.py:92``
(ja/ko/zh → SubtitleSanitizer, en → English cleaner, language-code
normalization).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from whisperjav_tpu_torch.modules.sanitize.sanitizer import (
    SanitizerConfig, SubtitleSanitizer,
)
from whisperjav_tpu_torch.modules.srt import Subtitle

_LANG_ALIASES = {
    "japanese": "ja", "jpn": "ja", "jp": "ja",
    "korean": "ko", "kor": "ko",
    "chinese": "zh", "zho": "zh", "cmn": "zh",
    "english": "en", "eng": "en",
}


def normalize_language(code: str) -> str:
    c = (code or "ja").lower()
    return _LANG_ALIASES.get(c, c)


class SRTPostProcessor:
    def __init__(self, config: SanitizerConfig | None = None,
                 regroup: bool = True, regroup_preset: str = "default"):
        self.config = config or SanitizerConfig()
        self.regroup = regroup
        self.regroup_preset = regroup_preset

    def process(self, subs: Sequence[Subtitle],
                language: str = "ja") -> Tuple[List[Subtitle], Dict]:
        lang = normalize_language(language)
        subs = list(subs)
        regrouped = 0
        if self.regroup and lang == "ja":
            # linguistic regrouping before sanitization (the role the
            # reference's stable-ts regroup + JapanesePostProcessor play)
            from whisperjav_tpu_torch.modules.sanitize.japanese import (
                JapanesePostProcessor,
            )
            before = len(subs)
            subs = JapanesePostProcessor(self.regroup_preset).process(subs)
            regrouped = before - len(subs)
        if lang in ("ja", "ko", "zh"):
            sanitizer = SubtitleSanitizer(lang, self.config)
        else:
            # English chain: same phases, EN phrase DB, looser CPS
            from dataclasses import replace
            cfg = replace(self.config, max_safe_cps=35.0)
            sanitizer = SubtitleSanitizer("en", cfg)
        cleaned, report = sanitizer.process(subs)
        stats = report.to_dict()
        stats["regroup_merges"] = regrouped
        stats["artifacts"] = report.artifacts
        return cleaned, stats
