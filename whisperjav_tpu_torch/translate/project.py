"""Scene/batch translation hierarchy with a persistent project file (the
port's copy of ``whisperjav_tpu/translate/project.py``: the same
``.wjtrans.json`` v2 format, so a project either package wrote resumes in
the other).

Role parity with the PySubtrans layer the reference drives
(reference: whisperjav/translate/core.py:139-420 passes
``scene_threshold``/``max_batch_size`` into PySubtrans and persists a
``.subtrans`` project that resumes per batch, carrying <scene>/<summary>
context between batches; translate/cli.py:293 exposes the 60 s default,
core.py:148 the 120 s API default). Rebuilt without PySubtrans:

* **Scenes** split where the gap between consecutive cues is at least
  ``scene_threshold`` seconds (a scene change in the movie).
* **Batches** inside a scene split recursively at the LARGEST internal
  gap until every batch fits ``max_batch_size`` lines — so batch
  boundaries fall on natural pauses, not mid-conversation.
* **Context** rolls forward: each batch prompt carries the synopsis,
  the summaries of earlier scenes, and the summary of the previous
  batch; the response may end with a ``<summary>...</summary>`` tag
  that is stored and fed to the next batch.
* **Project file** (``.wjtrans.json`` schema v2) records the hierarchy
  and per-batch status/summaries, saved after every batch so an
  interrupted run resumes at batch granularity. Runtime settings
  (provider, batch size, threshold) always come from the CLI, never
  from the stale project file — the reference documents resuming with
  stored settings as a known bug it patches around
  (core.py:349-353).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from whisperjav_tpu_torch.modules.srt import Subtitle
from whisperjav_tpu_torch.utils.logger import logger

SCHEMA_VERSION = 2
DEFAULT_SCENE_THRESHOLD = 60.0   # reference CLI default (cli.py:293)

_SUMMARY_RE = re.compile(r"<summary>(.*?)</summary>", re.DOTALL)


def split_scenes(subs: Sequence[Subtitle],
                 scene_threshold: float = DEFAULT_SCENE_THRESHOLD,
                 ) -> List[List[Subtitle]]:
    """Split cues into scenes at gaps >= scene_threshold seconds."""
    scenes: List[List[Subtitle]] = []
    current: List[Subtitle] = []
    prev_end: Optional[float] = None
    for s in subs:
        if (prev_end is not None and current
                and s.start - prev_end >= scene_threshold):
            scenes.append(current)
            current = []
        current.append(s)
        prev_end = s.end
    if current:
        scenes.append(current)
    return scenes


def split_batches(scene: Sequence[Subtitle],
                  max_batch_size: int) -> List[List[Subtitle]]:
    """Recursively split a scene at its largest internal gap until every
    batch holds at most ``max_batch_size`` cues (batch boundaries land
    on pauses — the PySubtrans batcher's behavior)."""
    scene = list(scene)
    if len(scene) <= max_batch_size:
        return [scene]
    # largest gap strictly inside the scene; ties break earliest, and a
    # degenerate all-equal scene still splits (midpoint wins at gap 0)
    best_i, best_gap = len(scene) // 2, -1.0
    for i in range(1, len(scene)):
        gap = scene[i].start - scene[i - 1].end
        if gap > best_gap:
            best_i, best_gap = i, gap
    return (split_batches(scene[:best_i], max_batch_size)
            + split_batches(scene[best_i:], max_batch_size))


def extract_summary(response: str) -> Optional[str]:
    """Pull the trailing <summary> tag out of a provider response."""
    m = _SUMMARY_RE.search(response)
    return m.group(1).strip() if m else None


@dataclass
class BatchState:
    """One translation batch: a contiguous cue span inside a scene."""
    scene: int
    number: int
    indices: List[int]                       # cue .index values
    translated: Dict[str, str] = field(default_factory=dict)
    summary: Optional[str] = None
    status: str = "pending"                  # pending | done | failed

    @property
    def complete(self) -> bool:
        return all(str(i) in self.translated for i in self.indices)


@dataclass
class ProjectV2:
    """Persistent scene/batch translation project (.wjtrans.json v2)."""
    source: str
    provider: str
    model: str
    target_language: str
    scene_threshold: float = DEFAULT_SCENE_THRESHOLD
    batches: List[BatchState] = field(default_factory=list)
    scene_summaries: Dict[str, str] = field(default_factory=dict)
    synopsis: Optional[str] = None

    # -- structure ----------------------------------------------------
    def build(self, subs: Sequence[Subtitle], max_batch_size: int) -> None:
        """(Re)build the scene/batch hierarchy, preserving any existing
        translations whose cue indices still exist."""
        old: Dict[str, str] = self.translated_map()
        self.batches = []
        for si, scene in enumerate(split_scenes(subs, self.scene_threshold)):
            for bi, batch in enumerate(split_batches(scene, max_batch_size)):
                st = BatchState(scene=si, number=bi,
                                indices=[s.index for s in batch])
                for s in batch:
                    if str(s.index) in old:
                        st.translated[str(s.index)] = old[str(s.index)]
                if st.complete and st.indices:
                    st.status = "done"
                self.batches.append(st)

    def translated_map(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for b in self.batches:
            out.update(b.translated)
        return out

    def pending(self) -> List[BatchState]:
        return [b for b in self.batches if not b.complete]

    def context_for(self, batch: BatchState) -> str:
        """Rolling context block for a batch prompt: synopsis, earlier
        scene summaries, and the previous batch's summary (the
        <scene>/<summary> context PySubtrans threads between requests —
        reference core.py:21-33 budgets ~500 tokens for it)."""
        parts: List[str] = []
        if self.synopsis:
            parts.append(f"<synopsis>{self.synopsis}</synopsis>")
        for si in sorted({b.scene for b in self.batches
                          if b.scene < batch.scene}):
            summ = self.scene_summaries.get(str(si))
            if summ:
                parts.append(f"<scene {si + 1}>{summ}</scene>")
        prev = [b for b in self.batches
                if b.summary and (b.scene, b.number) < (batch.scene,
                                                        batch.number)]
        if prev:
            parts.append(f"<summary>{prev[-1].summary}</summary>")
        text = "\n".join(parts)
        return text[:4000]        # hard cap, mirrors the context budget

    def record(self, batch: BatchState, parsed: Dict[int, str],
               summary: Optional[str]) -> None:
        for idx in batch.indices:
            if idx in parsed and parsed[idx]:
                batch.translated[str(idx)] = parsed[idx]
        batch.summary = summary or batch.summary
        batch.status = "done" if batch.complete else "failed"
        if summary:
            # last batch summary of a scene doubles as the scene summary
            self.scene_summaries[str(batch.scene)] = summary

    # -- scene-tree editing ---------------------------------------------
    # The PySubtrans project editor's verbs (reference: translate/core.py
    # + the subtitle-editor GUI): merge/split scenes and batches, move
    # lines, set summaries, reset a batch for retranslation. Exposed via
    # ``whisperjav-translate --edit`` (translate/cli.py). Every operation
    # renumbers to keep (scene, number) contiguous and sorted.

    def _renumber(self) -> None:
        self.batches.sort(key=lambda b: (b.scene, b.number))
        scene_map: Dict[int, int] = {}
        counters: Dict[int, int] = {}
        remapped_summaries: Dict[str, str] = {}
        for b in self.batches:
            if b.scene not in scene_map:
                scene_map[b.scene] = len(scene_map)
            old = b.scene
            b.scene = scene_map[old]
            b.number = counters.get(b.scene, 0)
            counters[b.scene] = b.number + 1
            if str(old) in self.scene_summaries:
                remapped_summaries[str(b.scene)] = \
                    self.scene_summaries[str(old)]
        self.scene_summaries = remapped_summaries

    def get_batch(self, scene: int, number: int) -> BatchState:
        for b in self.batches:
            if b.scene == scene and b.number == number:
                return b
        raise KeyError(f"no batch {number} in scene {scene}")

    def merge_scenes(self, s1: int, s2: int) -> None:
        """Fold scene s2's batches into s1 (they become its tail)."""
        if s1 == s2:
            return
        lo, hi = min(s1, s2), max(s1, s2)
        tail = max((b.number for b in self.batches if b.scene == lo),
                   default=-1) + 1
        moved = [b for b in self.batches if b.scene == hi]
        if not moved:
            raise KeyError(f"no scene {hi}")
        for i, b in enumerate(sorted(moved, key=lambda b: b.number)):
            b.scene, b.number = lo, tail + i
        self.scene_summaries.pop(str(hi), None)
        self._renumber()

    def split_scene(self, scene: int, at_batch: int) -> None:
        """Batches >= at_batch of ``scene`` become a NEW scene after it."""
        moving = [b for b in self.batches
                  if b.scene == scene and b.number >= at_batch]
        if not moving:
            raise KeyError(f"scene {scene} has no batch >= {at_batch}")
        # temporary half-step scene id; _renumber compacts
        for b in self.batches:
            if b.scene > scene:
                b.scene += 1
        for b in moving:
            b.scene = scene + 1
        self._renumber()

    def merge_batches(self, scene: int, b1: int, b2: int) -> None:
        """Combine two batches of one scene (indices + translations)."""
        a = self.get_batch(scene, min(b1, b2))
        b = self.get_batch(scene, max(b1, b2))
        if a is b:
            return
        a.indices = a.indices + [i for i in b.indices
                                 if i not in a.indices]
        a.translated.update(b.translated)
        a.summary = b.summary or a.summary
        a.status = "done" if a.complete and a.indices else "pending"
        self.batches.remove(b)
        self._renumber()

    def split_batch(self, scene: int, number: int, at: int) -> None:
        """Split a batch's cue list before its ``at``-th line (1 <= at <
        len): the tail becomes a new batch right after it."""
        b = self.get_batch(scene, number)
        if not 1 <= at < len(b.indices):
            raise ValueError(
                f"split point {at} outside (0, {len(b.indices)})")
        head, tail = b.indices[:at], b.indices[at:]
        nb = BatchState(scene=scene, number=number + 1, indices=tail)
        for i in tail:
            if str(i) in b.translated:
                nb.translated[str(i)] = b.translated.pop(str(i))
        nb.status = "done" if nb.complete and nb.indices else "pending"
        b.indices = head
        b.status = "done" if b.complete and b.indices else "pending"
        for other in self.batches:
            if other.scene == scene and other.number > number:
                other.number += 1
        self.batches.append(nb)
        self._renumber()

    def move_lines(self, indices: Sequence[int], from_sb: tuple,
                   to_sb: tuple) -> None:
        """Move cue ids between batches (translations travel along)."""
        src = self.get_batch(*from_sb)
        dst = self.get_batch(*to_sb)
        for i in indices:
            if i not in src.indices:
                raise KeyError(f"line {i} not in batch {from_sb}")
        src.indices = [i for i in src.indices if i not in set(indices)]
        dst.indices += [i for i in indices if i not in dst.indices]
        for i in indices:
            if str(i) in src.translated:
                dst.translated[str(i)] = src.translated.pop(str(i))
        for b in (src, dst):
            b.status = "done" if b.complete and b.indices else "pending"
        if not src.indices:
            self.batches.remove(src)
            self._renumber()

    def reset_batch(self, scene: int, number: int) -> None:
        """Clear a batch's translations so the next run redoes it."""
        b = self.get_batch(scene, number)
        b.translated = {}
        b.summary = None
        b.status = "pending"

    def set_scene_summary(self, scene: int, text: str) -> None:
        if not any(b.scene == scene for b in self.batches):
            raise KeyError(f"no scene {scene}")
        self.scene_summaries[str(scene)] = text

    def describe(self) -> str:
        """Printable scene/batch tree (the editor's view)."""
        lines: List[str] = [f"project: {self.source}"]
        if self.synopsis:
            lines.append(f"synopsis: {self.synopsis[:120]}")
        for si in sorted({b.scene for b in self.batches}):
            summ = self.scene_summaries.get(str(si), "")
            lines.append(f"scene {si}" + (f" — {summ[:80]}" if summ else ""))
            for b in sorted((b for b in self.batches if b.scene == si),
                            key=lambda b: b.number):
                done = sum(1 for i in b.indices
                           if str(i) in b.translated)
                lines.append(
                    f"  batch {b.number}: lines "
                    f"{b.indices[0] if b.indices else '-'}"
                    f"..{b.indices[-1] if b.indices else '-'} "
                    f"({done}/{len(b.indices)} translated, {b.status})"
                    + (f" — {b.summary[:60]}" if b.summary else ""))
        return "\n".join(lines)

    # -- persistence ----------------------------------------------------
    @staticmethod
    def path_for(srt_path: Path) -> Path:
        return Path(srt_path).with_suffix(".wjtrans.json")

    def save(self, srt_path: Path) -> None:
        data = {
            "schema": SCHEMA_VERSION,
            "source": self.source,
            "provider": self.provider,
            "model": self.model,
            "target_language": self.target_language,
            "scene_threshold": self.scene_threshold,
            "synopsis": self.synopsis,
            "scene_summaries": self.scene_summaries,
            "batches": [
                {"scene": b.scene, "number": b.number,
                 "indices": b.indices, "translated": b.translated,
                 "summary": b.summary, "status": b.status}
                for b in self.batches
            ],
        }
        self.path_for(srt_path).write_text(
            json.dumps(data, ensure_ascii=False, indent=1),
            encoding="utf-8")

    @classmethod
    def load_or_new(cls, srt_path: Path, provider: str, model: str,
                    target: str,
                    scene_threshold: float = DEFAULT_SCENE_THRESHOLD,
                    synopsis: Optional[str] = None) -> "ProjectV2":
        """Load a resumable project. Only the *translations* resume; the
        runtime settings (provider/model/threshold) are taken from the
        caller — never from the stale file (reference core.py:349-353)."""
        p = cls.path_for(srt_path)
        proj = cls(str(srt_path), provider, model, target,
                   scene_threshold=scene_threshold, synopsis=synopsis)
        if not p.exists():
            return proj
        try:
            data = json.loads(p.read_text(encoding="utf-8"))
        except json.JSONDecodeError:
            logger.warning("corrupt project file %s; starting fresh", p)
            return proj
        if data.get("target_language") != target:
            return proj                       # different job, fresh start
        if data.get("schema", 1) < 2:
            # v1 files hold a flat index→text map; adopt it as one batch
            # so build() can redistribute into the new hierarchy
            old = data.get("translated", {})
            if old:
                proj.batches = [BatchState(
                    scene=0, number=0,
                    indices=[int(k) for k in old],
                    translated=dict(old), status="done")]
                logger.info("upgraded v1 project: %d lines carried", len(old))
            return proj
        proj.synopsis = synopsis if synopsis is not None \
            else data.get("synopsis")
        proj.scene_summaries = dict(data.get("scene_summaries", {}))
        for b in data.get("batches", []):
            proj.batches.append(BatchState(
                scene=int(b.get("scene", 0)),
                number=int(b.get("number", 0)),
                indices=[int(i) for i in b.get("indices", [])],
                translated=dict(b.get("translated", {})),
                summary=b.get("summary"),
                status=b.get("status", "pending")))
        done = sum(1 for b in proj.batches if b.complete and b.indices)
        if proj.batches:
            logger.info("resuming translation project: %d/%d batches done",
                        done, len(proj.batches))
        return proj
