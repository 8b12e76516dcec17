"""``whisperjav-torch-translate``: subtitle translation on the port.

The port's counterpart of ``whisperjav-translate``
(``whisperjav_tpu/translate/cli.py``; reference:
whisperjav/translate/cli.py): the same flags, the ``--edit`` verbs over
the ``.wjtrans.json`` project, ``--save`` and ``--show-settings``, plus
``--device`` (default ``cuda``) for the ``tpu-local`` provider's LM.
Settings precedence: explicit flags > the persisted settings file (the
same file the JAX CLI reads) > built-in defaults.

    whisperjav-torch-translate -i clip.ja.whisperjav.srt --provider gpt
    whisperjav-torch-translate -i clip.srt --provider tpu-local \
        --model ./Qwen3-1.7B
    whisperjav-torch-translate -i clip.srt --provider tpu-local \
        --model ./kanana-2-30b-a3b-instruct-2601
    python -m whisperjav_tpu_torch.translate.cli --show-settings
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from whisperjav_tpu_torch.translate.settings import (
    load_settings, movie_context_block, save_settings,
)


def _edit_project(srt_path: Path, op_args, provider: str, model: str,
                  target: str, scene_threshold: float,
                  max_batch_size: int) -> int:
    """Scene-tree editing verbs over the .wjtrans.json project (role of
    the PySubtrans project editor the reference GUI drives — reference:
    whisperjav/translate/core.py project layer). Builds the hierarchy
    from the SRT when no project exists yet."""
    from whisperjav_tpu_torch.modules.srt import load_srt
    from whisperjav_tpu_torch.translate.project import ProjectV2

    proj = ProjectV2.load_or_new(srt_path, provider, model, target,
                                 scene_threshold=scene_threshold)
    if not proj.batches:
        proj.build(load_srt(srt_path), max_batch_size)
    op, rest = op_args[0], op_args[1:]
    try:
        if op == "show":
            print(proj.describe())
            return 0
        elif op == "merge-scenes":
            proj.merge_scenes(int(rest[0]), int(rest[1]))
        elif op == "split-scene":
            proj.split_scene(int(rest[0]), int(rest[1]))
        elif op == "merge-batches":
            proj.merge_batches(int(rest[0]), int(rest[1]), int(rest[2]))
        elif op == "split-batch":
            proj.split_batch(int(rest[0]), int(rest[1]), int(rest[2]))
        elif op == "move-lines":
            idx = [int(i) for i in rest[4].split(",")]
            proj.move_lines(idx, (int(rest[0]), int(rest[1])),
                            (int(rest[2]), int(rest[3])))
        elif op == "reset-batch":
            proj.reset_batch(int(rest[0]), int(rest[1]))
        elif op == "set-synopsis":
            proj.synopsis = " ".join(rest)
        elif op == "set-scene-summary":
            proj.set_scene_summary(int(rest[0]), " ".join(rest[1:]))
        else:
            print(f"unknown edit op: {op}", file=sys.stderr)
            return 2
    except (KeyError, ValueError, IndexError) as e:
        print(f"edit failed: {e}", file=sys.stderr)
        return 2
    proj.save(srt_path)
    print(proj.describe())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    stored = load_settings()
    p = argparse.ArgumentParser(
        prog="whisperjav-torch-translate",
        description="translate subtitle files via LLM providers")
    p.add_argument("-i", "--input", default=None, help="input SRT file")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--provider", default=stored["provider"],
                   help="deepseek/openrouter/gpt/claude/gemini/glm/groq/"
                        "ollama/local/tpu-local/custom/identity")
    p.add_argument("--model", default=stored["model"],
                   help="model id (for tpu-local: a local instruct "
                        "checkpoint directory, Qwen3 or DeepSeek-V3 "
                        "block, e.g. Kanana-2-30B-A3B)")
    p.add_argument("--target-language", default=stored["target_language"])
    p.add_argument("--base-url", default=None)
    p.add_argument("--tone", default=stored["tone"],
                   choices=["standard", "pornify"],
                   help="instruction set flavor")
    p.add_argument("--max-batch-size", type=int,
                   default=stored["max_batch_size"],
                   help="cap subtitle lines per request")
    p.add_argument("--scene-threshold", type=float,
                   default=stored.get("scene_threshold", 60.0),
                   help="gap in seconds that starts a new scene "
                        "(batch boundaries align to scene pauses)")
    p.add_argument("--movie-title", default=stored["movie_title"],
                   help="movie title woven into the prompt context")
    p.add_argument("--movie-plot", default=stored["movie_plot"])
    p.add_argument("--actress", default=stored["actress"],
                   help="performer name(s) for pronoun/name handling")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tpu-local provider's LM "
                        "(default cuda)")
    p.add_argument("--no-auto-start", action="store_true",
                   help="do not auto-start a local ollama server")
    p.add_argument("--save", action="store_true",
                   help="persist the effective settings for future runs")
    p.add_argument("--show-settings", action="store_true",
                   help="print effective settings and exit")
    p.add_argument("--edit", nargs="+", metavar="OP",
                   help="edit the input's translation project tree "
                        "(no translation runs): show | merge-scenes S1 S2"
                        " | split-scene S AT_BATCH | merge-batches S B1 B2"
                        " | split-batch S B AT_LINE | move-lines S1 B1 S2"
                        " B2 IDX[,IDX…] | reset-batch S B | set-synopsis"
                        " TEXT | set-scene-summary S TEXT")
    args = p.parse_args(argv)

    if args.edit:
        if args.input is None:
            p.error("--edit requires -i/--input")
        return _edit_project(Path(args.input), args.edit,
                             args.provider, args.model,
                             args.target_language, args.scene_threshold,
                             args.max_batch_size)

    effective = dict(
        stored,
        provider=args.provider, model=args.model,
        target_language=args.target_language, tone=args.tone,
        max_batch_size=args.max_batch_size,
        scene_threshold=args.scene_threshold,
        movie_title=args.movie_title, movie_plot=args.movie_plot,
        actress=args.actress,
        ollama_url=args.base_url or stored.get("ollama_url"),
    )
    if args.show_settings:
        print(json.dumps({k: v for k, v in effective.items()
                          if not k.startswith("_")},
                         indent=2, ensure_ascii=False))
        return 0
    if args.save:
        path = save_settings(effective)
        print(f"settings saved: {path}")
        if args.input is None:
            return 0
    if args.input is None:
        p.error("-i/--input is required (unless --save/--show-settings)")

    from whisperjav_tpu_torch.translate.service import translate_srt
    out = translate_srt(
        Path(args.input), provider=args.provider, model=args.model,
        target_language=args.target_language,
        output_path=Path(args.output) if args.output else None,
        base_url=args.base_url, tone=args.tone,
        auto_start_ollama=not args.no_auto_start,
        max_batch_size=args.max_batch_size,
        scene_threshold=args.scene_threshold,
        movie_context=movie_context_block(effective),
        device=args.device)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
