"""End-to-end file-level RTF benchmark: the port's CLI over a long WAV.

The reference project's headline figure is whole-pipeline per file: "5-10
minutes per hour of video" on CUDA (its README), i.e. 6-12x realtime.
This tool measures what a user of the port gets: extract -> scenes ->
VAD -> (enhance) -> batched decode -> sanitize -> SRT, through
``python -m whisperjav_tpu_torch.cli --device <d>`` (``--serve``: through
``python -m whisperjav_tpu_torch.serve``).

Prints ONE JSON line:
  {"metric": "e2e_file_rtf_<mode>", "value": N, "unit": "x_realtime",
   "vs_baseline": N, "stage_s": {...}, "audio_s": N, "wall_s": N,
   "device": "<the engine's device>", ...}
(vs_baseline anchors to the reference project's best case, 12x
realtime.) With ``WJAV_TRACE_BATCHES=1`` in the environment the child
records its per-batch phase walls, summed here into ``batch_phase_s``
(encode, first-rung decode, ladder, extract), with ``batch_s_each`` and
``rungs_each``.

This parent process imports no torch; the child makes its own device
contact. The child is never killed before its first pipeline output (a
"processing" or "engine" line); after that a stall watchdog applies.

Synthetic input: seeded speech-shaped bursts (pitch-modulated harmonic
stacks + breath noise) in 2-18 s utterances with 0.4-3 s gaps and a few
>4 s silences, so scene detection, VAD grouping, packing, and the
sanitizer all do real work on a realistic duty cycle (~70% speech).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

BASELINE_E2E_RTF = 12.0     # the reference's CUDA best case: 5 min/hour
SR = 16000
# the port's batch-trace phases (pipelines/engine.py)
BATCH_PHASES = ("encode_s", "decode_s", "ladder_s", "extract_s")
# the engine's first log line names its device
_ENGINE_LINE = re.compile(r"engine (\S+) on (.+)$")


def synth_long_wav(path: Path, minutes: float, seed: int = 0) -> float:
    """Speech-shaped long-form test audio; returns duration in seconds."""
    rng = np.random.default_rng(seed)
    total = int(minutes * 60 * SR)
    out = np.zeros(total, dtype=np.float32)
    pos = 0
    while pos < total:
        # occasional long silence => scene boundary material
        if rng.random() < 0.06:
            pos += int(rng.uniform(4.0, 9.0) * SR)
            continue
        dur = float(rng.uniform(2.0, 18.0))
        n = min(int(dur * SR), total - pos)
        if n <= 0:
            break
        t = np.arange(n) / SR
        f0 = rng.uniform(110.0, 240.0)
        # pitch contour + syllable-rate amplitude modulation
        f = f0 * (1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t))
        phase = 2 * np.pi * np.cumsum(f) / SR
        voiced = (np.sin(phase) + 0.5 * np.sin(2 * phase)
                  + 0.25 * np.sin(3 * phase))
        am = 0.55 + 0.45 * np.clip(
            np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t), 0.0, None)
        seg = 0.22 * voiced * am + 0.015 * rng.standard_normal(n)
        # 30 ms fade in/out to avoid clicks
        edge = min(480, n // 2)
        env = np.ones(n, dtype=np.float32)
        ramp = np.linspace(0.0, 1.0, edge, dtype=np.float32)
        env[:edge] = ramp
        env[-edge:] = ramp[::-1]
        out[pos:pos + n] = (seg * env).astype(np.float32)
        pos += n + int(rng.uniform(0.4, 3.0) * SR)

    from whisperjav_tpu_torch.modules.audio_io import write_wav
    write_wav(path, out, SR)
    return total / SR


def run_cli(wav: Path, out_dir: Path, mode: str, model: str | None,
            batch_size: int | None, extra: list[str],
            budget_s: float, stall_s: float,
            device: str = "cuda") -> tuple[int, float, str | None]:
    """Run the CLI as a child; stall-kill only after its first pipeline
    output. Returns (exit code, wall, the engine's device line)."""
    cmd = [sys.executable, "-m", "whisperjav_tpu_torch.cli", str(wav),
           "--mode", mode, "--output-dir", str(out_dir), "--device", device]
    if model:
        cmd += ["--model", model]
    if batch_size:
        cmd += ["--batch-size", str(batch_size)]
    cmd += extra
    env = dict(os.environ)
    env.setdefault("PYTHONUNBUFFERED", "1")
    print(f"e2e_bench: running {' '.join(cmd)}", file=sys.stderr, flush=True)
    t0 = time.time()
    proc = subprocess.Popen(cmd, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, env=env,
                            cwd=str(Path(__file__).resolve().parents[2]))
    state = {"last": time.time(), "claimed": False, "device": None}

    def pump():
        for raw in proc.stderr:
            line = raw.decode("utf-8", "replace").rstrip()
            print(f"  [cli] {line}", file=sys.stderr, flush=True)
            state["last"] = time.time()
            if "processing" in line or "engine" in line.lower():
                state["claimed"] = True
            m = _ENGINE_LINE.search(line)
            if m and state["device"] is None:
                state["device"] = m.group(2).strip()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    while proc.poll() is None:
        time.sleep(0.5)
        now = time.time()
        # never kill before the first pipeline output; after it, a long
        # silence can be a first build, so the stall bar is generous
        if state["claimed"] and now - state["last"] > stall_s:
            print(f"e2e_bench: no CLI output for {stall_s:.0f}s"
                  " — killing", file=sys.stderr, flush=True)
            proc.kill()
            proc.wait()
            return 1, time.time() - t0, state["device"]
        if state["claimed"] and now - t0 > budget_s:
            print("e2e_bench: budget exceeded — killing",
                  file=sys.stderr, flush=True)
            proc.kill()
            proc.wait()
            return 1, time.time() - t0, state["device"]
    wall = time.time() - t0
    reader.join(timeout=10)
    return proc.returncode or 0, wall, state["device"]

def run_serve(wav: Path, mode: str, model: str | None,
              batch_size: int | None, budget_s: float,
              audio_s: float, concurrency: int = 1,
              device: str = "cuda") -> dict | None:
    """File-level RTF through ``whisperjav-torch-serve``'s hot engine.

    Starts the server as a child on ``device``, waits for /health (the
    engine build and the kernels' first build can take minutes), then
    POSTs the SAME file twice: request 1 pays the first-call costs,
    request 2 is the resident-engine steady state a multi-file user
    lives in. Returns both walls and the server's device.

    ``concurrency`` > 1 adds a third phase: N simultaneous requests
    against the warm engine with the window coalescer live — the
    sustained-serving number (aggregate audio-seconds / wall).
    """
    import http.client
    import socket

    health: dict = {}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "whisperjav_tpu_torch.serve",
           "--port", str(port), "--mode", mode, "--device", device,
           # single client: no linger; concurrent phase wants coalescing
           "--coalesce-ms", "30" if concurrency > 1 else "0"]
    if model:
        cmd += ["--model", model]
    if batch_size:
        cmd += ["--batch-size", str(batch_size)]
    env = dict(os.environ)
    env.setdefault("PYTHONUNBUFFERED", "1")
    print(f"e2e_bench: starting {' '.join(cmd)}", file=sys.stderr,
          flush=True)
    proc = subprocess.Popen(cmd, stderr=subprocess.STDOUT,
                            stdout=subprocess.PIPE, env=env,
                            cwd=str(Path(__file__).resolve().parents[2]))

    def pump():
        for raw in proc.stdout:
            print(f"  [serve] {raw.decode('utf-8', 'replace').rstrip()}",
                  file=sys.stderr, flush=True)

    threading.Thread(target=pump, daemon=True).start()

    def request(req_timeout: float):
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=req_timeout)
        body = json.dumps({"path": str(wav), "format": "json"})
        t0 = time.time()
        conn.request("POST", "/transcribe", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"serve error {resp.status}: {data}")
        return time.time() - t0, data

    try:
        deadline = time.time() + budget_s
        while time.time() < deadline:          # wait for the engine
            if proc.poll() is not None:
                print("e2e_bench: serve exited during startup",
                      file=sys.stderr, flush=True)
                return None
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5.0)
                conn.request("GET", "/health")
                resp = conn.getresponse()
                if resp.status == 200:
                    health = json.loads(resp.read())
                    break
            except OSError:
                time.sleep(1.0)
        else:
            return None
        wall_cold, _ = request(budget_s)
        wall_warm, data = request(budget_s)
        out = {
            "serve_cold_wall_s": round(wall_cold, 2),
            "serve_warm_wall_s": round(wall_warm, 2),
            "serve_cold_rtf_x": round(audio_s / wall_cold, 2),
            "serve_warm_rtf_x": round(audio_s / wall_warm, 2),
            "serve_stats": data.get("stats", {}),
            "serve_cues": len(data.get("cues", [])),
            "device": health.get("device"),
        }
        if concurrency > 1:
            walls: list = [None] * concurrency
            errs: list = [None] * concurrency

            def worker(i: int) -> None:
                try:
                    walls[i], _ = request(budget_s)
                except Exception as e:  # noqa: BLE001 — record, don't die
                    errs[i] = str(e)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(concurrency)]
            t0 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            agg_wall = time.time() - t0
            ok = [w for w in walls if w is not None]
            out.update({
                "concurrency": concurrency,
                "concurrent_ok": len(ok),
                "concurrent_errors": [e for e in errs if e],
                "concurrent_agg_wall_s": round(agg_wall, 2),
                # sustained serving throughput: total audio decoded
                # per wall second across all in-flight requests
                "concurrent_agg_rtf_x": round(
                    len(ok) * audio_s / agg_wall, 2),
                "concurrent_request_wall_s": [round(w, 2) for w in ok],
            })
        return out
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=30.0,
                    help="synthetic file length (north star: 120)")
    ap.add_argument("--mode", default="balanced")
    ap.add_argument("--model", default=None,
                    help="override the mode's model (e.g. tiny for smoke)")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--wav", default=None,
                    help="reuse an existing WAV instead of synthesizing")
    ap.add_argument("--budget-s", type=float, default=3600.0)
    # the stall allowance must exceed the longest silent stretch of the
    # child (the kernels' first build, a long file's first batch)
    ap.add_argument("--stall-s", type=float, default=1500.0)
    ap.add_argument("--device", default="cuda",
                    help="the child's device (default cuda; a missing "
                         "card is the child's error, never a CPU run)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the synthesized WAV + outputs")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="with --serve: N simultaneous warm requests "
                         "(window-coalescer sustained-serving phase)")
    ap.add_argument("--serve", action="store_true",
                    help="measure through whisperjav-serve's hot engine "
                         "instead of the CLI (cold + warm request walls)")
    ap.add_argument("extra", nargs="*", help="extra CLI args after --")
    args = ap.parse_args(argv)

    tmp = Path(tempfile.mkdtemp(prefix="wjav_e2e_"))
    if args.wav:
        wav = Path(args.wav)
        from whisperjav_tpu_torch.modules.audio_io import read_wav
        audio, sr = read_wav(wav)
        audio_s = len(audio) / sr
    else:
        wav = tmp / "e2e_input.wav"
        print(f"e2e_bench: synthesizing {args.minutes:.0f} min WAV...",
              file=sys.stderr, flush=True)
        audio_s = synth_long_wav(wav, args.minutes)
    out_dir = tmp / "out"

    if args.serve:
        res = run_serve(wav, args.mode, args.model, args.batch_size,
                        args.budget_s, audio_s,
                        concurrency=args.concurrency, device=args.device)
        if res is None:
            print("e2e_bench: serve run failed", file=sys.stderr,
                  flush=True)
            return 3
        result = {
            "metric": f"e2e_serve_rtf_{args.mode}",
            "value": res["serve_warm_rtf_x"],
            "unit": "x_realtime",
            "vs_baseline": round(res["serve_warm_rtf_x"]
                                 / BASELINE_E2E_RTF, 3),
            "audio_s": round(audio_s, 1),
            **res,
        }
        print(json.dumps(result), flush=True)
        if not args.keep:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
        return 0

    rc, wall, device = run_cli(wav, out_dir, args.mode, args.model,
                               args.batch_size, args.extra,
                               args.budget_s, args.stall_s, args.device)
    meta_path = out_dir / f"{wav.stem}.whisperjav.json"
    if rc != 0 or not meta_path.exists():
        print(f"e2e_bench: CLI failed rc={rc}, no metadata at {meta_path}",
              file=sys.stderr, flush=True)
        return 3

    meta = json.loads(meta_path.read_text())
    stats = meta.get("stats", {})
    stage = stats.get("stage_s", {})
    # the CLI's own e2e wall excludes engine build + weight init; report
    # BOTH (pipeline wall = steady-state per-file cost on a warm engine,
    # process wall = cold-start single-file cost)
    pipe_wall = float(stats.get("e2e_wall_s") or wall)
    result = {
        "metric": f"e2e_file_rtf_{args.mode}",
        "value": round(audio_s / pipe_wall, 2),
        "unit": "x_realtime",
        "vs_baseline": round(audio_s / pipe_wall / BASELINE_E2E_RTF, 3),
        "audio_s": round(audio_s, 1),
        "wall_s": round(pipe_wall, 2),
        "process_wall_s": round(wall, 2),
        "process_rtf_x": round(audio_s / wall, 2),
        "stage_s": stage,
        "subtitles": stats.get("final_subtitles"),
        "windows": stats.get("windows"),
        "device": device,
    }
    # measurement provenance: the environment variables the port reads
    # that change what this number records
    prov = {k: os.environ[k] for k in ("WJAV_TRACE_BATCHES",)
            if k in os.environ}
    if "--daemon" in args.extra:
        prov["path"] = "daemon"
    if prov:
        result["env"] = prov
    trace = stats.get("batch_trace")
    if trace:
        result["batch_phase_s"] = {
            p: round(sum(t.get(p, 0.0) for t in trace), 2)
            for p in BATCH_PHASES}
        result["batch_s_each"] = [round(t.get("batch_s", 0.0), 1)
                                  for t in trace]
        result["rungs_each"] = [t.get("rungs") for t in trace]
    print(json.dumps(result), flush=True)
    if not args.keep:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        print(f"e2e_bench: outputs kept in {tmp}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
