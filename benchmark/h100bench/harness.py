"""One run of one cell: set-up, the measured window (or one profiled
file), and the check that decides ``correct``.

The harness is the loop; the configuration's driver
(``drivers/<driver>.py``, named by the configuration's ``driver``) is
everything that knows the program: it builds the system under test from
the cell and the seed, warms it up, serves one file of the traffic at a
time, fills the profiled file's :class:`~h100bench.trace.Stretch`, and
reads the numbers its check compares against the plain reference. The
harness keeps the clock, the memory peak, the closed loop of files, the
profiler, and the verdict of those readings against the cell's
``limits`` (``h100bench/check.py``).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Optional

import torch

from h100bench import check, spec, trace as tr

SEED_MOD = 2 ** 63


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             per_layer: Optional[dict] = None,
             reference_control: Optional[str] = None,
             program_control: Optional[str] = None) -> dict:
    """One run: set-up, then files until ``seconds`` have passed (one
    file at least), or with ``trace`` one profiled file, then the check.
    ``per_layer`` maps metric names to readers. For the calibration of
    the check: ``reference_control`` also reads the reference one
    precision below in the program's place, ``program_control`` builds
    the program with that lower path of its own switched on (the
    driver's ``CONTROLS`` and ``PROGRAM_CONTROLS``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    driver = spec.driver(cell["config"]["driver"])
    seed = int(seed) % SEED_MOD
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    program = driver.build(cell, seed, dev, program_control)
    departed = driver.departures(program)
    driver.warm_up(program)
    gc.collect()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    served = []       # a file each: (source seconds, attempted, answered)
    stretch = None
    # no collection pauses inside the window
    gc.freeze()
    gc.disable()
    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        os.environ["WJAV_TRACE_BATCHES"] = "1"
        inputs = driver.file(program, 1)
        # the CUDA activity only: recording every host op would slow a
        # host-bound loop (the CPU's activity where there is no card,
        # which gives no device spans)
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            served.append(driver.serve(program, inputs, timed=True))
            _sync(dev)
            wall = time.perf_counter() - t0
        stretch = tr.Stretch(spans=tr.device_spans(prof), wall_s=wall,
                             **driver.stretch(program))
        del prof
    else:
        index = 1
        while True:
            served.append(driver.serve(program, driver.file(program, index)))
            index += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        wall = elapsed
    _sync(dev)
    gc.enable()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    source_s = sum(f[0] for f in served)
    attempted = sum(f[1] for f in served)
    answered = sum(f[2] for f in served)
    # the program's state goes before the reference runs
    kept = driver.kept(program)
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, lows = driver.judge(cell, kept, seed, dev, departed,
                                  reference_control)
    limits = cell.get("limits", {})
    correct, checks = check.verdict(readings, limits)
    out = {"correct": correct, "attempted": attempted,
           "failed": attempted - answered}
    if trace:
        out["metrics"] = {
            name: {"value": value, "unit": mod.UNIT}
            for name, mod in (per_layer or {}).items()
            for value in [mod.read(stretch)] if value is not None}
        out["breakdown"] = {"device_ops": stretch.top_ops(),
                            "idle_gaps": stretch.idle_gaps()}
    else:
        out["metrics"] = {
            "audio_rtf": {"value": source_s / wall, "unit": "audio_s/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    out["device"] = {"memory_peak_bytes": peak}
    if trace:
        out["device"].update(busy_s=stretch.busy_s(), window_s=wall)
    out["unjudged"] = check.unjudged(readings, limits, driver.NUMBERS)
    out["checks"] = checks
    out["readings"] = check.finite(readings)
    if reference_control:
        low_correct, low_checks = check.verdict(lows, limits)
        out["control"] = {"name": reference_control, "correct": low_correct,
                          "checks": low_checks,
                          "readings": check.finite(lows)}
    return out
