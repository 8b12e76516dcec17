"""A toy driver for the harness's CPU tests: a one-layer program,
``tanh(x @ W)`` over a file of rows at a time, judged against the same
layer in float64 numpy. It stands for a configuration that the port
serves through another entry point than Whisper's engine: the tests
add it to a copy of the benchmark as a new file."""

import numpy as np
import torch

NUMBERS = ("max_err", "mean_err")
CONTROLS = ("bf16",)
PROGRAM_CONTROLS = ("bf16",)


class Program:
    def __init__(self, cfg, traffic, seed, device, dtype):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dtype = dtype
        self.w = draw(cfg["width"], seed, device).to(dtype)
        self.files = []


def draw(width: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(width, width, generator=g, device=device) \
        / width ** 0.5


def build(cell, seed, device, control=None):
    if control not in (None, *PROGRAM_CONTROLS):
        raise ValueError(f"unknown program control {control!r}")
    dtype = torch.bfloat16 if control else torch.float32
    return Program(cell["config"], cell["traffic"], seed, device, dtype)


def departures(program) -> int:
    return int(program.dtype != getattr(torch, program.cfg["dtype"]))


def warm_up(program) -> None:
    x = torch.zeros(program.traffic["rows_per_file"], program.cfg["width"])
    torch.tanh(x.to(program.w) @ program.w)


def file(program, index):
    rng = np.random.default_rng([program.seed, index])
    return rng.standard_normal((program.traffic["rows_per_file"],
                                program.cfg["width"])).astype(np.float32)


def serve(program, x, timed=False):
    y = torch.tanh(torch.from_numpy(x).to(program.w) @ program.w)
    program.files.append((x, y))
    rows = len(x)
    return rows * program.traffic["seconds_per_row"], rows, rows


def stretch(program):
    rows, width = len(program.files[-1][0]), program.cfg["width"]
    return {"model_flops": 2.0 * rows * width * width, "rows": rows}


def kept(program):
    return [(x, y.float().cpu().numpy()) for x, y in program.files]


def judge(cell, served, seed, device, departed=0, control=None):
    w = draw(cell["config"]["width"], seed, device).cpu().double().numpy()
    readings = {"max_err": [], "mean_err": []}
    lows = {"max_err": [], "mean_err": []}
    for x, y in served:
        ref = np.tanh(x.astype(np.float64) @ w)
        readings["max_err"].append(float(np.abs(y - ref).max()))
        readings["mean_err"].append(float(np.abs(y - ref).mean()))
        if control:
            low = torch.tanh(torch.from_numpy(x).bfloat16()
                             @ torch.from_numpy(w).bfloat16()).double()
            lows["max_err"].append(float(np.abs(low.numpy() - ref).max()))
            lows["mean_err"].append(float(np.abs(low.numpy() - ref).mean()))
    return readings, (lows if control else None)
