#!/usr/bin/env python3
"""Stage-split serving against the fused group path on one NVIDIA card:
several groups of batchable txt2img requests through a master's front
door, in turns (fused, staged, staged, fused by default).

    python3 scripts/stage_overlap_torch.py [--groups 3] [--members 2]
        [--steps 10] [--hw 1024] [--turns fused,staged,staged,fused]
        [--timeline] [--profile] [--out FILE]

Each turn builds a master ``Controller`` (no workers, the content cache
off, so every request encodes and samples) over one shared
``ModelRegistry`` with ``CDT_STAGES`` 0 (fused) or 1 (staged), a front
door that flushes a group when it holds ``--members`` requests (its
window is never reached) and the queue's default of two batch jobs in
flight. One warm-up group runs first (a staged master's pool threads are
new and set up their libraries on it); then ``--groups`` groups are
posted at once, and the reading is the host seconds from the first post
to the last member's history, each PNG checked bitwise against the same
request of the first turn. A staged turn also reports its pools' busy
seconds (``GET /distributed/stages``): with the denoise worker's busy
time D, the decode and encode pools' E and the reading W, D + E − W (when
positive) is host time the pools overlapped. The card's name and power
limit are printed before the JSON line of every reading; ``--device cpu``
with ``--model tiny`` rehearses the script without a card.

``--timeline`` records every sampler half (``_sample_latent``) and every
decode (``_decode_latent``) of the warm-up and the timed groups: its
thread, its start after the group's first post and its host seconds.
``--profile`` also runs both groups under ``torch.profiler`` and adds,
for each of those calls, the seconds in which the card was busy during
it (the union of the device events inside its window), the kernels
launched from its thread and the seconds its thread spent in the CUDA
launch and synchronise calls; and for each group, the card's busy
seconds and idle share over the group. ``--out`` writes the readings'
JSON to a file as well.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NEGATIVE = "blurry, low quality, watermark"


def prompt(model: str, seed: int, hw: int, steps: int, prefix: str) -> dict:
    return {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": model}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": f"a lighthouse at dusk, variant {seed}",
                         "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": NEGATIVE, "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": 5.0, "width": hw,
            "height": hw, "sampler_name": "euler", "scheduler": "karras"}},
        "5": {"class_type": "SaveImage",
              "inputs": {"images": ["4", 0], "filename_prefix": prefix}},
    }


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=60) as resp:
        return json.loads(resp.read())


def card(torch) -> str:
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        return torch.cuda.get_device_name(0)


CALLS: list = []      # (kind, thread, host start, host end), --timeline


def instrument(torch) -> None:
    """Record each sampler half and decode of the pipeline (``CALLS``),
    inside a profiler range of its kind."""
    import threading

    from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe

    def wrap(kind: str, fn):
        def timed(self, *a, **kw):
            with torch.profiler.record_function(f"overlap.{kind}"):
                t0 = time.perf_counter()
                try:
                    return fn(self, *a, **kw)
                finally:
                    CALLS.append((kind, threading.current_thread().name,
                                  t0, time.perf_counter()))
        return timed

    cls = tpipe.Txt2ImgPipeline
    cls._sample_latent = wrap("sample", cls._sample_latent)
    cls._decode_latent = wrap("decode", cls._decode_latent)


def _union(spans: list) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _clip(spans: list, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def profiler(torch):
    """``torch.profiler`` over the CPU and the card, recording the ops of
    every thread (the stage pools' too) where this torch can."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        return torch.profiler.profile(
            activities=acts,
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return torch.profiler.profile(activities=acts)


def trace_calls(prof, calls: list) -> dict:
    """The card's side of each recorded call, from one profiler run:
    busy seconds inside the call's window, launches and CUDA API seconds
    on its thread; the group's busy seconds and idle share."""
    from torch.autograd import DeviceType

    device, ranges, api = [], [], []
    for e in prof.events():
        t = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the card-side copy of a record_function range (kineto's
            # gpu_user_annotation) spans its kernels and gaps: not work
            if not e.name.startswith("overlap."):
                device.append(t)
        elif e.name.startswith("overlap."):
            ranges.append((e.name[len("overlap."):], e.thread, *t))
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            api.append(("launch", e.thread, *t))
        elif "Synchronize" in e.name and e.name.startswith("cuda"):
            api.append(("sync", e.thread, *t))
    if not device and not ranges:
        return {"device": "not measured: the profiler saw no event"}
    lo = min(r[2] for r in ranges) if ranges else min(a for a, _ in device)
    hi = max(r[3] for r in ranges) if ranges else max(b for _, b in device)
    rows = []
    for kind, thread, a, b in sorted(ranges, key=lambda r: r[2]):
        mine = [x for x in api if x[1] == thread and a <= x[2] <= b]
        rows.append({
            "kind": kind, "start_s": (a - lo) / 1e6, "wall_s": (b - a) / 1e6,
            "device_busy_s": _union(_clip(device, a, b)) / 1e6,
            "launches": sum(1 for x in mine if x[0] == "launch"),
            "launch_api_s": sum(x[3] - x[2] for x in mine
                                if x[0] == "launch") / 1e6,
            "sync_api_s": sum(x[3] - x[2] for x in mine
                              if x[0] == "sync") / 1e6})
    busy = _union(_clip(device, lo, hi)) / 1e6
    span = (hi - lo) / 1e6
    return {"calls": rows, "span_s": span, "device_busy_s": busy,
            "idle_share": (1.0 - busy / span if span > 0 and device
                           else None)}


def run_turn(torch, registry, mode: str, args, out: Path,
             seeds: list[list[int]]) -> dict:
    """One master of ``mode``: a warm-up group, then the timed groups
    posted at once; returns the reading and the PNGs by seed."""
    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster.controller import Controller

    env = {"CDT_STAGES": "1" if mode == "staged" else "0", "CDT_CACHE": "0",
           "CDT_FRONTDOOR": "1", "CDT_FD_WINDOW_MS": "600000",
           "CDT_FD_MAX_BATCH": str(args.members),
           "CDT_OUTPUT_DIR": str(out)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out.mkdir(parents=True, exist_ok=True)
    (out / "master.json").write_text("{}")
    controller = Controller(out / "master.json", device=args.device,
                            model_registry=registry)
    server = ServerThread(controller, port=0)
    base = f"http://127.0.0.1:{server.port}"

    traces: dict = {}

    def run(groups: list[list[int]], label: str) -> float:
        flat = [s for g in groups for s in g]
        del CALLS[:]
        prof = None
        if args.profile:
            prof = profiler(torch)
            prof.__enter__()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(flat)) as pool:
            answers = list(pool.map(lambda s: post(
                base + "/distributed/queue",
                {"prompt": prompt(args.model, s, args.hw, args.steps,
                                  f"s{s}")}), flat))
        for a in answers:
            while True:
                entry = controller.queue.history.get(a["prompt_id"])
                if entry is not None and entry.get("status") != "success":
                    raise RuntimeError(f"{mode}: {entry}")
                if entry is not None:
                    break
                time.sleep(0.005)
        if args.device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if args.timeline:
            traces[label] = {"epoch_start": time.time() - (
                time.perf_counter() - t0), "calls": [
                {"kind": k, "thread": th, "start_s": a - t0, "wall_s": b - a}
                for k, th, a, b in sorted(CALLS, key=lambda c: c[2])]}
        if prof is not None:
            prof.__exit__(None, None, None)
            traces[label]["profile"] = trace_calls(prof, CALLS)
        return seconds

    try:
        warm = run([[args.seed - 1 - m for m in range(args.members)]],
                   "warm_up")
        stats0 = (controller.stages.stats() if controller.stages else None)
        seconds = run(seeds, "timed")
        stats = (controller.stages.stats() if controller.stages else None)
    finally:
        server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    reading = {"mode": mode, "seconds": seconds, "warm_up_seconds": warm}
    if traces:
        reading["timeline"] = traces
    if stats is not None:
        busy = {p: stats["pools"][p]["busy_seconds"]
                - stats0["pools"][p]["busy_seconds"]
                for p in ("encode", "denoise", "decode")}
        reading.update(busy_seconds=busy, overlap_seconds=max(
            0.0, busy["denoise"] + busy["decode"] + busy["encode"] - seconds),
            fallbacks=stats["fallbacks"])
    pngs = {s: (out / f"s{s}_00000.png").read_bytes()
            for g in seeds for s in g}
    return reading, pngs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--members", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--model", default="sdxl")
    ap.add_argument("--seed", type=int, default=61)
    ap.add_argument("--turns", default="fused,staged,staged,fused")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    args.timeline = args.timeline or args.profile
    sys.path.insert(0, str(ROOT))
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("stage_overlap_torch: no CUDA device", file=sys.stderr)
        return 2
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.utils.device import use_full_fp32

    if args.device != "cpu":
        use_full_fp32()
    if args.timeline:
        instrument(torch)
    registry = ModelRegistry(args.device, seed=0)
    registry.get(args.model)
    seeds = [[args.seed + g * args.members + m for m in range(args.members)]
             for g in range(args.groups)]
    readings, first = [], None
    (ROOT / "output").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        for i, mode in enumerate(args.turns.split(",")):
            reading, pngs = run_turn(torch, registry, mode, args,
                                     Path(tmp) / f"turn{i}", seeds)
            if first is None:
                first = pngs
            reading["bitwise_first_turn"] = pngs == first
            readings.append(reading)
            print(f"{mode}: {reading['seconds']:.3f} s for {args.groups} "
                  f"groups of {args.members} ({args.hw}², {args.steps} "
                  f"steps; warm-up group {reading['warm_up_seconds']:.3f} s)"
                  + (f"; pools busy {reading['busy_seconds']}, overlapped "
                     f"{reading['overlap_seconds']:.3f} s"
                     if "busy_seconds" in reading else "")
                  + f"; PNGs bitwise the first turn's: "
                    f"{reading['bitwise_first_turn']}", flush=True)
            for label, tr in reading.get("timeline", {}).items():
                walls = [c["wall_s"] for c in tr["calls"]
                         if c["kind"] == "sample"]
                line = (f"  {label}: sampler halves {len(walls)}, host s "
                        f"{[round(w, 4) for w in walls]}")
                prof = tr.get("profile", {})
                if "calls" in prof:
                    mine = [c for c in prof["calls"] if c["kind"] == "sample"]

                    def col(key):
                        return [round(c[key], 4) for c in mine]

                    line += (f"; traced: host s {col('wall_s')}, card busy s "
                             f"{col('device_busy_s')}, launches "
                             f"{[c['launches'] for c in mine]}, launch API s "
                             f"{col('launch_api_s')}, sync API s "
                             f"{col('sync_api_s')}; group idle share "
                             f"{prof['idle_share']}")
                print(line, flush=True)
    result = {"readings": readings, "groups": args.groups,
              "members": args.members, "steps": args.steps,
              "hw": args.hw, "model": args.model, "card": card(torch)}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps({k: v for k, v in result.items() if k != "readings"}
                     | {"readings": [{k: v for k, v in r.items()
                                      if k != "timeline"}
                                     for r in readings]}))
    return 0 if all(r["bitwise_first_turn"] for r in readings) else 1


if __name__ == "__main__":
    sys.exit(main())
