"""One run of one benchmark cell.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout: set-up (the cell's inputs from
the seed and one warm job of its own shape), then whole jobs for
``--seconds``, then the check of what the jobs produced against the plain
reference under ``perfbench/reference/``.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared with its limit); the last lines of standard error are the
same checks.

A cell on several chips runs one process a card: this process is rank 0;
it starts the others (``--rank``, ``--store-port``) with a TCP store on a
free local port as the rendezvous, and it alone prints the result.
``--cpu-dry-run`` runs the cell on the CPU at the entry's tiny sizes (the
program's plain versions in place of its kernels), for tests.
``--calibrate 'sound:<seed>,..;control:<seed>,..'`` prints, for each seed,
the numbers that decide ``correct``, of the program (sound) or of the
reference computed in the precision below the configuration's in its place
(control): the readings that the limits under ``perfbench/limits/`` are set
from.  The benchmark's own runs use neither.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import NamedTuple

from .bench import ROOT, load_module, resolve

FORBIDDEN = ("jax", "jaxlib", "flax", "glabc_tpu")
CACHE = os.path.join(ROOT, "_perfbench_cache")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--cpu-dry-run", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--calibrate", default=None, help=argparse.SUPPRESS)
    opts = p.parse_args(argv)
    if opts.seed < 0:
        p.error("--seed must be non-negative")
    return opts


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this benchmark may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own libraries build under ``glabc_tpu_torch/_build``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def smi(fields: str) -> str:
    """What ``nvidia-smi`` reads of every card (it sets nothing)."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20
        ).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


STATE = "clocks.sm,clocks.mem,temperature.gpu,power.draw"


def card_line(torch, chips: int) -> str:
    from .peaks import PEAKS

    name = torch.cuda.get_device_name(0)
    peaks = ", ".join(f"{k} {v:.4g}" for k, v in PEAKS.items())
    return (f"device {name} x{torch.cuda.device_count()} (this cell: "
            f"{chips}); nvidia-smi name, power.limit: "
            f"{smi('name,power.limit')}; {STATE}: {smi(STATE)}; published "
            f"peaks used: {peaks}")


class Ctx(NamedTuple):
    """What an entry is given: the cell, the run's seed, where it runs."""

    cell: object
    seed: int
    device: object        # torch.device
    mesh: object          # a DeviceMesh, or None on one chip
    rank: int
    world: int
    dry: bool             # CPU dry run at the entry's tiny sizes


class ReadCtx(NamedTuple):
    """What a per-layer metric's reader is given."""

    timeline: object      # trace.Timeline of this rank's window
    job: object           # the entry's cell object (its work counts)
    rank: int
    world: int


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reduce_ranks(x: float, op: str, mesh, device) -> float:
    """``x`` summed (``op='sum'``) or maximised (``'max'``) over the ranks;
    ``x`` itself on one chip."""
    if mesh is None:
        return x
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM)
    return float(t.item())


def window(torch, job, seconds: float, est: float, mesh, device):
    """Whole jobs from now while the next is expected to end within
    ``seconds`` (at least one); rank 0 decides for every rank.  Returns
    ``(start, end of the last job, [seconds of each job])``."""
    if mesh is not None:
        torch.distributed.barrier()
    t_start = time.perf_counter()
    times = []
    with torch.profiler.record_function("perfbench.window"):
        while True:
            go = not times or (time.perf_counter() - t_start + est
                               <= seconds)
            if mesh is not None:
                flag = torch.tensor([int(go)], device=device)
                torch.distributed.broadcast(flag, src=0)
                go = bool(flag.item())
            if not go:
                break
            tj = time.perf_counter()
            with torch.profiler.record_function("perfbench.job"):
                job.job(len(times))
            _sync(torch, device)
            t_end = time.perf_counter()
            times.append(t_end - tj)
            est = max(times)
    return t_start, t_end, times


def _place(opts, rank, world, store):
    """``(device, mesh)`` of this rank, the process group joined."""
    import torch

    if opts.cpu_dry_run:
        device = torch.device("cpu")
        torch.set_num_threads(2)
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    mesh = None
    if world > 1:
        from glabc_tpu_torch.parallel import initialize_distributed, make_mesh

        initialize_distributed(store=store, rank=rank, world_size=world)
        mesh = make_mesh()
    return device, mesh


def calibrate(opts, cell, rank: int, world: int, store):
    """The compared numbers of a window of ``--seconds`` for each seed of
    ``--calibrate``: ``sound`` judges the program, ``control`` the
    reference computed in the precision below the configuration's in the
    program's place.  Rank 0 returns ``{kind: {seed: numbers}}``."""
    import torch

    device, mesh = _place(opts, rank, world, store)
    entry = load_module("entries", cell.config["entry"])
    out = {}
    for part in opts.calibrate.split(";"):
        kind, seeds = part.split(":")
        for seed in (int(x) for x in seeds.split(",")):
            job = entry.Cell(Ctx(cell, seed, device, mesh, rank, world,
                                 opts.cpu_dry_run))
            job.setup()
            _, _, times = window(torch, job, opts.seconds, 0.0, mesh, device)
            job.release()
            numbers = job.check(control=kind == "control")
            if rank == 0:
                log(f"calibrate {kind} seed {seed}: {len(times)} jobs, "
                    f"{json.dumps(numbers)}")
            out.setdefault(kind, {})[seed] = numbers
            del job
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if mesh is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return {"calibration": out} if rank == 0 else None


def run_rank(opts, cell, rank: int, world: int, store, t0: float):
    """Set-up, window and check of one rank; rank 0 returns the result."""
    import torch

    device, mesh = _place(opts, rank, world, store)
    entry = load_module("entries", cell.config["entry"])
    job = entry.Cell(Ctx(cell, opts.seed, device, mesh, rank, world,
                         opts.cpu_dry_run))

    job.setup()
    tw = time.perf_counter()
    job.warm()
    _sync(torch, device)
    warm_s = time.perf_counter() - tw

    prof = None
    if opts.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    t_start, t_end, times = window(torch, job, opts.seconds,
                                   job.first_estimate(warm_s), mesh, device)
    setup_s = t_start - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t_start     # to the end of the last whole job

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    peak = int(reduce_ranks(peak, "max", mesh, device))
    job.release()
    numbers = job.check()
    forbidden = forbidden_modules()
    n_forbidden = reduce_ranks(len(forbidden), "sum", mesh, device)

    timeline = busy = None
    if prof is not None:
        from .trace import Timeline

        timeline = Timeline.from_profile(prof)
        busy = reduce_ranks(timeline.busy_s, "sum", mesh, device) / world
    layer = {}
    if timeline is not None and rank == 0:
        rc = ReadCtx(timeline, job, rank, world)
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(rc)
            if v is not None:
                layer[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if mesh is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    if rank != 0:
        if forbidden:
            log(f"rank {rank} loaded {forbidden}")
        return None
    if n_forbidden:
        log(f"modules this benchmark may not load are loaded: {forbidden} "
            f"(rank 0), {int(n_forbidden)} names over all ranks")
        return "forbidden"

    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and set(checks) == set(cell.limits)
    transitions = sum(job.work)
    e2e = {"transitions_per_s": transitions / window_s, "setup_s": setup_s}
    metrics = ({m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end} if not opts.trace else layer)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(times), "failed": 0,
           "metrics": metrics, "device": dev}
    if timeline is not None:
        dev["busy_s"] = busy
        dev["window_s"] = timeline.window_s
        out["breakdown"] = {"device_ops": timeline.device_ops(),
                            "idle_gaps": timeline.idle_gaps()}
    out["checks"] = checks
    if device.type == "cuda":
        log(f"after the window, {STATE}: {smi(STATE)}")
    log(f"{cell.name}: {len(times)} jobs in {window_s:.3f} s "
        f"({', '.join(f'{t:.4f}' for t in times)} s each), warm job "
        f"{warm_s:.3f} s, set-up {setup_s:.3f} s, "
        f"{transitions / window_s:.6g} transitions/s, memory peak {peak}")
    return out


def _watch(children, failed: threading.Event):
    """Ends the run when a rank process fails, so that rank 0 does not
    wait in a collective for a rank that has gone."""
    while not failed.is_set():
        for p in children:
            rc = p.poll()
            if rc not in (None, 0):
                log(f"a rank process exited with {rc}")
                failed.set()
                for q in children:
                    if q.poll() is None:
                        q.kill()
                os._exit(3)
        time.sleep(0.5)


def main(argv, t0: float) -> int:
    opts = parse(argv)
    cell = resolve(opts.workload)
    set_cache_dirs()
    import torch

    world = cell.chips
    if not opts.cpu_dry_run:
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark measures the card")
            return 2
        if torch.cuda.device_count() < world:
            log(f"{opts.workload} needs {world} cards, "
                f"{torch.cuda.device_count()} present")
            return 2
        if opts.rank in (None, 0):
            log(card_line(torch, world))
    rank = opts.rank or 0
    store, children, failed = None, [], threading.Event()
    if world > 1:
        from torch.distributed import TCPStore

        if opts.rank is None:    # rank 0 starts the others
            if not opts.cpu_dry_run:     # the ranks share one build
                from glabc_tpu_torch.ops.kernels._build import load_library

                for stem in cell.config.get("kernels", ()):
                    load_library(stem)
            store = TCPStore("127.0.0.1", 0, world, is_master=True,
                             wait_for_workers=False)
            run = os.path.join(ROOT, "perfbench", "run.py")
            for r in range(1, world):
                cmd = [sys.executable, run, *argv, "--rank", str(r),
                       "--store-port", str(store.port)]
                children.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                                 cwd=ROOT))
            threading.Thread(target=_watch, args=(children, failed),
                             daemon=True).start()
        else:
            store = TCPStore("127.0.0.1", opts.store_port, world,
                             is_master=False)
    try:
        out = (calibrate(opts, cell, rank, world, store) if opts.calibrate
               else run_rank(opts, cell, rank, world, store, t0))
    finally:
        failed.set()
        for p in children:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if opts.rank not in (None, 0):
        return 4 if forbidden_modules() else 0
    if any(p.returncode != 0 for p in children):
        log(f"rank exit codes {[p.returncode for p in children]}")
        return 3
    if out == "forbidden" or out is None:
        return 4
    for k, c in out.get("checks", {}).items():   # the last lines on stderr
        log(f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(out), flush=True)
    return 0
