"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the repository
root: the cell's configuration file, its traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names the general loop in
``lib/drivers/``) and each per-layer metric's reader
(``metrics/<metric>.py``). The program under test is ``shazam_tpu_torch``
on the card; a run without a card (or with fewer than the cell asks for)
exits 2 and prints no result. The last line of standard output is the
result's JSON object; the last lines of standard error are the numbers
that decide ``correct``, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a checkout's first run builds (the program's own CUDA
    build directory is ``shazam_tpu_torch/_build/``, also inside it)."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_inputs(bench: dict, workload: str, root: Path = ROOT):
    """(the cell's entry, its configuration, its traffic mix)."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, cfg, mix


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metric(name: str, obs: dict):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, cfg=None, mix=None,
             root: Path = ROOT) -> dict:
    """One run of one cell: the result's JSON object. ``cfg`` and ``mix``
    replace the files' (the harness's tests run tiny ones on the CPU)."""
    from benchmark_torch.lib import check
    from benchmark_torch.lib.common import Ctx

    wl, file_cfg, file_mix = cell_inputs(bench, workload, root)
    ctx = Ctx(cfg or file_cfg, mix or file_mix, seed, seconds, trace,
              device, t_start)
    driver = importlib.import_module(
        f"benchmark_torch.lib.drivers.{ctx.mix['driver']}")
    out = driver.run(ctx)
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if _applies(m, workload):
                v = read_metric(m["name"], out.obs)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if _applies(m, workload):
                v = (out.setup_s if m["name"] == "setup_s"
                     else out.end_to_end[m["name"]])
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, checks = check.verdict(out.readings)
    correct = correct and out.attempted > 0
    if device.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(device)
        dev = {"platform": "gpu", "kind": kind, "count": wl["chips"],
               "memory_peak_bytes": out.memory_peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.device_ops(),
                               "idle_gaps": out.trace.idle_gaps}
        print(f"trace: {out.trace.units} units, {out.trace.launches} "
              f"launches, {out.trace.lost} kernel records lost",
              file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    bench = load_benchmark()
    wl, _, _ = cell_inputs(bench, args.workload)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
