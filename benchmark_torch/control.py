"""The control of a cell: the plain reference with its power spectrum
rounded to bfloat16 (the step below the float32 power the configuration
states), put in the program's place. Its outputs take the program's form
and go through the cell's own comparison (``common.compare_listen``, or
``drivers.ingest.compare``) and ``check.verdict`` against the float32
reference, at the cell's own size; sound limits make it come out as
``correct`` false.

    python3 benchmark_torch/control.py --workload <cell> --seeds <n> ...

Prints one JSON line per seed: ``correct`` and the checks, each beside its
limit, as a run prints them. Drives no program and needs no card (the
tests run it on the CPU at a tiny size); the benchmark's runs never run
it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# window batches the ingest control draws its new songs from: about what
# a 30 s window of the ingest cell ingests
CONTROL_BATCHES = 512


def as_answer(ref: dict) -> dict:
    """A reference answer in the form of the program's result."""
    from benchmark_torch.lib import catalog

    if ref["song"] is None:
        return {"results": [], "total_matches": ref["total"]}
    return {"results": [{"song_name": catalog.song_name(ref["song"]),
                         "offset": ref["offset"],
                         "input_total_hashes": ref["pairs"],
                         "hashes_matched_in_input": ref["hashes_matched"]}],
            "total_matches": ref["total"]}


def listen_readings(ctx) -> dict:
    """A listener or daemon cell: the catalog's rows, the clips' pairs and
    their answers over the whole catalog, in bfloat16."""
    from benchmark_torch.lib import clips, common, refrun

    plan = clips.plan(ctx.mix, ctx.cfg["songs"],
                      int(ctx.cfg["song_s"] * ctx.fs), ctx.fs, ctx.seed)
    cutter = clips.ClipCutter(plan)
    sample, songs = common.sample_of(ctx, range(len(plan.songs)))

    def sampled():
        made = cutter.finish(ctx.mix, ctx.fs, ctx.seed)
        return {k: made[k] for k in sample}

    ref = refrun.listen(ctx.cfg, ctx.seed, ctx.device, sampled, songs,
                        [refrun.REFERENCE, "bfloat16"], on_batch=cutter.take)
    low = ref["bfloat16"]
    prog = {"sample": sample, "songs": songs,
            "answers": {k: [as_answer(low["answers"][k])] for k in sample},
            "rows": low["rows"], "pairs": low["pairs"]}
    return common.compare_listen(prog, ref[refrun.REFERENCE], plan)


def ingest_readings(ctx) -> dict:
    """The ingest cell: the rows of sampled window and catalog songs, in
    bfloat16."""
    from benchmark_torch.lib import catalog, refrun
    from benchmark_torch.lib.drivers import ingest

    bsz = int(ctx.mix["batch"])
    gen = catalog.generator(ctx.cfg, ctx.seed, ctx.device)
    mixer = ingest.Mixer(ingest.pool_of(ctx.cfg, gen,
                                        int(ctx.mix["pool_songs"])),
                         gen.n_samp, bsz, ctx.seed)
    new, old = ingest.sample_of(ctx, int(ctx.mix["warm_batches"]) * bsz,
                                CONTROL_BATCHES * bsz)
    low = ingest.reference_rows(ctx.cfg, gen, mixer, new, old, "bfloat16")
    want = ingest.reference_rows(ctx.cfg, gen, mixer, new, old,
                                 refrun.REFERENCE)
    return ingest.compare(low, want, missing=0)


READINGS = {"listen": listen_readings, "serve": listen_readings,
            "ingest": ingest_readings}


def control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{"correct", "checks"} of the control on one seed."""
    from benchmark_torch.lib import check
    from benchmark_torch.lib.common import Ctx

    ctx = Ctx(cfg, mix, seed, 0.0, False, device, time.perf_counter())
    correct, checks = check.verdict(READINGS[mix["driver"]](ctx))
    return {"correct": correct, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark_torch.run import cell_inputs, load_benchmark

    _, cfg, mix = cell_inputs(load_benchmark(), args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(cfg, mix, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "reference, power in bfloat16",
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
