"""Command-line interface: ingest / recognize / bench / stats / fsck /
sanity / plot / listen / metadata / serve / synth.

The port of ``shazam_tpu/cli.py``. The reference drives everything through
per-script ``__main__`` blocks with hand-edited config constants
(``__init__.py:417-432``, ``recognizer.py:355-398``,
``recognizer_test.py:516-614``); here the same
workflows are argparse subcommands over one persistent catalog+index pair
(--db PREFIX -> PREFIX.sqlite + PREFIX.npz, the files the JAX package
reads and writes). Everything runs on the card unless ``--device cpu``
is given.

    python -m shazam_tpu_torch.cli --db X ingest songs/
    python -m shazam_tpu_torch.cli --db X serve --port 8080
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def load_config(path: str):
    """A ``FingerprintConfig`` from a JSON file of its fields, such as the
    JAX package's ``to_json()``. A field the port does not have, or a
    value it cannot honor, is refused, not silently ignored."""
    from .config import FingerprintConfig

    with open(path) as fh:
        fields = json.load(fh)
    known = {f.name for f in dataclasses.fields(FingerprintConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        sys.exit(f"{path}: fields the port does not honor: {unknown}")
    try:
        return FingerprintConfig(**fields)
    except ValueError as e:
        sys.exit(f"{path}: {e}")


def _open_sia(args, need_index: bool):
    from .api import SIA
    from .config import FingerprintConfig

    config = load_config(args.config) if args.config else FingerprintConfig()
    sia = SIA(config=config, catalog_path=args.db + ".sqlite",
              device_resident=getattr(args, "device_resident", False),
              device_span_rows=getattr(args, "span_rows", 0) or 0,
              device=args.device)
    index_path = args.db + ".npz"
    if os.path.exists(index_path):
        sia.load_index(index_path)
    elif need_index:
        sys.exit(f"no index at {index_path}; run `ingest` first")
    return sia


def cmd_ingest(args):
    sia = _open_sia(args, need_index=False)
    stats = sia.ingest_directory(
        args.path,
        extensions=args.extensions.split(","),
        limit=args.limit,
        batch_size=args.batch_size,
        verbose=True,
    )
    sia.save_index(args.db + ".npz")
    print(json.dumps(stats, default=str))


def cmd_recognize(args):
    sia = _open_sia(args, need_index=True)
    out = sia.recognize_file(args.file, limit=args.limit, topn=args.topn,
                             early_exit=args.early_exit)
    print(json.dumps(out, default=str, indent=2))
    if out["results"]:
        top = out["results"][0]
        md = sia.get_metadata(_maybe_int(top["song_name"]))
        if md:
            print("metadata:", json.dumps(md))


def _maybe_int(name):
    try:
        return int(name)
    except (TypeError, ValueError):
        return -1


def cmd_bench(args):
    from .audio.io import find_files
    from .bench.harness import BenchConfig, run_recognition_sweep

    sia = _open_sia(args, need_index=True)
    songs = sorted(p for p, _ in find_files(args.path, args.extensions.split(",")))
    if args.limit_songs:
        songs = songs[: args.limit_songs]
    cfg = BenchConfig(
        record_seconds=args.seconds,
        add_noise=args.snr is not None,
        snr_db=args.snr if args.snr is not None else 0.0,
        noise_kind="awgn" if args.awgn else "file",
        noise_file=args.noise_file,
        channel=args.channel,
        channel_severity=args.channel_severity,
        topn=args.topn,
        seed=args.seed,
        out_dir=args.out_dir,
    )
    summary = run_recognition_sweep(sia, songs, cfg)
    summary.pop("predicted", None)
    print(json.dumps(summary, default=str, indent=2))


def cmd_stats(args):
    from .tools.stats import dump_song_hash_stats

    sia = _open_sia(args, need_index=False)
    out = dump_song_hash_stats(sia.catalog, csv_path=args.out)
    out["index_hashes"] = sia.index.n_hashes
    print(json.dumps(out, default=str, indent=2))


def cmd_fsck(args):
    from .tools.fsck import check_integrity

    sia = _open_sia(args, need_index=True)
    if sia.index.n_hashes:
        sia._ensure_device_index()   # check the uploaded copy too
    report = check_integrity(sia, deep=not args.fast)
    print(json.dumps(report, default=str, indent=2))
    if not report["ok"]:
        sys.exit(1)


def cmd_sanity(args):
    from .audio.io import find_files
    from .tools.sanity import check_corpus_sanity

    files = [p for p, _ in find_files(args.path, args.extensions.split(","))]
    out = check_corpus_sanity(files, record_seconds=args.seconds,
                              delete=args.delete)
    print(json.dumps(out, default=str, indent=2))


def cmd_plot(args):
    from .audio.io import read
    from .config import FingerprintConfig
    from .tools.plot import plot_constellation

    # honor --config: the plot must show the peaks the PIPELINE extracts
    cfg = load_config(args.config) if args.config else FingerprintConfig()
    channels, fs, _ = read(args.file, limit=args.limit)
    path = plot_constellation(
        channels[0], args.out, fs=fs, amp_min=cfg.amp_min,
        radius=cfg.peak_neighborhood_size,
        title=os.path.basename(args.file), device=args.device)
    print(json.dumps({"plot": path}))


def cmd_listen(args):
    """One-shot mic recognition (reference recognizer.py main path)."""
    from .stream import recognize_from_mic

    sia = _open_sia(args, need_index=True)
    out = recognize_from_mic(sia, seconds=args.seconds,
                             channels=args.channels, topn=args.topn)
    print(json.dumps(out, default=str, indent=2))


def cmd_metadata(args):
    sia = _open_sia(args, need_index=False)
    n = sia.catalog.import_metadata_csv(args.csv)
    print(json.dumps({"imported": n}))


def cmd_serve(args):
    from .serve import RecognitionServer, warmup

    sia = _open_sia(args, need_index=True)
    if args.consolidate:
        sia.consolidate_index()
    if args.warmup:
        print("warming serving paths...", flush=True)
        extra = [float(s) for s in args.warm_lengths.split(",") if s] \
            if args.warm_lengths else []
        tiers = [int(s) for s in args.warm_tiers.split(",") if s] \
            if args.warm_tiers else []
        warmup(sia, seconds=args.warmup, max_batch=args.max_batch,
               clip_lengths=extra,
               stream_window_seconds=args.warm_stream,
               capacity_tiers=tiers,
               pin_capacity=args.pin_tier or None)
    server = RecognitionServer(
        sia, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        request_timeout_s=args.request_timeout,
        max_clip_seconds=args.max_clip_seconds,
        max_ingest_seconds=args.max_ingest_seconds,
        persist_path=(args.db + ".npz") if args.persist else None,
        max_streams=args.max_streams, stream_ttl_s=args.stream_ttl,
        auth_token=args.auth_token or os.environ.get("SHAZAM_SERVE_TOKEN"),
        pipeline=not args.no_pipeline,
        pin_capacity=args.pin_tier or None,
    )
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "songs": sia.catalog.counts()["n_songs"],
                      "hashes": sia._live_n_hashes()}), flush=True)
    server.install_signal_handlers()  # SIGTERM/SIGINT -> graceful stop
    server.serve_forever()
    print(json.dumps({"stopped": True, **server.batcher.stats}), flush=True)


def cmd_synth(args):
    from .audio.synth import synth_corpus

    files = synth_corpus(args.path, args.n, duration_s=args.seconds,
                         seed=args.seed)
    print(json.dumps({"generated": len(files), "dir": args.path}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shazam-tpu-torch",
        description="audio fingerprinting on PyTorch and CUDA")
    p.add_argument("--db", default="sia_catalog",
                   help="catalog prefix (PREFIX.sqlite + PREFIX.npz)")
    p.add_argument("--config", default=None,
                   help="FingerprintConfig JSON file (the port's fields)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("ingest", help="fingerprint a folder into the index")
    s.add_argument("path")
    s.add_argument("--extensions", default=".wav,.mp3")
    s.add_argument("--limit", type=float, default=None,
                   help="seconds per file to fingerprint")
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--device-resident", action="store_true",
                   help="merge fingerprints into an index held on the "
                        "device (index/devmerge.py): no host merges")
    s.add_argument("--span-rows", type=int, default=0,
                   help="a spanned index (implies --device-resident): "
                        "saved span-wise in chunks of this many rows, the "
                        "JAX package's format")
    s.set_defaults(fn=cmd_ingest)

    s = sub.add_parser("recognize", help="identify one audio file")
    s.add_argument("file")
    s.add_argument("--limit", type=float, default=None)
    s.add_argument("--topn", type=int, default=2)
    s.add_argument("--early-exit", action="store_true",
                   help="stop matching once the leader has twice the "
                        "runner-up's matched hashes (match/apriori.py)")
    s.add_argument("--device-resident", action="store_true",
                   help="serve the index from a device store")
    s.add_argument("--span-rows", type=int, default=0,
                   help="a spanned index (implies --device-resident)")
    s.set_defaults(fn=cmd_recognize)

    s = sub.add_parser("bench", help="recognition accuracy/latency sweep")
    s.add_argument("path", help="corpus folder")
    s.add_argument("--extensions", default=".wav,.mp3")
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--snr", type=float, default=None,
                   help="mix noise at this SNR (dB)")
    s.add_argument("--awgn", action="store_true", help="use AWGN noise")
    s.add_argument("--noise-file", default=None)
    s.add_argument("--channel", action="store_true",
                   help="pass query clips through the synthetic acoustic "
                        "loop (speaker band-limit, room reverb, soft clip, "
                        "noise floor — audio/channel.py)")
    s.add_argument("--channel-severity", type=float, default=1.0,
                   help="how harsh the channel draws are: 1.0 = stress "
                        "rig (default), audio.channel.CALIBRATED_SEVERITY "
                        "matches the reference's real loopback band")
    s.add_argument("--topn", type=int, default=3)
    s.add_argument("--seed", type=int, default=1234)
    s.add_argument("--out-dir", default="bench_out")
    s.add_argument("--limit-songs", type=int, default=None)
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("stats", help="dump per-song hash stats CSV")
    s.add_argument("--out", default="song_hashes.csv")
    s.set_defaults(fn=cmd_stats)

    s = sub.add_parser(
        "fsck", help="validate index/catalog integrity invariants")
    s.add_argument("--fast", action="store_true",
                   help="skip the per-song row-count reconcile")
    s.set_defaults(fn=cmd_fsck)

    s = sub.add_parser("sanity", help="validate corpus decodability/length")
    s.add_argument("path")
    s.add_argument("--extensions", default=".wav,.mp3")
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--delete", action="store_true")
    s.set_defaults(fn=cmd_sanity)

    s = sub.add_parser("plot", help="render spectrogram + constellation PNG")
    s.add_argument("file")
    s.add_argument("--out", default="constellation.png")
    s.add_argument("--limit", type=float, default=None)
    s.set_defaults(fn=cmd_plot)

    s = sub.add_parser("listen", help="record from the microphone and identify")
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--channels", type=int, default=2)
    s.add_argument("--topn", type=int, default=2)
    s.set_defaults(fn=cmd_listen)

    s = sub.add_parser("metadata", help="bulk-import FMA-style metadata CSV")
    s.add_argument("csv")
    s.set_defaults(fn=cmd_metadata)

    s = sub.add_parser(
        "serve", help="HTTP recognition daemon (micro-batched dispatches)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--max-batch", type=int, default=16,
                   help="largest micro-batch per device dispatch")
    s.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="how long the first request waits for companions")
    s.add_argument("--no-pipeline", action="store_true",
                   help="disable the two-stage fingerprint/match "
                        "pipeline (one batch in flight at a time)")
    s.add_argument("--warmup", type=float, default=5.0, metavar="SECONDS",
                   help="before listening, run the serving paths once with "
                        "clips this long (0 disables)")
    s.add_argument("--warm-lengths", default="", metavar="S1,S2,...",
                   help="additional clip durations to warm")
    s.add_argument("--warm-stream", type=float, default=0.0,
                   metavar="WINDOW_SECONDS",
                   help="also run one /stream session per engine with this "
                        "window (0 disables)")
    s.add_argument("--warm-tiers", default="", metavar="CAP1,CAP2,...",
                   help="also warm batches at these match-capacity tiers")
    s.add_argument("--pin-tier", type=int, default=0, metavar="CAP",
                   help="dispatch every micro-batch at this match-"
                        "capacity tier (per-clip escalation still covers "
                        "outliers)")
    s.add_argument("--request-timeout", type=float, default=600.0,
                   help="seconds a request waits for its result")
    s.add_argument("--max-clip-seconds", type=float, default=60.0,
                   help="reject clips longer than this before any device "
                        "work")
    s.add_argument("--max-ingest-seconds", type=float, default=600.0,
                   help="reject POST /ingest songs longer than this")
    s.add_argument("--max-streams", type=int, default=8,
                   help="concurrent /stream sessions (each holds a "
                        "window of incremental fingerprint state)")
    s.add_argument("--stream-ttl", type=float, default=300.0,
                   help="seconds of inactivity before a /stream session "
                        "is evicted")
    s.add_argument("--persist", action="store_true",
                   help="save the index after every online ingest (full "
                        "rewrite per song; without it, rows ingested via "
                        "POST /ingest live only in this process and the "
                        "next load purges their catalog entries)")
    s.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on "
                        "catalog mutations (/ingest, /delete, /save); "
                        "prefer the SHAZAM_SERVE_TOKEN env var to keep "
                        "the secret out of the process list")
    s.add_argument("--device-resident", action="store_true",
                   help="serve the index from a device store: online "
                        "ingests merge on the device")
    s.add_argument("--span-rows", type=int, default=0,
                   help="a spanned index (implies --device-resident): "
                        "/save writes it span-wise")
    s.add_argument("--consolidate", action="store_true",
                   help="the JAX package's stacked serving layout; the "
                        "port's store is already one search round, so "
                        "this changes nothing and ingest stays open")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("synth", help="generate a deterministic WAV corpus")
    s.add_argument("path")
    s.add_argument("-n", type=int, default=10)
    s.add_argument("--seconds", type=float, default=30.0)
    s.add_argument("--seed", type=int, default=1234)
    s.set_defaults(fn=cmd_synth)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
