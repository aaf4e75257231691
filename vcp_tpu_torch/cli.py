"""``python -m vcp_tpu_torch.cli`` (``vcp-torch``).

Copy of ``vcp_tpu``'s CLI: ``producer | consumer | stats | clean`` with
the shared ``-c/--config``, ``--log-level`` and ``--redis`` flags, plus
``redis-serve`` (the embedded mini-redis), ``quality`` (PSNR / SSIM
between two videos) and ``encode`` (one file in-process). CLI flags beat
config values beat defaults. The port and ``vcp_tpu`` speak the same
wire, so their producers and consumers can share one stream.

``consumer`` and ``encode`` take ``--device`` (default ``cuda``; they
raise without a card, and ``cpu`` runs the kernels' plain PyTorch
versions). ``vcp_tpu``'s persistent XLA compilation cache has no
counterpart here: the port compiles its kernels and host library once
into ``vcp_tpu_torch/_build/``, keyed by a hash of their sources.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .config import load_config, resolve_encode_args
from .logging import set_log_level

DEVICE_HELP = ("torch device (default cuda; cpu runs the plain PyTorch "
               "versions of the kernels)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-c", "--config", default="", help="YAML config file")
    p.add_argument("--log-level", default="",
                   choices=["", "debug", "info", "warn", "error"])
    p.add_argument("--redis", default="", help="redis address host:port "
                   "(overrides config)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="vcp-torch",
        description="vcp-tpu's transcode pipeline ported to PyTorch + "
                    "CUDA: producers watch directories and publish encode "
                    "tasks over Redis Streams; consumers encode in-process "
                    "on the GPU.")
    ap.add_argument("--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("producer", help="watch a directory and publish tasks")
    _add_common(p)
    p.add_argument("-w", "--watch-dir", default="")
    p.add_argument("-s", "--shared-dir", default="")
    p.add_argument("-o", "--output-dir", default="")
    p.add_argument("--output-prefix", default="")
    p.add_argument("-m", "--mode", default="", choices=["", "new", "all"])
    p.add_argument("-p", "--preset", default="", help="preset name")
    p.add_argument("--ffmpeg-args", default="",
                   help="raw encode args (beats --preset); values starting "
                        "with '-' need the = form: --ffmpeg-args='-c:v ...'")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--keep-local", action="store_true")
    p.add_argument("--list-presets", action="store_true",
                   help="print the preset table and exit")

    c = sub.add_parser("consumer", help="pull tasks and encode on the GPU")
    _add_common(c)
    c.add_argument("-n", "--name", default="")
    c.add_argument("-j", "--concurrency", type=int, default=0)
    c.add_argument("--device", default="cuda", help=DEVICE_HELP)

    s = sub.add_parser("stats", help="queue + history statistics")
    _add_common(s)
    s.add_argument("--days", type=int, default=7)
    s.add_argument("--pending", action="store_true")
    s.add_argument("--consumer", action="store_true")
    s.add_argument("--task", default="")

    cl = sub.add_parser("clean", help="clean queue/history")
    _add_common(cl)
    cl.add_argument("--all", action="store_true", dest="clean_all")
    cl.add_argument("--pending", action="store_true")
    cl.add_argument("--consumed", action="store_true")
    cl.add_argument("-f", "--force", action="store_true")

    r = sub.add_parser("redis-serve", help="run the embedded mini-redis")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=6379)
    r.add_argument("--password", default="",
                   help="require AUTH with this password")

    q = sub.add_parser("quality", help="PSNR/SSIM between two videos")
    q.add_argument("reference")
    q.add_argument("test")
    q.add_argument("--frames", type=int, default=0,
                   help="limit compared frames (0 = all)")

    e = sub.add_parser("encode", help="encode one file in-process")
    _add_common(e)
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("-p", "--preset", default="")
    e.add_argument("--ffmpeg-args", default="",
                   help="raw encode args; use = form: --ffmpeg-args='-c:v ...'")
    e.add_argument("--timeout", type=float, default=3600.0)
    e.add_argument("--device", default="cuda", help=DEVICE_HELP)

    return ap


def _print_presets(cfg, out=print) -> None:
    """--list-presets."""
    out(f"{'PRESET':<16} ARGS")
    for name, args in sorted(cfg.get_all_presets().items()):
        out(f"{name:<16} {args}")


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except KeyError as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0        # stdout consumer (head, less) closed early
    except (ConnectionError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        from .pipeline.executor import EncodeError
        if isinstance(e, EncodeError):
            print(f"error: {e}", file=sys.stderr)
            return 1
        raise


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "redis-serve":
        from .queue.miniredis import serve_forever
        serve_forever(args.host, args.port, password=args.password)
        return 0

    cfg = load_config(getattr(args, "config", "") or None)
    if getattr(args, "log_level", ""):
        set_log_level(args.log_level)
    if getattr(args, "redis", ""):
        cfg.redis.address = args.redis

    if args.command == "producer":
        if args.list_presets:
            _print_presets(cfg)
            return 0
        if args.watch_dir:
            cfg.producer.watch_directory = args.watch_dir
        if args.shared_dir:
            cfg.producer.shared_directory = args.shared_dir
        if args.output_dir:
            cfg.producer.output_directory = args.output_dir
        if args.output_prefix:
            cfg.producer.output_prefix = args.output_prefix
        if args.mode:
            cfg.producer.watch_mode = args.mode
        if args.no_verify:
            cfg.producer.verify_output = False
        if args.keep_local:
            cfg.producer.keep_local = True
        from .pipeline.producer import Producer
        Producer(cfg, cli_args=args.ffmpeg_args,
                 cli_preset=args.preset).run_forever()
        return 0

    if args.command == "consumer":
        from .pipeline.consumer import Consumer
        Consumer(cfg, name=args.name, concurrency=args.concurrency,
                 device=args.device).run_forever()
        return 0

    if args.command == "stats":
        from .pipeline.stats import run_stats
        return run_stats(cfg, days=args.days, pending=args.pending,
                         consumer=args.consumer, task=args.task)

    if args.command == "clean":
        from .pipeline.clean import run_clean
        return run_clean(cfg, clean_all=args.clean_all, pending=args.pending,
                         consumed=args.consumed, force=args.force)

    if args.command == "quality":
        from .quality import compare_streams
        r = compare_streams(args.reference, args.test,
                            args.frames or None)
        print(f"frames={r.frames} psnr_y={r.psnr_y:.2f}dB "
              f"(min {r.psnr_min:.2f}) ssim_y={r.ssim_y:.4f}")
        if r.ref_frames != r.test_frames:
            print(f"note: frame count mismatch "
                  f"(ref>{r.frames} or test>{r.frames})")
        return 0

    if args.command == "encode":
        import time

        from .pipeline import executor
        encode_args, src = resolve_encode_args(cfg, args.ffmpeg_args,
                                               args.preset)
        t0 = time.monotonic()
        size = executor.execute(args.input, args.output, encode_args,
                                timeout=args.timeout, device=args.device)
        dt = time.monotonic() - t0
        print(f"encoded {args.input} -> {args.output} "
              f"({size} bytes, {dt:.2f}s, args from {src})")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
