"""Config loading and the preset table.

Copy of ``vcp_tpu/config.py``: the YAML schema ``redis / producer /
consumer / presets``, the builtin table of 7 presets, the defaults
(redis at localhost:6379, concurrency 1, watch mode ``new``, preset
``h264-nvenc``), custom presets overriding builtin ones, and the
priority chain of the encode arguments: CLI --ffmpeg-args > CLI
--preset > config ffmpeg_args > config ffmpeg_preset > default preset.
The keys ``redis.stream_max_length``, ``redis.publish_rate_limit``,
``consumer.ffmpeg_timeout``, ``consumer.file_wait_timeout`` and
``consumer.verify_output`` are parsed and honored, as there. The
consumer's device is not part of the schema: it is an argument of
``Consumer`` and the CLI's ``--device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

try:
    import yaml
except ImportError:  # pragma: no cover - pyyaml is expected in the image
    yaml = None

# Builtin preset table. The argument strings keep ffmpeg's spelling so user
# configs carry over unchanged; codec.args parses them into encoder
# parameters.
BUILTIN_PRESETS: dict[str, str] = {
    "h264-nvenc": "-c:v h264_nvenc -preset p4 -b:v 10M -c:a aac -b:a 128k -movflags +faststart",
    "h264-nvenc-hq": "-c:v h264_nvenc -preset p7 -tune hq -b:v 15M -maxrate 20M -bufsize 30M -c:a aac -b:a 192k -movflags +faststart",
    "h265-nvenc": "-c:v hevc_nvenc -preset p4 -b:v 8M -c:a aac -b:a 128k -movflags +faststart",
    "h265-nvenc-hq": "-c:v hevc_nvenc -preset p7 -tune hq -b:v 10M -c:a aac -b:a 192k -movflags +faststart",
    "h264-cpu": "-c:v libx264 -preset medium -crf 23 -c:a aac -b:a 128k -movflags +faststart",
    "h265-cpu": "-c:v libx265 -preset medium -crf 28 -c:a aac -b:a 128k -movflags +faststart",
    "copy": "-c copy",
}

DEFAULT_PRESET = "h264-nvenc"


@dataclasses.dataclass
class RedisConfig:
    address: str = "localhost:6379"
    password: str = ""
    db: int = 0
    stream_max_length: int = 1000
    publish_rate_limit: int = 100   # tasks per second


@dataclasses.dataclass
class ProducerConfig:
    watch_directory: str = ""
    shared_directory: str = ""
    output_directory: str = ""
    output_prefix: str = ""
    ffmpeg_preset: str = ""
    ffmpeg_args: str = ""
    verify_output: bool = True
    watch_mode: str = "new"         # new | all
    keep_local: bool = False


@dataclasses.dataclass
class ConsumerConfig:
    name: str = ""
    concurrency: int = 1
    ffmpeg_timeout: float = 3600.0     # encode timeout, seconds
    file_wait_timeout: float = 30.0    # shared-storage visibility wait
    verify_output: bool = True


@dataclasses.dataclass
class Config:
    redis: RedisConfig = dataclasses.field(default_factory=RedisConfig)
    producer: ProducerConfig = dataclasses.field(default_factory=ProducerConfig)
    consumer: ConsumerConfig = dataclasses.field(default_factory=ConsumerConfig)
    presets: dict[str, str] = dataclasses.field(default_factory=dict)

    def get_redis_addr(self) -> str:
        return self.redis.address

    def get_preset(self, name: str) -> Optional[str]:
        """Custom preset overrides builtin."""
        if name in self.presets:
            return self.presets[name]
        return BUILTIN_PRESETS.get(name)

    def get_all_presets(self) -> dict[str, str]:
        """Merged builtin + custom table."""
        merged = dict(BUILTIN_PRESETS)
        merged.update(self.presets)
        return merged


def _fill(dc, data: dict):
    """Overlay YAML values onto a dataclass, coercing to the default's type."""
    for f in dataclasses.fields(dc):
        if not data or f.name not in data or data[f.name] is None:
            continue
        v = data[f.name]
        cur = getattr(dc, f.name)
        try:
            if isinstance(cur, bool):
                v = v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            elif isinstance(cur, str):
                v = str(v)
        except (TypeError, ValueError):
            continue
        setattr(dc, f.name, v)
    return dc


def load_config(path: str | None) -> Config:
    """Load YAML config; missing file/path yields pure defaults.

    Address, concurrency, watch_mode and ffmpeg_preset get defaults when
    unset.
    """
    cfg = Config()
    data = {}
    if path:
        if yaml is None:
            raise RuntimeError("pyyaml not available; cannot parse config file")
        with open(path, "r", encoding="utf-8") as fh:
            data = yaml.safe_load(fh) or {}
    _fill(cfg.redis, data.get("redis") or {})
    _fill(cfg.producer, data.get("producer") or {})
    _fill(cfg.consumer, data.get("consumer") or {})
    presets = data.get("presets") or {}
    cfg.presets = {str(k): str(v) for k, v in presets.items()}

    # Defaults.
    if not cfg.redis.address:
        cfg.redis.address = "localhost:6379"
    if cfg.consumer.concurrency <= 0:
        cfg.consumer.concurrency = 1
    if not cfg.producer.watch_mode:
        cfg.producer.watch_mode = "new"
    if not cfg.producer.ffmpeg_preset:
        cfg.producer.ffmpeg_preset = DEFAULT_PRESET
    return cfg


def resolve_encode_args(
    cfg: Config,
    cli_args: str = "",
    cli_preset: str = "",
) -> tuple[str, str]:
    """Resolve the task's encode argument string.

    5-level priority chain:
      1. CLI --ffmpeg-args
      2. CLI --preset
      3. config producer.ffmpeg_args
      4. config producer.ffmpeg_preset
      5. default preset (h264-nvenc)

    Returns ``(args, source_description)``. Raises KeyError for an unknown
    preset name.
    """
    if cli_args.strip():
        return cli_args.strip(), "cli:ffmpeg-args"
    if cli_preset.strip():
        args = cfg.get_preset(cli_preset.strip())
        if args is None:
            raise KeyError(f"unknown preset: {cli_preset}")
        return args, f"cli:preset:{cli_preset}"
    if cfg.producer.ffmpeg_args.strip():
        return cfg.producer.ffmpeg_args.strip(), "config:ffmpeg_args"
    if cfg.producer.ffmpeg_preset.strip():
        name = cfg.producer.ffmpeg_preset.strip()
        args = cfg.get_preset(name)
        if args is None:
            raise KeyError(f"unknown preset: {name}")
        return args, f"config:preset:{name}"
    return BUILTIN_PRESETS[DEFAULT_PRESET], f"default:{DEFAULT_PRESET}"
