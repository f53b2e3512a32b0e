"""Key-value metrics logger.

PyTorch-port copy of gesturediffusion_tpu/utils/logger.py (framework-free
there too): the OpenAI-baselines surface of the reference's
diffusion/logger.py -- ``logkv`` / ``logkv_mean`` / ``dumpkvs``, the
stdout, log, json, csv and tensorboard sinks, ``profile_kv`` wall-time
scopes, and ``configure`` honouring ``OPENAI_LOGDIR`` / ``OPENAI_LOG_FORMAT``.
For the same dumps it writes the same bytes as the JAX logger.  One
process's logger: a multi-rank train loop configures it on rank 0 and
gives the other ranks stdout only (train/loop.py).
"""

from __future__ import annotations

import contextlib
import csv as _csv
import json
import os
import sys
import time
from collections import defaultdict
from typing import Optional


class KVWriter:
    def writekvs(self, kvs: dict) -> None:
        raise NotImplementedError


class HumanOutputFormat(KVWriter):
    """The table of one dump: keys and string values past 30 characters cut
    to 27 and marked with ``...``; an empty dump prints nothing."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def writekvs(self, kvs: dict) -> None:
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._trunc(key)] = self._trunc(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items()):
            lines.append(
                f"| {key}{' ' * (keywidth - len(key))} | "
                f"{val}{' ' * (valwidth - len(val))} |"
            )
        lines.append(dashes)
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()

    @staticmethod
    def _trunc(s: str, maxlen: int = 30) -> str:
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s


class JSONOutputFormat(KVWriter):
    def __init__(self, filename: str):
        self.file = open(filename, "at")

    def writekvs(self, kvs: dict) -> None:
        out = {
            k: float(v) if hasattr(v, "__float__") else v for k, v in kvs.items()
        }
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()


class CSVOutputFormat(KVWriter):
    def __init__(self, filename: str):
        self.filename = filename
        self.keys: list[str] = []
        # resume: adopt the existing file's header, else the first dump
        # (whose kvs may lack e.g. eval/* columns) would rewrite with a
        # narrower header and DictWriter dies on the old rows' extras
        if os.path.exists(filename):
            with open(filename) as f:
                header = f.readline().strip()
            if header:
                self.keys = header.split(",")

    def writekvs(self, kvs: dict) -> None:
        extra = sorted(set(kvs.keys()) - set(self.keys))
        if extra:
            self.keys += extra
            # rewrite with the widened header
            rows = []
            if os.path.exists(self.filename):
                with open(self.filename) as f:
                    rows = list(_csv.DictReader(f))
            with open(self.filename, "w", newline="") as f:
                w = _csv.DictWriter(f, fieldnames=self.keys)
                w.writeheader()
                for row in rows:
                    w.writerow(row)
        with open(self.filename, "a", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=self.keys)
            w.writerow({k: kvs.get(k, "") for k in self.keys})


class TensorBoardOutputFormat(KVWriter):
    """Scalars through torch's SummaryWriter, a step a dump (the reference's
    'tensorboard' format, diffusion/logger.py:150).  Needs the optional
    ``tensorboard`` package and says so when it is missing."""

    def __init__(self, dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                f"log format 'tensorboard' needs the 'tensorboard' package, which is "
                f"not installed ({e}); choose stdout, log, json or csv") from e

        os.makedirs(dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=dir)
        self.step = 1

    def writekvs(self, kvs: dict) -> None:
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), self.step)
        self.writer.flush()
        self.step += 1


def make_output_format(fmt: str, ev_dir: Optional[str],
                       log_suffix: str = "") -> KVWriter:
    """Format name -> sink (reference: diffusion/logger.py:160-190)."""
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if not ev_dir:  # None or "": both unusable as a directory
        raise ValueError(
            f"log format {fmt!r} needs a log dir (set OPENAI_LOGDIR or "
            "pass a non-empty dir to configure())"
        )
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "log":
        return HumanOutputFormat(
            open(os.path.join(ev_dir, f"log{log_suffix}.txt"), "at")
        )
    if fmt == "json":
        return JSONOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(os.path.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    """Accumulates key-values and writes each dump to its sinks: by default
    stdout, and with a dir ``progress.json`` and ``progress.csv``."""

    def __init__(self, dir: Optional[str] = None, output_formats=None):
        self.dir = dir
        self.name2val: dict = defaultdict(float)
        self.name2cnt: dict = defaultdict(int)
        if output_formats is None:
            output_formats = [HumanOutputFormat()]
            if dir:
                os.makedirs(dir, exist_ok=True)
                output_formats += [
                    JSONOutputFormat(os.path.join(dir, "progress.json")),
                    CSVOutputFormat(os.path.join(dir, "progress.csv")),
                ]
        self.output_formats = output_formats

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key, val) -> None:
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> dict:
        out = dict(self.name2val)
        for fmt in self.output_formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    @contextlib.contextmanager
    def profile_kv(self, name: str):
        """Add the scope's wall time to ``wait_<name>``."""
        start = time.time()
        try:
            yield
        finally:
            self.name2val[f"wait_{name}"] = (
                self.name2val.get(f"wait_{name}", 0.0) + time.time() - start
            )


_CURRENT: Optional[Logger] = None


def configure(dir: Optional[str] = None, format_strs: Optional[list] = None) -> Logger:
    """Configure the process's logger (reference: diffusion/logger.py:
    442-467): ``OPENAI_LOGDIR`` fills in the dir only when none was passed,
    ``OPENAI_LOG_FORMAT`` is a comma-separated list of sinks (stdout, log,
    json, csv, tensorboard) used when ``format_strs`` is None, and file
    sinks without a dir write to a new temporary dir."""
    global _CURRENT
    if not dir:
        dir = os.environ.get("OPENAI_LOGDIR")
    if format_strs is None:
        env_fmt = os.environ.get("OPENAI_LOG_FORMAT")
        if env_fmt:
            format_strs = [f for f in env_fmt.split(",") if f]
    if format_strs is not None and not dir and any(f != "stdout" for f in format_strs):
        import tempfile

        dir = tempfile.mkdtemp(prefix="gdt-logs-")
    if format_strs is not None:
        _CURRENT = Logger(dir=dir, output_formats=[make_output_format(f, dir)
                                                   for f in format_strs])
    else:
        _CURRENT = Logger(dir=dir)
    return _CURRENT


def get_current() -> Logger:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = Logger()
    return _CURRENT


def logkv(key, val) -> None:
    get_current().logkv(key, val)


def logkv_mean(key, val) -> None:
    get_current().logkv_mean(key, val)


def dumpkvs() -> dict:
    return get_current().dumpkvs()


def log(*args) -> None:
    print(*args, flush=True)
