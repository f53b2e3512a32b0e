"""Key-value metrics logger: the subset of
gesturediffusion_tpu/utils/logger.py that the training loop uses.

``configure(dir)`` writes each ``dumpkvs`` to stdout as a table and, with a
directory, appends it to ``progress.json`` and ``progress.csv``.
"""

from __future__ import annotations

import csv
import json
import os
import sys
from collections import defaultdict
from typing import Optional


class Logger:
    def __init__(self, dir: Optional[str] = None):
        self.dir = dir
        self.name2val: dict = defaultdict(float)
        self.name2cnt: dict = defaultdict(int)
        if dir:
            os.makedirs(dir, exist_ok=True)

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key, val) -> None:
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> dict:
        out = dict(self.name2val)
        if out:
            self._write_stdout(out)
            if self.dir:
                self._write_files(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    @staticmethod
    def _write_stdout(kvs: dict) -> None:
        rows = [(k[:27], f"{v:<8.3g}" if hasattr(v, "__float__") else str(v)[:27])
                for k, v in sorted(kvs.items())]
        kw, vw = max(len(k) for k, _ in rows), max(len(v) for _, v in rows)
        dashes = "-" * (kw + vw + 7)
        lines = [dashes] + [f"| {k:<{kw}} | {v:<{vw}} |" for k, v in rows] + [dashes]
        sys.stdout.write("\n".join(lines) + "\n")
        sys.stdout.flush()

    def _write_files(self, kvs: dict) -> None:
        with open(os.path.join(self.dir, "progress.json"), "a") as f:
            f.write(json.dumps({k: float(v) if hasattr(v, "__float__") else v
                                for k, v in kvs.items()}) + "\n")
        path = os.path.join(self.dir, "progress.csv")
        keys, rows = [], []
        if os.path.exists(path):
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                keys, rows = list(reader.fieldnames or []), list(reader)
        keys += sorted(set(kvs) - set(keys))
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows + [{k: kvs.get(k, "") for k in keys}])


_CURRENT: Optional[Logger] = None


def configure(dir: Optional[str] = None) -> Logger:
    global _CURRENT
    _CURRENT = Logger(dir)
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
