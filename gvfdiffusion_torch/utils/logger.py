"""KV logger with mean accumulation, several output formats and profiling
scopes (port of gvfdiffusion_tpu/utils/logger.py, an OpenAI-baselines-style
logger).

`configure(dir)` sets the global logger: by default $LOGDIR (or a dated
directory under the system's temporary directory) and the formats of
$GVF_LOG_FORMAT (default "stdout,log,csv": a table on stdout, `log.txt` and
`progress.csv` in the directory). `logkv` / `logkv_mean` collect values and
`dumpkvs` writes them to every format; `log` prints a message to stderr.
The "tensorboard" format writes through `torch.utils.tensorboard` and
raises ImportError where the `tensorboard` package is absent, as JAX's
flax writer does.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, Optional

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self):
        pass


class HumanOutputFormat(KVWriter):
    """A table of the keys in sorted order, floats as %-8.3g; closes the
    file on close() only when it opened it (`own`)."""

    def __init__(self, file, own: bool = False):
        self.file = file
        self.own = own

    def writekvs(self, kvs):
        key2str = {k: f"{v:<8.3g}" if isinstance(v, float) else str(v)
                   for k, v in sorted(kvs.items())}
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for k, v in sorted(key2str.items()):
            lines.append(f"| {k:<{keywidth}} | {v:<{valwidth}} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    def close(self):
        if self.own:
            self.file.close()


class JSONOutputFormat(KVWriter):
    def __init__(self, filename):
        self.file = open(filename, "at")

    def writekvs(self, kvs):
        self.file.write(json.dumps({k: float(v) if hasattr(v, "item") else v
                                    for k, v in kvs.items()}) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """One row a dump; a new key rewrites the header and pads the old
    rows."""

    def __init__(self, filename):
        self.filename = filename
        self.keys = []

    def writekvs(self, kvs):
        extra = sorted(set(kvs.keys()) - set(self.keys))
        if extra:
            self.keys += extra
            rows = []
            if os.path.exists(self.filename):
                with open(self.filename) as f:
                    rows = list(csv.reader(f))[1:]
            with open(self.filename, "wt", newline="") as f:
                w = csv.writer(f)
                w.writerow(self.keys)
                for r in rows:
                    w.writerow(r + [""] * (len(self.keys) - len(r)))
        with open(self.filename, "at", newline="") as f:
            csv.writer(f).writerow([kvs.get(k, "") for k in self.keys])


class TensorBoardOutputFormat(KVWriter):
    """Scalars under their keys at step `kvs["step"]` (else a running
    count)."""

    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self.step = step + 1
        self.writer.flush()

    def close(self):
        self.writer.close()


def make_output_format(fmt: str, ev_dir: str,
                       log_suffix: str = "") -> KVWriter:
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(
            open(os.path.join(ev_dir, f"log{log_suffix}.txt"), "at"),
            own=True)
    if fmt == "json":
        return JSONOutputFormat(os.path.join(ev_dir,
                                             f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir,
                                            f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(os.path.join(ev_dir,
                                                    f"tb{log_suffix}"))
    raise ValueError(f"Unknown format {fmt}")


class Logger:
    CURRENT: Optional["Logger"] = None

    def __init__(self, dir: Optional[str], output_formats):
        self.name2val: Dict[str, Any] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        d = dict(self.name2val)
        for fmt in self.output_formats:
            fmt.writekvs(d)
        self.name2val.clear()
        self.name2cnt.clear()
        return d

    def log(self, *args, level=INFO):
        if self.level <= level:
            print(*args, file=sys.stderr, flush=True)

    def close(self):
        for f in self.output_formats:
            f.close()


def configure(dir: Optional[str] = None, format_strs=None, log_suffix=""):
    """Set up the global logger in `dir` (else $LOGDIR, else a dated
    directory under the system's temporary directory) with `format_strs`
    (else $GVF_LOG_FORMAT, else stdout, log and csv); returns it. A logger
    configured before is closed."""
    if dir is None:
        dir = os.environ.get("LOGDIR") or os.path.join(
            tempfile.gettempdir(), f"gvf-{time.strftime('%Y-%m-%d-%H-%M-%S')}")
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = os.environ.get("GVF_LOG_FORMAT",
                                     "stdout,log,csv").split(",")
    output_formats = [make_output_format(f, dir, log_suffix)
                      for f in format_strs if f]
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    return Logger.CURRENT


def get_current() -> Logger:
    if Logger.CURRENT is None:
        configure()
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args, **kw):
    get_current().log(*args, **kw)


def get_dir():
    return get_current().dir


@contextlib.contextmanager
def profile_kv(scopename: str):
    """Accumulate the scope's wall seconds under wait_<scopename>."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        get_current().name2val[logkey] += time.time() - tstart


def profile(n: str):
    """Decorator form of profile_kv."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)

        return wrapper

    return decorator


def save_args(args, dir=None):
    """The run's arguments as `args.json` (their reprs)."""
    dir = dir or get_dir()
    d = vars(args) if hasattr(args, "__dict__") else dict(args)
    with open(os.path.join(dir, "args.json"), "w") as f:
        json.dump({k: repr(v) for k, v in d.items()}, f, indent=2)
