"""Port parity of utils/logger.py against the JAX package's on the CPU.

The same dumps through both loggers write the same bytes: ``progress.json``,
``progress.csv`` (an empty dump, a dump that widens the header, and a
second ``configure`` that resumes onto the file) and ``log.txt``, and the
same stdout table (keys and values past 30 characters cut to 27 and
``...``).  The environment contract (``OPENAI_LOGDIR``,
``OPENAI_LOG_FORMAT``) is replayed from the JAX package's
tests/test_round2_fixes.py on both loggers, with the same outcome.  Then
``profile_kv``, the tensorboard sink, and the train loop: rank 0 follows
the contract, a rank that does not write writes no file whatever the
environment says.
"""

import glob
import io
import os
import re
import sys
import tempfile
import time

import numpy as np
import pytest

from gesturediffusion_tpu.utils import logger as jax_logger
from gesturediffusion_tpu_torch.utils import logger as port_logger

LIBS = {"jax": jax_logger, "port": port_logger}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("OPENAI_LOGDIR", raising=False)
    monkeypatch.delenv("OPENAI_LOG_FORMAT", raising=False)


def _dumps(lib, root: str, capsys) -> str:
    """A run, a resume onto its files, and what the two printed."""
    log = lib.configure(root, format_strs=["stdout", "log", "json", "csv"])
    log.logkv_mean("loss", 0.25)
    log.logkv_mean("loss", np.float32(0.5))
    log.logkv("step", 0)
    log.logkv("tag", "a string value")
    log.dumpkvs()
    log.dumpkvs()  # empty
    log.logkv("step", 10)
    log.logkv("eval/diversity_of_generated_samples", 1.25e-3)  # widens the header
    log.logkv("loss", float("nan"))
    log.dumpkvs()
    log.logkv("step", 20)
    log.dumpkvs()
    # a resumed run: the csv keeps its header, and widens it again
    log = lib.configure(root, format_strs=["log", "json", "csv"])
    log.logkv("step", 30)
    log.logkv("eval/wall_s", 7)
    log.dumpkvs()
    log.logkv("loss", 0.125)
    log.dumpkvs()
    return capsys.readouterr().out


def test_files_and_stdout_are_jax_byte_for_byte(tmp_path, capsys):
    printed = {name: _dumps(lib, str(tmp_path / name), capsys) for name, lib in LIBS.items()}
    assert printed["port"] == printed["jax"]
    assert "eval/diversity_of_generated..." in printed["port"]
    for f in ("progress.json", "progress.csv", "log.txt"):
        got = (tmp_path / "port" / f).read_bytes()
        assert got == (tmp_path / "jax" / f).read_bytes(), f
    assert (tmp_path / "port" / "progress.json").read_text().splitlines()[1] == "{}"
    header, *rows = (tmp_path / "port" / "progress.csv").read_text().splitlines()
    assert header == "loss,step,tag,eval/diversity_of_generated_samples,eval/wall_s"
    assert len(rows) == 6


@pytest.mark.parametrize("key_len", [27, 30, 40])
def test_stdout_table_cuts_as_jax(key_len):
    kvs = {"k" * (key_len - 2) + "_x": 0.5, "s": "v" * 40, "n": 12345678.0}
    out = {}
    for name, lib in LIBS.items():
        stream = io.StringIO()
        lib.HumanOutputFormat(stream).writekvs(kvs)
        out[name] = stream.getvalue()
    assert out["port"] == out["jax"]
    key = "k" * (key_len - 2) + "_x"
    assert (key[:27] + "..." if key_len > 30 else key) in out["port"]
    assert "v" * 27 + "..." in out["port"] and "v" * 28 not in out["port"]


def _contract(lib, root, monkeypatch, case):
    """Run one case of the environment contract under ``root``; what an
    observer sees: the sinks, the dir, the files, or the error."""
    monkeypatch.setattr(tempfile, "tempdir", os.path.join(root, "tmp"))
    os.makedirs(os.path.join(root, "tmp"))
    d = os.path.join(root, "run")
    try:
        if case == "env_selects_sinks":
            monkeypatch.setenv("OPENAI_LOG_FORMAT", "json,csv")
            monkeypatch.setenv("OPENAI_LOGDIR", d)
            log = lib.configure()
        elif case == "log_file_sink":
            log = lib.configure(d, format_strs=["log"])
        elif case == "default_unchanged":
            log = lib.configure(d)
        elif case == "unknown_format":
            lib.make_output_format("bogus", d)
        elif case == "empty_dir":
            lib.make_output_format("json", "")
        elif case == "env_format_without_dir":
            monkeypatch.setenv("OPENAI_LOG_FORMAT", "json")
            log = lib.configure()
        elif case == "explicit_dir_beats_env":
            monkeypatch.setenv("OPENAI_LOGDIR", os.path.join(root, "env"))
            log = lib.configure(d)
        elif case == "env_dir_alone":
            monkeypatch.setenv("OPENAI_LOGDIR", d)
            log = lib.configure()
        elif case == "env_stdout_only":
            monkeypatch.setenv("OPENAI_LOG_FORMAT", "stdout")
            monkeypatch.setenv("OPENAI_LOGDIR", d)
            log = lib.configure()
    except ValueError as e:
        return {"raises": str(e).replace(root, "<root>")}
    log.logkv("metric", 2.0)
    log.dumpkvs()
    files = sorted(os.path.relpath(os.path.join(p, f), root)
                   for p, _, fs in os.walk(root) for f in fs)
    def named(path):  # mkdtemp's random part
        return re.sub(r"gdt-logs-[^/]+", "gdt-logs-*", path)

    return {"sinks": [type(f).__name__ for f in log.output_formats],
            "dir": log.dir and named(os.path.relpath(log.dir, root)),
            "files": [named(f) for f in files]}


CONTRACT_CASES = ["env_selects_sinks", "log_file_sink", "default_unchanged", "unknown_format",
                  "empty_dir", "env_format_without_dir", "explicit_dir_beats_env",
                  "env_dir_alone", "env_stdout_only"]


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_environment_contract_as_jax(case, tmp_path, monkeypatch):
    seen = {}
    for name, lib in LIBS.items():
        with monkeypatch.context() as m:
            seen[name] = _contract(lib, str(tmp_path / name), m, case)
    assert seen["port"] == seen["jax"]
    got = seen["port"]
    expect = {
        "env_selects_sinks": {"sinks": ["JSONOutputFormat", "CSVOutputFormat"], "dir": "run",
                              "files": ["run/progress.csv", "run/progress.json"]},
        "log_file_sink": {"sinks": ["HumanOutputFormat"], "dir": "run", "files": ["run/log.txt"]},
        "default_unchanged": {"sinks": ["HumanOutputFormat", "JSONOutputFormat",
                                        "CSVOutputFormat"], "dir": "run",
                              "files": ["run/progress.csv", "run/progress.json"]},
        "env_format_without_dir": {"sinks": ["JSONOutputFormat"], "dir": "tmp/gdt-logs-*",
                                   "files": ["tmp/gdt-logs-*/progress.json"]},
        "explicit_dir_beats_env": {"sinks": ["HumanOutputFormat", "JSONOutputFormat",
                                             "CSVOutputFormat"], "dir": "run",
                                   "files": ["run/progress.csv", "run/progress.json"]},
        "env_dir_alone": {"sinks": ["HumanOutputFormat", "JSONOutputFormat", "CSVOutputFormat"],
                          "dir": "run", "files": ["run/progress.csv", "run/progress.json"]},
        "env_stdout_only": {"sinks": ["HumanOutputFormat"], "dir": "run", "files": []},
    }
    if case == "unknown_format":
        assert got == {"raises": "Unknown format specified: bogus"}
    elif case == "empty_dir":
        assert "log dir" in got["raises"]
    else:
        assert got == expect[case]
    if case == "log_file_sink":
        assert "metric" in (tmp_path / "port" / "run" / "log.txt").read_text()


def test_profile_kv_accumulates_wall_time():
    log = port_logger.Logger(output_formats=[])
    for _ in range(2):
        t0 = time.time()
        with log.profile_kv("batch"):
            time.sleep(0.01)
        assert time.time() - t0 >= 0.01
    with log.profile_kv("step"):
        pass
    out = log.dumpkvs()
    assert 0.02 <= out["wait_batch"] < 1.0 and 0 <= out["wait_step"] < out["wait_batch"]
    assert log.dumpkvs() == {}


def test_tensorboard_sink_writes_events(tmp_path, monkeypatch):
    if "tensorflow" not in sys.modules:
        # tensorboard's own stub in place of TensorFlow, whose import alone
        # takes ~15 s; the sink needs none of it
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    log = port_logger.configure(str(tmp_path), format_strs=["tensorboard"])
    for step in range(2):
        log.logkv("loss", 0.5 + step)
        log.logkv("tag", "not a scalar")
        log.dumpkvs()
    log.output_formats[0].writer.close()
    files = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1
    scalars = [(e.step, v.tag, v.simple_value if v.HasField("simple_value") else None)
               for e in EventFileLoader(files[0]).Load() for v in e.summary.value]
    assert [(s, tag) for s, tag, _ in scalars] == [(1, "loss"), (2, "loss")]

    # where tensorboard is missing the sink says so (the card machine has none)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="'tensorboard' package"):
        port_logger.make_output_format("tensorboard", str(tmp_path / "again"))


@pytest.mark.parametrize("rank", [0, 1])
def test_train_loop_ranks_follow_the_contract(rank, tmp_path, monkeypatch, capsys):
    """Under OPENAI_LOGDIR and OPENAI_LOG_FORMAT=json,csv rank 0 logs to its
    --save_dir (an explicit dir beats the environment, JAX's train loop
    configures with it) through the json and csv sinks; a rank that does not
    write prints its table and writes no file."""
    from gesturediffusion_tpu_torch.train import loop as ploop
    from gesturediffusion_tpu_torch.train import train_mdm

    env_dir, save = tmp_path / "env", tmp_path / "run"
    monkeypatch.setenv("OPENAI_LOGDIR", str(env_dir))
    monkeypatch.setenv("OPENAI_LOG_FORMAT", "json,csv")
    if rank:
        monkeypatch.setattr(ploop, "process_index", lambda: rank)
        monkeypatch.setattr(train_mdm, "process_index", lambda: rank)
    train_mdm.main(["--device", "cpu", "--dataset", "synthetic", "--layers", "1",
                    "--latent_dim", "32", "--num_frames", "20", "--batch_size", "2",
                    "--diffusion_steps", "4", "--log_interval", "1", "--num_steps", "1",
                    "--save_dir", str(save)])
    out = capsys.readouterr().out
    assert not env_dir.exists()
    files = sorted(os.listdir(save)) if save.exists() else []
    if rank:
        assert files == [] and "| loss" in out
    else:
        assert {"progress.json", "progress.csv", "args.json"} <= set(files)
        assert "| loss" not in out
