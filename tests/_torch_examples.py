"""Shared by the ``test_torch_examples*.py`` files: run the port's examples
and their references as users run them, and set their printed numbers side
by side.

A port example runs in this process through its ``main`` with ``--device
cpu``, on one thread, from a temporary directory (its ``runs/`` artefacts
land there), its printed lines captured.  The reference scripts run as
subprocesses with one thread each, as does ``observability_torch``: it
resets the process's metrics registry and spawns ranks that import it by
name.  A file starts at most one subprocess at a time and runs a port
example while it waits for it.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# the closing line of each example: its reference's (kernel_methods has
# none of its own: its last demo's line)
CLOSING = {
    "quickstart_torch": "quickstart OK",
    "streaming_torch": "streaming example OK",
    "kernel_methods_torch": "  after 4 chunks: 6/6 streams retrieve their "
                            "own reference",
    "ragged_serving_torch": "ragged serving OK",
    "sessions_serving_torch": "sessions serving OK",
    "serve_lm_torch": "serve OK",
    "train_lm_torch": "loss ",
    "observability_torch": "check: OK",
}
# arguments beyond --device cpu; "{tmp}" is the run's directory
ARGS = {"train_lm_torch": ["--steps", "6", "--ckpt-dir", "{tmp}/ckpt"],
        "observability_torch": ["--check"]}
TIMEOUT_S = 600
# one thread for each process: numpy/torch, and XLA's CPU client
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1"}


def load_example(name: str):
    """``examples/<name>.py`` as a module, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """One example's process, started at construction."""

    def __init__(self, script: str, args: list, tmp: Path):
        tmp.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script)]
            + [a.format(tmp=tmp) for a in args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=tmp)
        self._out = None

    def result(self) -> tuple[int, str, str]:
        """(exit code, stdout, stderr), waiting for the process."""
        if self._out is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, err = self.proc.communicate()
            self._out = (self.proc.returncode, out, err)
        return self._out


class PortRun:
    """One port example's ``main`` run in this process, at construction:
    ``value`` is what it returned, ``result()`` what a process would
    give."""

    def __init__(self, name: str, tmp: Path):
        tmp.mkdir(parents=True, exist_ok=True)
        argv = ["--device", "cpu"] + [a.format(tmp=tmp)
                                      for a in ARGS.get(name, [])]
        mod = load_example(name)
        out, threads, cwd = io.StringIO(), torch.get_num_threads(), Path.cwd()
        rc, err, self.value = 0, "", None
        try:
            torch.set_num_threads(1)
            os.chdir(tmp)
            with contextlib.redirect_stdout(out):
                self.value = mod.main(argv)
            if isinstance(self.value, int):
                rc = self.value
        except SystemExit as e:
            rc = 0 if e.code is None else e.code if isinstance(
                e.code, int) else 1
            err = str(e.code)
        except Exception:           # reported by the tests that read it
            rc, err = 1, traceback.format_exc()
        finally:
            os.chdir(cwd)
            torch.set_num_threads(threads)
        self._out = (rc, out.getvalue(), err)

    def result(self) -> tuple[int, str, str]:
        return self._out


def run_port(name: str, tmp: Path) -> PortRun:
    return PortRun(name, tmp / name)


def start_port_process(name: str, tmp: Path) -> Run:
    return Run(f"{name}.py", ["--device", "cpu"] + ARGS.get(name, []),
               tmp / name)


def start_reference(name: str, tmp: Path) -> Run:
    ref = name[:-len("_torch")]
    return Run(f"{ref}.py", [], tmp / ref)


def run_beside_reference(name: str, tmp: Path) -> tuple[PortRun, Run]:
    """The port in this process while its reference script runs."""
    ref = start_reference(name, tmp)
    port = run_port(name, tmp)
    ref.result()
    return port, ref


def lines(run) -> list[str]:
    """The run's printed lines, once it exited 0."""
    rc, out, err = run.result()
    assert rc == 0, err[-3000:]
    return out.rstrip("\n").splitlines()


def check_runs(run, name: str) -> str:
    """The run exited 0 and printed its closing line; returns stdout."""
    rc, out, err = run.result()
    assert rc == 0, err[-3000:]
    last = out.rstrip("\n").splitlines()[-1]
    assert last.startswith(CLOSING[name]), out[-2000:]
    return out


_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def numbers(line: str) -> list[str]:
    return _NUM.findall(line)


def last_digit(tok: str) -> float:
    """One unit in the last printed digit of a number token."""
    mant, _, exp = tok.lower().partition("e")
    k = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (-k + (int(exp) if exp else 0))


def agree(want: str, got: str, rtol: float, atol: float) -> bool:
    """Integers exactly; other numbers within rtol·|want| + atol, plus one
    unit in the last printed digit (two values that agree to the
    tolerance may still round to neighbouring printed digits)."""
    if re.fullmatch(r"[-+]?\d+", want) and re.fullmatch(r"[-+]?\d+", got):
        return int(want) == int(got)
    a, b = float(want), float(got)
    return abs(a - b) <= atol + rtol * abs(a) + max(last_digit(want),
                                                    last_digit(got))


def compare_lines(ref: list[str], port: list[str], *, rtol=2e-4, atol=2e-5,
                  drop=(), rtol_by=()) -> None:
    """Line i of the reference against line i of the port: the same count
    of numbers, each pair agreeing.  ``drop``: regexes of wall-clock parts
    removed from both; ``rtol_by``: (regex, rtol) pairs for lines that
    match the regex."""
    assert len(ref) == len(port), (ref, port)
    for a, b in zip(ref, port):
        for pat in drop:
            a, b = re.sub(pat, "", a), re.sub(pat, "", b)
        na, nb = numbers(a), numbers(b)
        assert len(na) == len(nb), (a, b)
        tol = next((r for pat, r in rtol_by if re.search(pat, a)), rtol)
        for x, y in zip(na, nb):
            assert agree(x, y, tol, atol), (a, b, x, y)
