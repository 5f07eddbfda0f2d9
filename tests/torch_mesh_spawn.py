"""Spawning the port's mesh tests' ranks (``tests/torch_mesh_worker.py``)
without a way to hang:

- the ranks meet over a ``file://`` rendezvous in their own directory (no
  port, so test files run side by side under xdist), and the group's
  collectives time out after 60 s;
- every spawn has a wall-clock limit, after which every rank is killed;
- a rank that raises writes its traceback, and the spawn fails with it;
- ``shared_results`` runs one spawn per test session, however the
  session's xdist workers split a file's tests: the first worker to take
  the directory's lock runs it, the others wait for its ``done`` (or
  ``failed``) file, with the same limit.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_mesh_worker.py"


def spawn(suites, world, out_dir, cases=(), limit=240.0):
    """Run ``world`` ranks of the worker's ``suites`` (a list) into
    ``out_dir``; raise ``RuntimeError`` with every failing rank's
    traceback, or on the limit."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONHASHSEED": "0"}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs, logs = [], []
    for rank in range(world):
        log = open(out_dir / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "--suite", ",".join(suites), "--rank", str(rank), "--world", str(world),
             "--init", str(out_dir / "rendezvous"), "--out", str(out_dir), "--cases", *cases],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(HERE.parent)))
    deadline = time.monotonic() + limit
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"mesh ranks still running after {limit:.0f} s: {_report(out_dir, world)}")
            if any(p.poll() not in (None, 0) for p in procs):
                # one rank failed: the others would wait on it until the timeout
                time.sleep(1.0)
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"mesh ranks failed (exit codes {[p.returncode for p in procs]}): "
                           f"{_report(out_dir, world)}")


def _report(out_dir, world):
    errors = [(out_dir / f"rank{r}.error") for r in range(world)]
    texts = [e.read_text() for e in errors if e.exists()]
    if texts:
        return "\n".join(texts)
    return "\n".join((out_dir / f"rank{r}.log").read_text()[-3000:] for r in range(world))


def shared_dir(tmp_path_factory, name):
    """A directory that every xdist worker of this session shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return base / name


def shared_results(tmp_path_factory, name, run, limit=300.0):
    """``run(directory)`` once a session (the first worker to get here runs
    it); returns the directory once its results are there."""
    directory = shared_dir(tmp_path_factory, name)
    directory.mkdir(parents=True, exist_ok=True)
    done, failed = directory / "done", directory / "failed"
    try:
        os.mkdir(directory / "lock")
    except FileExistsError:
        deadline = time.monotonic() + limit
        while not (done.exists() or failed.exists()):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{name}: the worker that runs the spawn did not finish in {limit:.0f} s")
            time.sleep(0.2)
    else:
        try:
            run(directory)
        except BaseException as e:
            failed.write_text(f"{type(e).__name__}: {e}")
            raise
        done.write_text("ok")
    if failed.exists():
        raise RuntimeError(f"{name}: {failed.read_text()}")
    return directory
