"""Wall and CPU seconds of test files, each run alone by pytest on the CPU.

    python tests/time_test_files.py [--root DIR] [--cold] FILE... > out.jsonl

Runs ``python -m pytest FILE -q -p no:cacheprovider`` for each file, one
after another, from the checkout at ``--root`` (default: this one), with
``JAX_PLATFORMS=cpu``, and prints one JSON line a file: its wall seconds,
the CPU seconds (user + system) of the pytest process and its children,
the counts of pytest's last line and the exit code. ``--cold`` turns JAX's
persistent compilation cache off for the run (``tests/conftest.py`` turns
it on), so that every jit compiles. Comparing two checkouts, give the files
in the order parent, change, change, parent, or run the two interleaved.
"""

import argparse
import json
import os
import re
import resource
import subprocess
import sys
import time

import pytest


@pytest.hookimpl(trylast=True)
def pytest_configure(config):
    """Loaded with ``-p time_test_files`` under ``--cold``: after
    conftest.py has set JAX's cache directory, switch the cache off."""
    if os.environ.get("TIME_TEST_FILES_COLD") == "1":
        import jax

        jax.config.update("jax_enable_compilation_cache", False)


def _cpu_children():
    r = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime


def time_file(root, path, cold):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-m", "pytest", path, "-q",
           "-p", "no:cacheprovider"]
    if cold:
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here
        env["TIME_TEST_FILES_COLD"] = "1"
        cmd += ["-p", "time_test_files"]
    cpu0, t0 = _cpu_children(), time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True)
    wall, cpu = time.perf_counter() - t0, _cpu_children() - cpu0
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    counts = {k: int(v) for v, k in re.findall(
        r"(\d+) (passed|failed|skipped|error|errors|deselected)", last)}
    return {"root": os.path.abspath(root), "file": path, "cold": cold,
            "wall_s": round(wall, 1), "cpu_s": round(cpu, 1),
            "counts": counts, "rc": proc.returncode}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args()
    for path in args.files:
        print(json.dumps(time_file(args.root, path, args.cold)), flush=True)


if __name__ == "__main__":
    main()
