"""
Process-sharded test runner: the full suite at module granularity across
N worker processes.

Why not pytest-xdist: (a) it is not available in every target
environment; (b) one PROCESS per test module sidesteps the XLA:CPU
in-process hazard documented in tests/conftest.py (segfaults once a
long-lived process accumulates gigabytes of JIT executables) while
letting each worker keep its in-memory pjit cache for the modules it
runs; (c) module granularity means every distinct XLA program is
compiled at most once per run (id-level round-robin would recompile
each module's kernels in every worker).

Scheduling is longest-first from the duration ledger recorded by the
previous run (tests/.partest_durations.json — refreshed on every run,
committed so CI's first run schedules well too).

Wall-clock expectations: the suite is XLA:CPU COMPILE-dominated, so its
wall is bounded below by total CPU work / physical cores — measured
~23.5 CPU-minutes for the full suite (round 5). On a >=6-core box the
split modules pack to ~8 min at -j6; on a 1-core box NO -j value can
beat ~24 min (oversubscription only inflates per-module times).

PARTEST_CACHE=1 additionally enables the per-module persistent XLA
compile cache (PYSHEPSEG_TEST_CACHE) — a WARM second run of the suite
drops to a fraction of the cold time. It stays opt-in because XLA:CPU's
executable (de)serialization has segfaulted sporadically (see
tests/conftest.py); as a backstop, a module that CRASHES (negative
return code) with the cache on is retried once with the cache off.

Usage:  python scripts/partest.py [-j N] [extra pytest args...]
Exit status: non-zero if any module failed.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEDGER = os.path.join(REPO, "tests", ".partest_durations.json")

# Modules that spawn their OWN worker subprocesses (fake pods / remote
# workers). Running several of them concurrently with the rest of the
# suite has produced load-induced barrier timeouts (DCN
# DEADLINE_EXCEEDED at loadavg ~9), so at most
# ONE of these runs at a time; other (single-process) modules still fill
# the remaining workers.
MULTIPROC = {"tests/test_dcn.py", "tests/test_dcn_mesh.py",
             "tests/test_batch_pipeline.py"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-j", "--jobs", type=int,
                    default=int(os.environ.get("PARTEST_WORKERS", "0")),
                    help="worker processes (default: min(4, cpu count))")
    args, extra = ap.parse_known_args()
    jobs = args.jobs or min(4, os.cpu_count() or 1)

    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_*.py")))
    files = [os.path.relpath(f, REPO) for f in files]
    durations = {}
    if os.path.exists(LEDGER):
        try:
            with open(LEDGER) as f:
                durations = json.load(f)
        except (ValueError, OSError):
            durations = {}
    # unknown modules first (assume long), then longest-first
    files.sort(key=lambda f: -durations.get(f, 1e9))

    queue = list(files)
    lock = threading.Lock()
    multiproc_busy = [False]
    results = {}
    t_start = time.time()

    def worker():
        while True:
            with lock:
                if not queue:
                    return
                # take the first runnable module: a MULTIPROC module only
                # when no other MULTIPROC module is currently running
                f = None
                for i, cand in enumerate(queue):
                    if cand in MULTIPROC and multiproc_busy[0]:
                        continue
                    f = queue.pop(i)
                    break
                if f is None:
                    # only blocked MULTIPROC modules remain; wait for the
                    # running one to finish
                    pass
                elif f in MULTIPROC:
                    multiproc_busy[0] = True
            if f is None:
                time.sleep(2)
                continue
            try:
                t0 = time.time()
                env = dict(os.environ)
                useCache = os.environ.get("PARTEST_CACHE") == "1"
                if useCache:
                    env["PYSHEPSEG_TEST_CACHE"] = "1"
                proc = subprocess.run(
                    [sys.executable, "-m", "pytest", f, "-q"] + extra,
                    capture_output=True, universal_newlines=True,
                    cwd=REPO, env=env)
                if useCache and proc.returncode < 0:
                    # cache-related native crash backstop: retry once
                    # cold; the ledger records the RETRY's duration only
                    # (the crashed attempt's time is not the module's
                    # real cost and would distort scheduling)
                    env.pop("PYSHEPSEG_TEST_CACHE", None)
                    t0 = time.time()
                    proc = subprocess.run(
                        [sys.executable, "-m", "pytest", f, "-q"] + extra,
                        capture_output=True, universal_newlines=True,
                        cwd=REPO, env=env)
                dt = time.time() - t0
                # pytest exit code 5 = no tests ran in this module (e.g.
                # an interop module whose whole suite skips when the
                # optional dependency is absent) — not a failure.
                rc = 0 if proc.returncode == 5 else proc.returncode
                with lock:
                    results[f] = (rc, dt, proc.stdout, proc.stderr)
                    tailline = (proc.stdout.strip().splitlines()
                                or [""])[-1]
                    status = "ok" if rc == 0 else f"FAILED rc={rc}"
                    print(f"[{time.time() - t_start:7.1f}s] {f}: {status} "
                          f"({dt:.1f}s) {tailline}", flush=True)
            finally:
                # an exception (e.g. fork failure under load) must not
                # leave the exclusive MULTIPROC slot held forever
                if f in MULTIPROC:
                    with lock:
                        multiproc_busy[0] = False

    threads = [threading.Thread(target=worker) for _ in range(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    failed = {f: r for f, r in results.items() if r[0] != 0}
    for f, (rc, dt, out, err) in sorted(failed.items()):
        print(f"\n===== {f} (rc={rc}) =====")
        print(out[-4000:])
        if err.strip():
            print("--- stderr ---")
            print(err[-2000:])

    # refresh the ledger with this run's measured durations
    new_durations = dict(durations)
    new_durations.update({f: round(r[1], 1) for f, r in results.items()})
    try:
        with open(LEDGER, "w") as f:
            json.dump(new_durations, f, indent=0, sort_keys=True)
            f.write("\n")
    except OSError:
        pass

    total = time.time() - t_start
    npass = sum(1 for r in results.values() if r[0] == 0)
    print(f"\npartest: {npass}/{len(results)} modules passed, "
          f"{total:.0f}s wall, {jobs} workers")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
