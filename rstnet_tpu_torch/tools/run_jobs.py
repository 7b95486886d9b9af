"""Parallel job fan-out — the ``utils/run.pl JOB=1:N`` replacement
(counterpart of ``rstnet_tpu/tools/run_jobs.py``).

Capability parity with the reference's Kaldi-style offline-tokenization
parallelism (``egs/pretraining/extract_token.sh:98-105``): run N copies of a
command with JOB substituted 1..N, each with its own log file, wait for all,
fail if any fails. Uses subprocesses (one per shard); device selection is the
job's concern (e.g. ``--device cuda:N`` a job).

Usage: python -m rstnet_tpu_torch.tools.run_jobs --jobs 8 --log log/tok.JOB.log -- \
           python -m rstnet_tpu_torch.tools.offline_tokenization --scp shard.JOB.scp ...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run_jobs(n: int, log_pattern: str, cmd: list[str], max_parallel: int = 0) -> int:
    max_parallel = max_parallel or n
    procs: list[tuple[int, subprocess.Popen]] = []
    failed = []
    pending = list(range(1, n + 1))

    def launch(job: int):
        log = log_pattern.replace("JOB", str(job))
        os.makedirs(os.path.dirname(log) or ".", exist_ok=True)
        args = [c.replace("JOB", str(job)) for c in cmd]
        f = open(log, "w")
        return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT)

    while pending or procs:
        while pending and len(procs) < max_parallel:
            job = pending.pop(0)
            procs.append((job, launch(job)))
        job, p = procs.pop(0)
        rc = p.wait()
        if rc != 0:
            failed.append(job)
            print(f"job {job} failed (rc={rc}), log: {log_pattern.replace('JOB', str(job))}",
                  file=sys.stderr)
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--jobs", type=int, required=True)
    parser.add_argument("--log", required=True, help="log path containing JOB")
    parser.add_argument("--max-parallel", type=int, default=0)
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    assert cmd, "no command given"
    return run_jobs(args.jobs, args.log, cmd, args.max_parallel)


if __name__ == "__main__":
    raise SystemExit(main())
