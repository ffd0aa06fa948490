"""Local cluster launcher: the reference's nohup-per-task workflow in one
command, fail-stop.

Counterpart of ``distributed_tensorflow_tpu/tools/launch_local.py``
``launch`` and ``main``. The reference started each task by hand::

    nohup python tfdist_between.py --job_name=ps --task_index=0 > ps.log 2>&1 &
    nohup python tfdist_between.py --job_name=worker --task_index=0 > w0.log ...

This does the same for any command that takes ``--job_name`` /
``--task_index``::

    python -m distributed_tensorflow_tpu_torch.tools.launch_local \\
        --workers 2 --ps 1 --logdir ./task_logs -- \\
        python -m distributed_tensorflow_tpu_torch.examples.between_sync

One process a task, its output in ``<logdir>/<role><i>.log``. ps tasks are
started too (they print their two lines and exit 0). The exit code is
non-zero when any worker fails. Every worker runs on this host, so each
gets ``LOCAL_RANK`` (its index) and ``LOCAL_WORLD_SIZE`` (the worker
count): the rank's card and the process group's backend follow from them
(``parallel/mesh.py``: NCCL when each worker has a card of its own, gloo
when they share one).

The elastic half of the JAX launcher (``--max-restarts``, the heartbeat
detector, ``--min-workers`` resizing) is ROADMAP A8c and refused.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _spawn_task(command: list[str], role: str, index: int, logdir: str, env: dict):
    """One task process, stdout+stderr to ``<logdir>/<role><i>.log``."""
    f = open(os.path.join(logdir, f"{role}{index}.log"), "wb")
    try:
        return subprocess.Popen(
            command + [f"--job_name={role}", f"--task_index={index}"],
            stdout=f,
            stderr=subprocess.STDOUT,
            env=env,
        )
    finally:
        f.close()  # Popen holds its own descriptor


def launch(
    command: list[str],
    num_workers: int,
    num_ps: int = 0,
    logdir: str = "./task_logs",
    env: dict | None = None,
    wait: bool = True,
    *,
    max_restarts: int = 0,
    heartbeat_port: int | None = None,
    min_workers: int | None = None,
    print_fn=print,
) -> int:
    """Start ``num_ps`` ps tasks and ``num_workers`` workers of
    ``command``; with ``wait``, wait for every task and return 1 if a
    worker exited non-zero, else 0."""
    if max_restarts > 0 or heartbeat_port or min_workers:
        raise NotImplementedError(
            "launch_local's elastic mode (--max-restarts, --heartbeat-port, "
            "--min-workers) is not ported yet (ROADMAP A8c)"
        )
    os.makedirs(logdir, exist_ok=True)
    base_env = dict(os.environ)
    if env:
        base_env.update(env)
    procs = [("ps%d" % i, _spawn_task(command, "ps", i, logdir, base_env))
             for i in range(num_ps)]
    for i in range(num_workers):
        worker_env = dict(base_env, LOCAL_RANK=str(i), LOCAL_WORLD_SIZE=str(num_workers))
        procs.append(("worker%d" % i, _spawn_task(command, "worker", i, logdir, worker_env)))
    if not wait:
        return 0
    rc = 0
    for name, p in procs:
        code = p.wait()
        print_fn(f"{name}: exit {code}")
        if code != 0 and name.startswith("worker"):
            rc = 1
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, required=True)
    parser.add_argument("--ps", type=int, default=0)
    parser.add_argument("--logdir", type=str, default="./task_logs")
    parser.add_argument(
        "--max-restarts", type=int,
        default=int(os.environ.get("DTF_MAX_RESTARTS", "0") or 0),
        help="elastic gang restarts: not ported yet (ROADMAP A8c); 0 = fail-stop",
    )
    parser.add_argument(
        "--heartbeat-port", type=int,
        default=int(os.environ.get("DTF_HEARTBEAT_PORT", "0") or 0) or None,
        help="heartbeat failure detector: not ported yet (ROADMAP A8c)",
    )
    parser.add_argument(
        "--min-workers", type=int,
        default=int(os.environ.get("DTF_MIN_WORKERS", "0") or 0),
        help="shrink-to-fit floor: not ported yet (ROADMAP A8c)",
    )
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="-- command to launch per task")
    args = parser.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("missing command after --")
    return launch(
        command, args.workers, args.ps, args.logdir,
        max_restarts=args.max_restarts, heartbeat_port=args.heartbeat_port,
        min_workers=args.min_workers or None,
    )


if __name__ == "__main__":
    sys.exit(main())
