"""Cluster bootstrap: the reference's ``--job_name`` / ``--task_index`` roles
over a ``torch.distributed`` process group.

Counterpart of ``distributed_tensorflow_tpu/cluster.py``. The reference
started a gRPC server a task (``tf.train.Server``) and parked its ps tasks
in ``server.join()``. Here ``worker_svrs`` entries are the ranks of one
process group whose rendezvous is ``tcp://<worker_svrs[0]>`` (the chief),
joined under a bounded timeout and retry (:func:`bounded_initialize`); the
ps role is accepted for launcher compatibility and returns at once
(parameters live on the ranks, and gradients and parameters meet by
all-reduce). One process is one rank is one device (``parallel/mesh.py``).
A worker arms its per-rank event journal from the launcher's environment
(``DTF_JOURNAL_DIR`` or ``DTF_EVENTS_PATH``, ``observability/journal.py``
``configure_from_env``), as the JAX bootstrap does.

Not ported yet, and refused when asked for: the heartbeat detector,
ROADMAP A8c.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Sequence

from distributed_tensorflow_tpu_torch.config import ClusterConfig


def define_flags(parser: argparse.ArgumentParser | None = None) -> argparse.ArgumentParser:
    """The reference CLI: ``--job_name`` / ``--task_index``."""
    parser = parser or argparse.ArgumentParser(
        description="distributed_tensorflow_tpu_torch launcher"
    )
    parser.add_argument(
        "--job_name",
        type=str,
        default="worker",
        choices=("ps", "worker"),
        help="Role of this process. 'ps' is accepted for compatibility and "
        "no-ops: parameters live on the ranks (no parameter server).",
    )
    parser.add_argument(
        "--task_index",
        type=int,
        default=0,
        help="Rank of this process within its job (0 = chief/rendezvous).",
    )
    return parser


@dataclasses.dataclass(frozen=True)
class ProcessContext:
    """What bootstrap resolves for this process."""

    job_name: str
    task_index: int
    num_processes: int
    is_chief: bool
    is_ps: bool
    joined: bool = False  # this process joined a process group

    @property
    def should_exit(self) -> bool:
        return self.is_ps

    def close(self) -> None:
        """Leave the process group this context joined. Idempotent."""
        import torch.distributed as dist

        if self.joined and dist.is_initialized():
            dist.destroy_process_group()


class BootstrapError(RuntimeError):
    """``init_process_group`` failed every bounded attempt."""


def bounded_initialize(
    cluster: ClusterConfig,
    task_index: int,
    *,
    timeout_s: int | None = None,
    attempts: int | None = None,
    backoff: float = 1.0,
    device=None,
    initialize_fn=None,
    sleep=time.sleep,
    print_fn=print,
):
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``task_index`` of ``num_processes`` (``parallel.mesh.init_world``, the
    backend chosen from the rank's device), each attempt bounded by
    ``timeout_s``, at most ``attempts`` of them with a doubling backoff
    between. A gang whose rendezvous is not up yet gets a retried, logged
    attempt rather than a hang. Raises :class:`BootstrapError` naming the
    rendezvous and the budget when every attempt fails; returns the
    default mesh."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.parallel.mesh import init_world

    timeout_s = cluster.connect_timeout_s if timeout_s is None else timeout_s
    attempts = max(1, cluster.connect_attempts if attempts is None else attempts)
    initialize_fn = initialize_fn or init_world
    last = None
    for attempt in range(attempts):
        try:
            return initialize_fn(
                f"tcp://{cluster.coordinator_address}", cluster.num_processes, task_index,
                device=device, timeout_s=timeout_s,
            )
        except (RuntimeError, TimeoutError, OSError, ValueError) as exc:
            last = exc
            # A failed attempt may leave a half-made default group behind;
            # the retry must start clean.
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempt + 1 < attempts:
                delay = backoff * 2**attempt
                print_fn(
                    f"bootstrap: init_process_group attempt {attempt + 1}/{attempts} failed "
                    f"({type(exc).__name__}: {exc}); retrying in {delay:.1f}s"
                )
                sleep(delay)
    raise BootstrapError(
        f"init_process_group to tcp://{cluster.coordinator_address} "
        f"(process {task_index}/{cluster.num_processes}) failed after "
        f"{attempts} attempt(s) of {timeout_s}s each: {type(last).__name__}: {last}"
    ) from last


def bootstrap(
    cluster: ClusterConfig,
    job_name: str = "worker",
    task_index: int = 0,
    *,
    initialize_distributed: bool | None = None,
    heartbeat_port: int | None = None,
    heartbeat_timeout_ms: int | None = None,
    heartbeat_host: str | None = None,
    device=None,
    print_fn=print,
) -> ProcessContext:
    """Resolve this process's role; join the process group if the cluster
    has more than one worker, printing the rank, its device and the
    backend. A ps task prints the reference's line and the reason it has
    nothing to serve, and returns ``is_ps=True``. A worker arms the
    process-default journal from ``DTF_JOURNAL_DIR`` / ``DTF_EVENTS_PATH``
    (a no-op without them) under its original rank: ``task_index``, or
    its entry of ``DTF_WORKER_RANKS`` when a relaunch renumbered the
    gang, so one member keeps one journal. The heartbeat (here or on the
    cluster) is ROADMAP A8c and raises."""
    if job_name == "ps":
        print_fn("ps setting up ...")
        print_fn(
            "ps role is a no-op here: parameters are replicated on the ranks "
            "and aggregated by all-reduce; exiting cleanly."
        )
        return ProcessContext(
            job_name="ps",
            task_index=task_index,
            num_processes=cluster.num_processes,
            is_chief=False,
            is_ps=True,
        )
    if heartbeat_port is not None or heartbeat_host is not None:
        raise NotImplementedError("bootstrap(heartbeat_...): the heartbeat detector is not "
                                  "ported yet (ROADMAP A8c)")
    print_fn("worker setting up ...")
    journal_rank = task_index
    if os.environ.get("DTF_WORKER_RANKS"):
        from distributed_tensorflow_tpu_torch.launch import parse_worker_ranks

        ranks = parse_worker_ranks(os.environ["DTF_WORKER_RANKS"])
        # A rank outside the roster keeps its own index; cluster_from_env
        # checks the roster's length against the world.
        if 0 <= task_index < len(ranks):
            journal_rank = ranks[task_index]
    from distributed_tensorflow_tpu_torch.observability.journal import configure_from_env

    configure_from_env(journal_rank)
    n = cluster.num_processes
    if initialize_distributed is None:
        initialize_distributed = n > 1
    joined = False
    if initialize_distributed and n > 1:
        mesh = bounded_initialize(cluster, task_index, device=device, print_fn=print_fn)
        joined = True
        print_fn(f"data parallel: rank {mesh.rank} of {mesh.size} on {mesh.device} "
                 f"over {mesh.backend}")
    return ProcessContext(
        job_name="worker",
        task_index=task_index,
        num_processes=n,
        is_chief=cluster.is_chief(task_index),
        is_ps=False,
        joined=joined,
    )


def bootstrap_from_argv(
    cluster: ClusterConfig, argv: Sequence[str] | None = None, **kw
) -> ProcessContext:
    args = define_flags().parse_args(argv if argv is not None else sys.argv[1:])
    return bootstrap(cluster, args.job_name, args.task_index, **kw)
