"""Device profiling over ``torch.profiler``.

Counterpart of ``distributed_tensorflow_tpu/utils/profiler.py``, which
wraps ``jax.profiler``. The reference's only instrumentation was wall-clock
timing in the loop (AvgTime / Total Time, ``tfdist_between.py:98-110``,
kept in ``utils/logging.py``); a trace here shows what the device did, op
by op and kernel by kernel, in a Chrome trace that Perfetto,
``chrome://tracing`` and TensorBoard's profiler plugin load.

:func:`trace` records the host (CPU activity) and, on a CUDA device, the
card (CUDA activity: CUPTI sees every kernel the card runs, the port's
``ctypes`` launches included). A profile of a CUDA run that recorded no
device event raises: a trace that cannot see the card must not pass for
one that saw it idle. With a :class:`~observability.spans.SpanRecorder`
the capture window is also a host span, ``torch_profiler_trace``, as the
JAX wrapper records ``jax_profiler_trace``.

JAX's ``start_server`` (an on-demand profiling server) has no PyTorch
counterpart: :func:`start_server` raises.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import time

# Launches that open the capture window on the card, before the traced
# block. The trace may drop the first records of a window (an epoch profiled
# 14 minutes into a process lost its first ~50 kernels, and none after
# them; 1,024 of these lost 827 there), so these take that loss; their
# kernel, ``spin_kernel``, is named nowhere else, which shows how many were
# lost.
LEAD_IN = 4096
_LEAD_KERNEL = "spin_kernel"


class Profile:
    """What :func:`trace` captured: ``path`` (the Chrome trace it wrote),
    ``kernels`` (the block's device kernels: name → launches seen),
    ``device_events`` (their total) and ``lead_in_lost`` (of the
    window's :data:`LEAD_IN` opening launches on the card, how many the
    trace lost). Filled in when the ``with`` block ends."""

    def __init__(self):
        self.path: str | None = None
        self.kernels: collections.Counter = collections.Counter()
        self.device_events = 0
        self.lead_in_lost = 0

    def count(self, *names: str) -> dict:
        """Launches of the kernels whose names contain each of ``names``."""
        return {n: sum(c for k, c in self.kernels.items() if n in k) for n in names}


def _on_cuda(device) -> bool:
    import torch

    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(logdir: str, recorder=None, *, device=None):
    """Capture a device trace of the enclosed block into ``logdir``::

        with profiler.trace("./logs/profile", device="cuda") as prof:
            state, cost = train_step(state, x, y)
            float(cost)  # the fetch waits for the card
        prof.path, prof.count("flash_fwd_kernel")

    ``device`` (default: cuda when there is one) decides whether the card
    is recorded; on the card a discarded warm-up step comes first, the
    recorded window opens with :data:`LEAD_IN` empty launches, and the card
    is synchronized before the block and before the capture stops, so every
    kernel the block launched is in it, and no kernel from before it.
    Yields a :class:`Profile`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = _on_cuda(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    result = Profile()
    span = (
        recorder.span("torch_profiler_trace", cat="profiler", logdir=logdir)
        if recorder is not None
        else contextlib.nullcontext()
    )

    def lead_in():
        for _ in range(LEAD_IN):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()

    if cuda:
        torch.cuda.synchronize()  # nothing from before the block in the window
    with span:
        # A warm-up step (traced, then discarded: the profiler's own start)
        # before the recorded one, which opens with the lead-in.
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            if cuda:
                lead_in()
            prof.step()
            if cuda:
                lead_in()
            yield result
            if cuda:
                torch.cuda.synchronize()
        result.path = os.path.join(
            logdir, "%s_%d.%d.pt.trace.json"
            % (socket.gethostname(), os.getpid(), int(time.time() * 1000)))
        prof.export_chrome_trace(result.path)
    with open(result.path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    for e in events:
        if e.get("cat") == "kernel":
            result.kernels[e.get("name", "?")] += 1
    if cuda:
        lead = [k for k in result.kernels if _LEAD_KERNEL in k]
        result.lead_in_lost = LEAD_IN - sum(result.kernels.pop(k) for k in lead)
        if result.lead_in_lost == LEAD_IN:
            raise RuntimeError(
                f"the profile in {result.path} lost all {LEAD_IN} lead-in launches: "
                "it may have lost the block's first kernels too"
            )
    result.device_events = sum(result.kernels.values())
    if cuda and not result.device_events:
        raise RuntimeError(
            f"the profile in {result.path} recorded no device event: the "
            "profiler does not see the card (CUPTI), so it cannot say what ran there"
        )


def start_server(port: int = 9999):
    """JAX's on-demand profiling server (``jax.profiler.start_server``):
    PyTorch has no counterpart, and nothing in the JAX package calls it.
    Capture a window with :func:`trace` instead."""
    raise NotImplementedError(
        "profiler.start_server: torch.profiler has no on-demand profiling "
        "server (jax.profiler.start_server has no PyTorch counterpart); use "
        "profiler.trace(logdir) around the region to capture"
    )


@contextlib.contextmanager
def annotate(name: str, recorder=None):
    """Named region on the device trace's timeline
    (``torch.profiler.record_function``) and, with ``recorder``, the same
    region as a host span (one name, both views)."""
    from torch.profiler import record_function

    span = (
        recorder.span(name, cat="annotation")
        if recorder is not None
        else contextlib.nullcontext()
    )
    with span, record_function(name):
        yield
