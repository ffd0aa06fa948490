"""Planted faults through chip_smoke.py's phase 24(b), on one GPU.

Shows which of phase 24(b)'s checks fail a wrong sequence-parallel path.
Each fault is planted at run time in the two ranks' processes (the files
on disk stay as they are) by wrapping the port's
``flash_attention_with_lse`` for the ring's offset hops:

- ``drop``: the offset hop's result is weighted 0 (its kernels still
  launch, so the hop and launch counts stay right);
- ``offset-1`` / ``offset+1``: the hop runs one position off its ring
  offset (one key a row off the band's edge).

``none`` runs the clean path. For each, ``chip_smoke.phase_sp`` runs the
main run of ``SP_RUNS`` (gpt-s-L2048-flash-W512, SP_STEPS steps) and the
ring-flash attention check with the loss and parameter bounds lifted, so
that every reading prints; each reading is printed beside the smoke's own
bound, and the attention check raises as in the smoke.

    python3 chip_faults.py
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import chip_smoke as cs

FAULTS = ("none", "drop", "offset-1", "offset+1")
FAULT = os.environ.get("DTF_SP_FAULT", "none")


def plant() -> None:
    """Wrap ``flash_attention_with_lse`` with this process's ``FAULT``."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    real = fa.flash_attention_with_lse

    def faulty(q, k, v, **kw):
        f = kw.get("offset", 0)
        if f and FAULT in ("offset-1", "offset+1"):
            kw["offset"] = f + (1 if FAULT == "offset+1" else -1)
        o, lse = real(q, k, v, **kw)
        if f and FAULT == "drop":
            lse = torch.full_like(lse, -1e30)
        return o, lse

    fa.flash_attention_with_lse = faulty


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sp-task", action="store_true", help="one rank (started by the launcher)")
    ap.add_argument("--dp-port", type=int, default=0)
    args, rest = ap.parse_known_args()
    cs.SP_RUNS = cs.SP_RUNS[:1]
    if args.sp_task:
        print(f"planted fault: {FAULT}")
        plant()
        return cs.sp_task(args.dp_port, rest)

    import torch

    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    from distributed_tensorflow_tpu_torch.ops import _build

    _build.build_all(("flash_fwd", "flash_bwd"))
    bounds = (cs.SP_LOSS_RTOL, cs.SP_PARAM_REL)
    cs.SP_LOSS_RTOL = cs.SP_PARAM_REL = float("inf")
    cs.offset_kernels = lambda records, smi: None
    launch = cs.dp_launch
    for fault in FAULTS:
        os.environ["DTF_SP_FAULT"] = fault

        def faulty_launch(name, command, *a, fault=fault, **kw):
            command = [command[0], os.path.abspath(__file__), *command[2:]]
            return launch(f"{name}-{fault}", command, *a, **kw)

        cs.dp_launch = faulty_launch
        print(f"=== fault {fault} (the smoke's bounds: loss {bounds[0]}, parameters "
              f"{bounds[1]})", flush=True)
        t0 = time.perf_counter()
        try:
            cs.phase_sp(collections.defaultdict(dict), smi)
            print(f"=== fault {fault}: the attention check passed "
                  f"({time.perf_counter() - t0:.1f} s)")
        except AssertionError as e:
            print(f"=== fault {fault}: {e} ({time.perf_counter() - t0:.1f} s)")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
