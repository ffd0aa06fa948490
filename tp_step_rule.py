"""Why chip_smoke.py's phase 25(d) holds each tensor-parallel step, not the
whole run, to one device, and that the rule fails a wrong tp path. On the
CPU (seconds); ``--device cuda`` runs the one-device half on the card.

1. Conditioning: each classifier of ``chip_smoke.TP_CLASSIFIERS`` trained
   TP_CLS_STEPS SGD steps on one device from its seed's parameters, and
   again from them scaled by 1 + 1e-7 normal noise; the largest relative
   cost gap between the two runs. A run whose gap passes SP_LOSS_RTOL
   cannot be held to another run whose sums differ only in their order.
2. The rule: 4 gloo ranks on a (data 2, model 2) mesh run
   ``chip_smoke.tp_classifier``; one device replays each step from the tp
   run's gathered state (``tp_classifier_replay``); the largest cost gap
   and parameter gap (of the step's movement) beside the smoke's bounds.
   ``--fault copy_to`` plants, at run time in the ranks, Megatron's f as
   the identity in both passes (a column product's input gradient left
   partial on each model rank).

    python3 tp_step_rule.py [--fault copy_to] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile

import numpy as np

import chip_smoke as cs


def conditioning(device: str) -> None:
    import torch
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice

    for family, lr in cs.TP_CLASSIFIERS:
        runs = []
        for eps in (0.0, 1e-7):
            model = build_model(family, compute_dtype=torch.float32)
            strat, opt = SingleDevice(device=device), optim_lib.sgd(lr)
            state = strat.init_state(model, opt, seed=1)
            g = torch.Generator().manual_seed(7)
            noise = [1 + eps * torch.randn(p.shape, generator=g).to(p.device)
                     for p in state.params]
            state = state._replace(params=type(state.params)(*(p * n for p, n in
                                                              zip(state.params, noise))))
            step = strat.make_train_step(model, cross_entropy, opt)
            costs = []
            for x, y in zip(*cs.tp_cls_batches()):
                state, c = step(state, *strat.prepare_batch(x, y))
                costs.append(float(c))
            runs.append(np.array(costs))
        gap = np.abs(runs[1] - runs[0]) / np.maximum(1.0, np.abs(runs[0]))
        print(f"{family}: one device, parameters x (1 + 1e-7 noise): costs apart by up to "
              f"{gap.max():.2e} (step {int(gap.argmax()) + 1} of {cs.TP_CLS_STEPS}; "
              f"SP_LOSS_RTOL {cs.SP_LOSS_RTOL})")


def rank_main(rank: int, port: int, out: str, fault: str) -> None:
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.ops import collectives
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    if fault == "copy_to":
        collectives.TensorParallel.copy_to = lambda self, x: x
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4,
                            rank=rank)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for family, lr in cs.TP_CLASSIFIERS:
        r = cs.tp_classifier(family, lr, mesh)
        if rank == 0:
            torch.save(r, os.path.join(out, f"{family}.pt"))
    dist.destroy_process_group()


def rule(fault: str, device: str) -> None:
    import torch
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(rank_main, args=(port, out, fault), nprocs=4)
        for family, lr in cs.TP_CLASSIFIERS:
            r = torch.load(os.path.join(out, f"{family}.pt"))
            ref = cs.tp_classifier_replay(family, lr, r["states"], device=device)
            gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(r["costs"], ref["costs"]))
            apart = max(cs.param_gap(r["states"][i + 1], ref["reached"][i], r["states"][i])[0]
                        for i in range(cs.TP_CLS_STEPS))
            print(f"{family}: tp (2, 2) fault {fault}, each step against one device's from the "
                  f"same state: cost gap {gap:.2e} (SP_LOSS_RTOL {cs.SP_LOSS_RTOL}), parameters "
                  f"{apart:.2e} of the step's movement apart (SP_PARAM_REL {cs.SP_PARAM_REL})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", choices=("none", "copy_to"), default="none")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    conditioning(args.device)
    rule(args.fault, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
