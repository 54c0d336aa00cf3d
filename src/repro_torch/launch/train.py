"""Training from the command line (port of `repro/launch/train.py`).

    python -m repro_torch.launch.train --arch qwen3-8b --smoke [--device cpu]
    python -m repro_torch.launch.train --arch kimi-k2-1t-a32b --smoke [--device cpu]

Runs the fault-tolerant training loop (checkpoint/restart, preemption
handling, straggler monitor) on the architecture's model, with random
weights drawn from ``--seed`` on the device (the card unless ``--device
cpu``) and the deterministic synthetic data pipeline (with an encdec
model's frames and a VLM's patches).  ``--smoke`` takes the reduced
same-family config.  Every architecture of the registry trains, with its
`ExecConfig`'s optimizer (the MoE configs: Adafactor over the reference's
stacked tree).  ``--mesh single_pod`` or ``multi_pod`` runs the step
across the production mesh, as the reference does: the cell is built with
`build_cell`, the state distributed with its input shardings and each
batch placed with the batch's.  The caller opens a process group of 256
or 512 ranks first (`torch.distributed.init_process_group` with an
explicit address, world size and rank); with fewer the mesh raises,
naming both counts.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from repro_torch import configs as C
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.shapes import ShapeCell
from repro_torch.data.pipeline import SyntheticDataset, shard_batch
from repro_torch.launch.build import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.parallel.spmd import distribute_tree
from repro_torch.runtime.loop import PreemptionGuard, TrainLoop
from repro_torch.runtime.steps import init_train_state, make_train_step

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "single_pod", "multi_pod"], default="none")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = C.smoke(args.arch) if args.smoke else C.get(args.arch)
    ex = spec.exec
    if args.learning_rate is not None:
        ex = ex.replace(learning_rate=args.learning_rate)
    if args.microbatches is not None:
        ex = ex.replace(num_microbatches=args.microbatches)
    ex = ex.replace(total_steps=max(args.steps, 1))

    model = Model(spec.model, device=args.device, seed=args.seed)
    state = init_train_state(model, ex)

    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi_pod"), device=args.device)
        cell = ShapeCell("cli", args.seq_len, args.global_batch, "train")
        built = build_cell(spec, cell, mesh, exec_override=ex)
        step_fn = built.step_fn
        mesh = built.mesh  # ("pod", "data") merged where the cell allows it
        state = distribute_tree(state, built.in_shardings[0], mesh)
        batch_sh = built.in_shardings[1]

        def place(batch):
            return shard_batch(batch, model.device, batch_sh, mesh)
    else:
        step_fn = make_train_step(model, ex)

        def place(batch):
            return shard_batch(batch, model.device)

    ds = SyntheticDataset(spec.model, args.global_batch, args.seq_len, seed=args.seed)
    loop = TrainLoop(
        train_step=step_fn,
        batch_at=ds.batch_at,
        place_batch=place,
        state=state,
        checkpoints=CheckpointManager(args.ckpt_dir, keep_n=3),
        checkpoint_every=args.ckpt_every,
        log_every=args.log_every,
        guard=PreemptionGuard(install=True),
    )
    loop.maybe_restore()
    result = loop.run(args.steps)
    print(f"[done] device={model.device} exit={result['exit']} "
          f"final_step={result['final_step']} stragglers={len(result['stragglers'])}")
    return result


if __name__ == "__main__":
    main()
