"""End-to-end training launcher with checkpoint/restart fault tolerance.
Port of the JAX package's ``launch/train.py``.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 200 --ckpt-dir /path/to/run1 [--device cpu]

Any arch id from the registry works. ``--smoke`` is on whatever the
command line says, as in the JAX launcher (``store_true`` with
``default=True``), so the launcher always trains the reduced config, with
``master_weights`` off; a full-width run goes through the library API
(``training.train_loop``). Resumes automatically from the newest
checkpoint in ``--ckpt-dir``; ``--simulate-preemption N`` stops at step N,
so that a second run resumes from the checkpoint. Checkpoints hold
``(params, train_state)`` in the JAX trainer's leaf order
(``models.convert.train_leaves``), so either launcher resumes the
other's. Runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import get_arch, list_archs
from ..core.stores import resolve_device
from ..data.lm_data import LMDataConfig, SyntheticTokenStream
from ..distributed.fault_tolerance import CheckpointManager
from ..models import api, convert, transformer as tr
from ..models.api import ShapeCell
from ..training import optimizer as optim
from ..training.train_loop import TrainConfig, init_train_state, make_train_step


def make_batch_fn(cfg, arch_family: str, batch_size: int, seq_len: int,
                  device="cuda"):
    """``fn(step) -> batch`` on ``device``: an LM's tokens from
    ``SyntheticTokenStream``, a GNN's or recsys model's ``make_inputs``
    batch from ``default_rng(step)``, each equal to the JAX launcher's."""
    device = resolve_device(device)
    if isinstance(cfg, tr.LMConfig):
        data = SyntheticTokenStream(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            batch_size=batch_size))
        return lambda step: {"tokens": torch.from_numpy(
            data.batch(step)).to(device)}
    cell_kind = {"gnn": ShapeCell("t", "train", {
        "n_nodes": 256, "n_edges": 1024,
        "d_feat": cfg.d_in if hasattr(cfg, "d_in") else 32,
        "n_classes": getattr(cfg, "n_classes", 5)}),
        "recsys": ShapeCell("t", "train", {"batch": batch_size})}[arch_family]

    def fn(step):
        rng = np.random.default_rng(step)
        return api.make_inputs(rng, cfg, cell_kind, device=device)["batch"]
    return fn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--simulate-preemption", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def run(argv: Optional[Sequence[str]] = None, log=print) -> Dict:
    """Train as the command line says; returns ``{"params", "state",
    "losses", "start", "preempted"}``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke_config if args.smoke else spec.config
    tcfg = TrainConfig(
        opt=optim.AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps,
                              master_weights=not args.smoke),
        grad_accum=args.grad_accum, compress_grads=args.compress_grads)

    params = api.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    state = init_train_state(params, tcfg)
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2)
    start = 0
    if ckpt.latest_step() is not None:
        leaves, start = ckpt.restore(convert.train_leaves(params, state))
        convert.load_train_leaves(params, state, leaves)
        start += 1
        log(f"resumed from checkpoint at step {start - 1}")

    step_fn = make_train_step(api.loss_fn(cfg), tcfg)
    batch_fn = make_batch_fn(cfg, spec.family, args.batch * args.grad_accum,
                             args.seq, device)

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        if step == args.simulate_preemption:
            log(f"[step {step}] simulated preemption — restart to resume")
            return {"params": params, "state": state, "losses": losses,
                    "start": start, "preempted": True}
        batch = batch_fn(step)
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            log(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e}")
        if step > 0 and step % args.ckpt_every == 0:
            ckpt.save(step, convert.train_leaves(params, state),
                      {"loss": losses[-1]})
    dt = time.time() - t0
    n = args.steps - start
    log(f"trained {n} steps in {dt:.1f}s ({1000 * dt / max(n, 1):.1f} "
        f"ms/step); loss {losses[0] if losses else float('nan'):.4f} -> "
        f"{losses[-1] if losses else float('nan'):.4f}")
    return {"params": params, "state": state, "losses": losses,
            "start": start, "preempted": False}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
