"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro.launch.train``).

Runs a reduced-config training loop (the arch's ``smoke_config()``) on
one device: the synthetic token pipeline behind a prefetcher, AdamW with
10 warmup steps, gradient clipping, async checkpointing with
crash-restart.  It prints the reference launcher's lines.  The LM archs
train; a vision or diffusion arch raises ``NotImplementedError`` until
its slice is ported.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as cfgbase
from repro_torch.data.pipeline import Prefetcher, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as lm_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps as steps_mod


def make_batch_gen(arch, cfg, batch):
    if arch.family != "lm":
        raise NotImplementedError(f"the {arch.family} family trains with "
                                  f"its slice, not yet")
    return Prefetcher(lm_batches(cfg.vocab_size, batch, 32), depth=2)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    arch = cfgbase.get_arch(args.arch)
    cfg = arch.smoke
    device = resolve_device(args.device)
    opt = opt_mod.adamw(lr=args.lr, warmup_steps=10)
    params = lm_mod.init_params(torch.Generator().manual_seed(0), cfg,
                                device=device)
    step_fn = steps_mod.lm_train_step(cfg, opt)
    state = steps_mod.make_state(params, opt)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(start, state)
        print(f"restored checkpoint at step {start}")

    gen = make_batch_gen(arch, cfg, args.batch)
    t0 = time.time()
    for i, batch in zip(range(start, args.steps), gen):
        state, metrics = step_fn(state, pytree.tree_map(
            lambda v: torch.as_tensor(v, device=device), batch))
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i + 1:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / max(i + 1 - start, 1):.2f}s/step)")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save_async(i + 1, state)
    if mgr is not None:
        mgr.wait()
    print("done")


if __name__ == "__main__":
    main()
