"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro.launch.train``).

Runs a reduced-config training loop (the arch's ``smoke_config()``) on
one device: the synthetic token pipeline behind a prefetcher, AdamW with
10 warmup steps, gradient clipping, async checkpointing with
crash-restart.  It prints the reference launcher's lines.  Every arch
trains: the LM, vision and diffusion families (a vision or diffusion
batch is drawn from ``np.random.default_rng(0)`` in the reference's
order, so the two launchers' batches are equal).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as cfgbase
from repro_torch.data.pipeline import Prefetcher, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import diffusion as diff_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models import vision as vis_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps as steps_mod


def make_batch_gen(arch, cfg, batch, rng):
    if arch.family == "lm":
        return Prefetcher(lm_batches(cfg.vocab_size, batch, 32), depth=2)

    def vision_gen():
        while True:
            yield {
                "images": rng.standard_normal(
                    (batch, cfg.img_res, cfg.img_res, 3)).astype(np.float32),
                "labels": rng.integers(0, cfg.n_classes, batch).astype(
                    np.int32),
            }

    def diffusion_gen():
        is_flux = isinstance(cfg, diff_mod.MMDiTConfig)
        while True:
            b = {"latents": rng.standard_normal(
                    (batch, cfg.latent_res, cfg.latent_res, cfg.latent_ch)
                 ).astype(np.float32),
                 "seed": np.int32(rng.integers(0, 2 ** 31))}
            if is_flux:
                b["ctx"] = rng.standard_normal(
                    (batch, cfg.n_ctx_tokens, cfg.d_ctx)).astype(np.float32)
                b["pooled"] = rng.standard_normal(
                    (batch, cfg.d_pooled)).astype(np.float32)
            else:
                b["ctx"] = rng.standard_normal(
                    (batch, cfg.n_ctx_tokens, cfg.ctx_dim)).astype(
                        np.float32)
                b["add_emb"] = rng.standard_normal(
                    (batch, cfg.d_add)).astype(np.float32)
            yield b

    return Prefetcher(vision_gen() if arch.family == "vision"
                      else diffusion_gen(), depth=2)


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
    gen = torch.Generator().manual_seed(0)
    if arch.family == "lm":
        params = lm_mod.init_params(gen, cfg, device=device)
        step_fn = steps_mod.lm_train_step(cfg, opt)
    elif arch.family == "vision":
        params = vis_mod.init_params(gen, cfg, device=device)
        step_fn = steps_mod.vision_train_step(cfg, opt)
    else:
        params = diff_mod.init_params(gen, cfg, device=device)
        step_fn = steps_mod.diffusion_train_step(cfg, opt)
    state = steps_mod.make_state(params, opt)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(start, state)
        print(f"restored checkpoint at step {start}")

    batches = make_batch_gen(arch, cfg, args.batch,
                             np.random.default_rng(0))
    t0 = time.time()
    for i, batch in zip(range(start, args.steps), batches):
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
