"""Training substrate demo: train, crash, restart from checkpoint (the
PyTorch port's twin of ``examples/train_restart.py``).

Trains the smollm smoke config on the synthetic token pipeline with the
prefetcher, async-checkpoints every 20 steps, simulates a crash at step
50, and restarts from the latest manifest — the loss curve continues
where it left off, and the optimizer's step counter with it.  Weights
come from a seeded ``torch.Generator``.  It runs on the card;
``--device cpu`` runs on the CPU:

    PYTHONPATH=src python examples_torch/train_restart.py [--device cpu]
"""

import argparse
import tempfile

import torch

from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as cfgbase
from repro_torch.data.pipeline import Prefetcher, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as lm_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps as steps_mod

SEED = 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = cfgbase.get_arch("smollm_135m").smoke
    opt = opt_mod.adamw(lr=3e-3, warmup_steps=10)
    step_fn = steps_mod.lm_train_step(cfg, opt)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep_n=2)

    def data():
        return Prefetcher(lm_batches(cfg.vocab_size, batch=8, seq=32,
                                     n_batches=200), depth=2)

    def on_device(batch):
        return pytree.tree_map(lambda v: torch.as_tensor(v, device=device),
                               batch)

    def fresh_state():
        params = lm_mod.init_params(torch.Generator().manual_seed(SEED), cfg,
                                    device=device)
        return steps_mod.make_state(params, opt)

    # ---- phase 1: train to step 50, checkpointing every 20 ----
    state = fresh_state()
    losses = []
    it = data()
    for i, batch in zip(range(50), it):
        state, metrics = step_fn(state, on_device(batch))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 20 == 0:
            mgr.save_async(i + 1, state)
    mgr.wait()
    print(f"phase 1: step 50, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"checkpoints at {mgr.steps()}")

    # ---- simulated crash + restart ----
    del state
    latest = mgr.latest_step()
    state = mgr.restore(latest, fresh_state())
    opt_step = int(state["opt"]["step"])
    print(f"restart: restored step {latest} "
          f"(optimizer step counter = {opt_step})")

    it2 = data()
    for _ in zip(range(latest), it2):
        pass  # skip consumed batches (deterministic pipeline)
    more = []
    for i, batch in zip(range(50), it2):
        state, metrics = step_fn(state, on_device(batch))
        more.append(float(metrics["loss"]))
    print(f"phase 2: step {latest} -> {latest + 50}, "
          f"loss {more[0]:.3f} -> {more[-1]:.3f}")
    assert more[-1] < losses[0], "loss should keep improving after restart"
    print("\ncheckpoint/restart training substrate OK")
    return {"losses": losses, "more": more, "restored": latest,
            "opt_step": opt_step}


if __name__ == "__main__":
    main()
