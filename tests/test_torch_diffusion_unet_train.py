"""The UNet's (SDXL) train step against the reference's jitted one, and
its float32 train state across the packages' checkpoints, in a file of
their own (the reference's UNet train step takes ~30 s to compile on the
CPU, and pytest-xdist's ``--dist loadfile`` runs a file on one
worker).  The tolerances are ``tests/test_torch_diffusion.py``'s.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro_torch import pytree
from repro_torch.checkpoint.checkpoint import CheckpointManager
from test_torch_diffusion import (  # noqa: F401 (fixtures)
    _t, _to_jax_layout, check_train_step_matches_reference, ref_draws,
    torch_threads, train_states)


def test_train_step_matches_reference(ref_draws):
    check_train_step_matches_reference("unet_sdxl")


def test_unet_checkpoint_interchanges_with_reference(tmp_path, ref_draws):
    """A float32 UNet train state (456 parameter leaves, level 0's
    ``None`` attention) saved by either package is restored by the other
    bit for bit (the port's conv kernels written in the reference's HWIO
    layout)."""
    jstate, tstate, _ = train_states("unet_sdxl")
    # the reference's file -> the port
    JManager(tmp_path / "ref").save(1, jstate)
    jtemplate = pytree.tree_map(torch.from_numpy,
                                jax.tree.map(np.array, jstate))
    got = CheckpointManager(tmp_path / "ref").restore(1, jtemplate)
    assert got["params"]["down"][0]["attn"] == [None, None]
    for g, w in zip(pytree.leaves(got), jax.tree.leaves(jstate)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # the port's file -> the reference
    tsaved = {"params": _to_jax_layout(tstate["params"]),
              "opt": {k: (_to_jax_layout(v) if k != "step" else v.numpy())
                      for k, v in tstate["opt"].items()},
              "step": tstate["step"].numpy()}
    CheckpointManager(tmp_path / "port").save(1, _t(tsaved))
    back = JManager(tmp_path / "port").restore(1, jstate)
    assert str(jax.tree.structure(back)) == str(jax.tree.structure(jstate))
    for g, w in zip(jax.tree.leaves(back), pytree.leaves(tsaved)):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert CheckpointManager(tmp_path / "port").manifest(1)["n_leaves"] == \
        len(jax.tree.leaves(jstate)) == 3 * 456 + 2
