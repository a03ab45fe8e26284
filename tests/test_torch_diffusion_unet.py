"""The UNet (SDXL) cases of ``tests/test_torch_diffusion.py``'s checks,
in a file of their own: the reference's UNet takes most of this file's
time to initialise and compile, and pytest-xdist's ``--dist loadfile``
runs a file on one worker.  The tolerances are that file's; the train
step and the checkpoint interchange are in
``tests/test_torch_diffusion_unet_train.py``.
"""

from __future__ import annotations

from test_torch_diffusion import (  # noqa: F401 (fixtures)
    check_apply_matches_reference,
    check_from_jax_params_keeps_leaves_order_and_none,
    check_init_matches_reference_structure,
    check_loss_and_gradients_match_reference,
    check_remat_gives_the_same_gradients,
    check_sampler_step_matches_reference, check_smoke_train_step, ref_draws,
    torch_threads)


def test_apply_matches_reference():
    check_apply_matches_reference("unet_sdxl")


def test_sampler_step_matches_reference():
    check_sampler_step_matches_reference("unet_sdxl")


def test_loss_and_gradients_match_reference(ref_draws):
    check_loss_and_gradients_match_reference("unet_sdxl")


def test_remat_gives_the_same_gradients():
    check_remat_gives_the_same_gradients("unet_sdxl")


def test_from_jax_params_keeps_leaves_order_and_none():
    check_from_jax_params_keeps_leaves_order_and_none("unet_sdxl")


def test_init_matches_reference_structure():
    check_init_matches_reference_structure("unet_sdxl")


def test_smoke_train_step():
    check_smoke_train_step("unet_sdxl")
