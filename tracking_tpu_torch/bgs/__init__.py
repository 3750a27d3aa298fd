"""Ported background-subtraction algorithms (importing registers them)."""

from tracking_tpu_torch.bgs import (  # noqa: F401
    dp, fgd, gmg, gmm, lb, lbsp_family, multilayer, prati_mediod, shrink, sigma_delta, simple, subsense_shrink,
    texture, vumeter,
)
