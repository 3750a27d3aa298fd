"""Ported background-subtraction algorithms (importing registers them)."""

from tracking_tpu_torch.bgs import (  # noqa: F401
    fgd, gmg, gmm, lbsp_family, multilayer, shrink, sigma_delta, simple, subsense_shrink, texture,
)
