"""Ported background-subtraction algorithms (importing registers them)."""

from tracking_tpu_torch.bgs import (  # noqa: F401
    dp, eigenbackground, fgd, fuzzy, gmg, gmm, imbs, kde, lb, lbp_mrf, lbsp_family, multicue, multilayer,
    prati_mediod, shrink, sigma_delta, simple, subsense_shrink, t2f, texture, vumeter,
)
