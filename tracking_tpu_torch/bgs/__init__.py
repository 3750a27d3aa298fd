"""Ported background-subtraction algorithms (importing registers them)."""

from tracking_tpu_torch.bgs import fgd, gmg, gmm, lbsp_family, multilayer, subsense_shrink, texture  # noqa: F401
