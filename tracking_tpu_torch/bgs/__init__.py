"""Ported background-subtraction algorithms (importing registers them)."""

from tracking_tpu_torch.bgs import lbsp_family  # noqa: F401
