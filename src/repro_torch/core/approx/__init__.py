"""The paper's complex-operation hardware units (port of
`repro/core/approx`): exp_lut, sigmoid_pwl, div_lut, lod and their
tables."""
from repro_torch.core.approx.units import (
    DIV_LUT_TABLE,
    EXP_LUT_TABLE,
    div_lut,
    exp_lut,
    lod,
    sigmoid_pwl,
)

__all__ = ["exp_lut", "sigmoid_pwl", "div_lut", "lod",
           "EXP_LUT_TABLE", "DIV_LUT_TABLE"]
