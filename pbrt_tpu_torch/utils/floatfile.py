"""Whitespace-separated float-file reader (port of
pbrt_tpu/utils/floatfile.py, core/floatfile.cpp ReadFloatFile): files of
numbers with ``#`` comments, such as the on-disk SPDs of
``"spectrum Kd" "metal-Cu.spd"`` parameters ((wavelength_nm, value)
pairs)."""

from __future__ import annotations


def read_float_file(path: str) -> list:
    vals = []
    with open(path) as f:
        for line in f:
            hashpos = line.find("#")
            if hashpos >= 0:
                line = line[:hashpos]
            for tok in line.split():
                vals.append(float(tok))
    return vals
