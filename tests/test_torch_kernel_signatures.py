"""The ctypes argument lists in ``_kernels._SIGNATURES`` against the C
entry points that ``csrc/*.cu`` declares (``GCIS_API``): a list that is a
value short or long only fails on the card, as a TypeError at the first
launch, so it is held here against the sources. No card, no JAX."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import pytest

from gabor_color_image_segmentation_tpu_torch import _kernels

CSRC = Path(_kernels.__file__).resolve().parent / "csrc"
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double}


def _declarations():
    """{entry point: (source file, its parameters as ctypes types)}; a
    parameter of a type ctypes is not given here stays as its C text."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r"GCIS_API\s+\w+\s+(gcis_\w+)\s*\(([^)]*)\)", text):
            kinds = []
            for param in (p.strip() for p in m.group(2).split(",")):
                if not param:
                    continue
                if "*" in param:
                    kinds.append(ctypes.c_void_p)
                else:
                    ctype = param.split()[-2] if len(param.split()) > 1 else param
                    kinds.append(_SCALARS.get(ctype, param))
            out[m.group(1)] = (path.name, kinds)
    return out


DECLARED = _declarations()


def test_every_entry_point_has_a_signature():
    assert DECLARED, f"no GCIS_API entry point found under {CSRC}"
    assert sorted(set(DECLARED) - set(_kernels._SIGNATURES)) == []
    assert sorted(set(_kernels._SIGNATURES) - set(DECLARED)) == []


@pytest.mark.parametrize("name", sorted(_kernels._SIGNATURES))
def test_signature_matches_declaration(name):
    source, kinds = DECLARED[name]
    want = list(_kernels._SIGNATURES[name])
    assert kinds == want, (
        f"{name} ({source}) declares {len(kinds)} parameters {kinds}, "
        f"_SIGNATURES lists {len(want)} {want}")
