"""Physico-chemical atom properties.

The reference encodes 9 atom-name-derived properties as RGB-ish integer codes
(transformation.hpp:36) and maps mol2 atom names onto them with a fallback to
OG for unknown names (transformation.cpp:18-47).

On the device we use dense small indices 0..8 (`prop_index`); the raw codes are
kept for file I/O parity (normalized .xyz files store the raw code).
"""

from __future__ import annotations

import numpy as np

# name -> raw code (transformation.hpp:36)
PROP_CODES = {
    "OG": 8204959,
    "N": 30894,
    "O": 15219528,
    "NZ": 15231913,
    "CZ": 4646984,
    "CA": 16741671,
    "DU": 7566712,
    "OD1": 0,
    "C": 1,
}

PROP_NAMES = list(PROP_CODES.keys())          # stable order, OG..C
NUM_PROPS = len(PROP_NAMES)                   # 9
PROP_INDEX = {name: i for i, name in enumerate(PROP_NAMES)}
CODE_TO_INDEX = {code: i for i, (name, code) in enumerate(PROP_CODES.items())}
INDEX_TO_CODE = np.array([PROP_CODES[n] for n in PROP_NAMES], dtype=np.int64)

# Properties participating in protein-backbone RMSD (transformation.cpp:441)
RMSD_PROPS = frozenset({PROP_CODES["C"], PROP_CODES["CA"], PROP_CODES["N"],
                        PROP_CODES["O"]})


def string_to_prop(name: str) -> int:
    """Atom name -> raw property code; unknown names fall back to OG
    (transformation.cpp:18-47)."""
    return PROP_CODES.get(name, PROP_CODES["OG"])


def string_to_index(name: str) -> int:
    """Atom name -> dense property index 0..8."""
    return PROP_INDEX.get(name, PROP_INDEX["OG"])


def codes_to_indices(codes: np.ndarray) -> np.ndarray:
    """Raw property codes -> dense indices. Unknown codes map to OG (0)."""
    out = np.zeros(len(codes), dtype=np.int32)
    for i, c in enumerate(np.asarray(codes).astype(np.int64)):
        out[i] = CODE_TO_INDEX.get(int(c), 0)
    return out


def compatibility_matrix(identity_only: bool = True) -> np.ndarray:
    """(NUM_PROPS, NUM_PROPS) bool matrix: compat[src, tgt].

    The reference ships an identity-only map (jly_goicp.cpp:66-73); a richer
    map exists commented out (jly_goicp.cpp:58-65) and is available here with
    identity_only=False for experimentation.
    """
    m = np.eye(NUM_PROPS, dtype=bool)
    if not identity_only:
        extra = {
            "CA": ["CZ"], "CZ": ["CA"],
            "N": ["NZ", "OG"], "NZ": ["N", "OG"],
            "O": ["OD1", "OG"], "OD1": ["O", "OG"],
            "OG": ["N", "O", "OD1", "NZ"],
        }
        for src, tgts in extra.items():
            for t in tgts:
                m[PROP_INDEX[src], PROP_INDEX[t]] = True
    return m
