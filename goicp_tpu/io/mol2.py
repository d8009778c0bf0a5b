"""mol2 cavity / protein parsing and writing.

Host-side numpy I/O. Behavior mirrors the reference's token-stream readers:
  * readMolFile (transformation.cpp:282-306): all rows of the @<TRIPOS>ATOM
    block -> (coords, property code from atom name).
  * getAtomBlock (transformation.cpp:423-448): same, filtered to the backbone
    properties {C, CA, N, O} for RMSD.
  * applyTransformationProtein (transformation.cpp:469-539): rewrite the ATOM
    block coordinates of a protein mol2 with a rigid transform, preserving all
    other lines.
  * write_mol2: a minimal cavity file in the layout of the reference's
    checked-in cavities, for generated inputs.
"""

from __future__ import annotations

import os

import numpy as np

from goicp_tpu.chem.properties import PROP_NAMES, RMSD_PROPS, string_to_prop


def read_mol_file(path: str):
    """Parse the @<TRIPOS>ATOM block of a .mol2 file.

    Returns (coords float64 (N,3), props int64 (N,) raw property codes).
    Uses the native parser (goicp_tpu/native/parsers.cpp) when built.
    """
    try:
        from goicp_tpu import native
        res = native.parse_mol2_atoms(path)
        if res is not None:
            coords, names = res
            props = np.array([string_to_prop(n) for n in names],
                             dtype=np.int64)
            return coords, props
    except Exception:
        pass
    coords, props = [], []
    in_atoms = False
    with open(path, "r") as fh:
        for line in fh:
            s = line.strip()
            if s.startswith("@<TRIPOS>"):
                in_atoms = s == "@<TRIPOS>ATOM"
                continue
            if not in_atoms or not s:
                continue
            tok = s.split()
            if len(tok) < 5:
                continue
            coords.append((float(tok[2]), float(tok[3]), float(tok[4])))
            props.append(string_to_prop(tok[1]))
    return np.asarray(coords, dtype=np.float64), np.asarray(props, dtype=np.int64)


def get_atom_block(path: str):
    """ATOM-block points filtered to backbone props {C, CA, N, O}
    (transformation.cpp:423-448). Returns coords float64 (N,3)."""
    coords, props = read_mol_file(path)
    mask = np.array([int(p) in RMSD_PROPS for p in props], dtype=bool)
    return coords[mask]


def mol2_atom_count(path: str) -> int:
    """Atom count from the MOLECULE header (line 6 of the cavity files) —
    what bo1_GoICP.py:47 passes as NdDownsampled."""
    with open(path, "r") as fh:
        lines = [fh.readline() for _ in range(6)]
    return int(lines[5].split()[0])


def apply_transform_protein(protein_path: str, out_path: str,
                            R: np.ndarray, t: np.ndarray) -> None:
    """Rewrite the ATOM block of `protein_path` with coordinates R@p + t,
    preserving every other line (transformation.cpp:469-539).

    Coordinates are written with C's to_string (6 decimals, fixed) to match
    the reference byte format; columns are re-joined with tabs as the
    reference does.
    """
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    out_lines = []
    in_atoms = False
    with open(protein_path, "r") as fh:
        for line in fh:
            s = line.rstrip("\n")
            stripped = s.strip()
            if stripped.startswith("@<TRIPOS>"):
                in_atoms = stripped == "@<TRIPOS>ATOM"
                out_lines.append(s)
                continue
            if not in_atoms or not stripped:
                out_lines.append(s)
                continue
            tok = stripped.split()
            if len(tok) < 9:
                out_lines.append(s)
                continue
            p = np.array([float(tok[2]), float(tok[3]), float(tok[4])])
            q = R @ p + t
            tok[2] = f"{q[0]:.6f}"
            tok[3] = f"{q[1]:.6f}"
            tok[4] = f"{q[2]:.6f}"
            out_lines.append("\t".join(tok[:9]))
    with open(out_path, "w") as fh:
        fh.write("\n".join(out_lines) + "\n")


def write_mol2(path: str, coords: np.ndarray, prop_idx: np.ndarray) -> None:
    """Minimal .mol2 that both this package's readers and the reference
    parser (transformation.cpp:282-306) read like the checked-in cavity
    files: header lines with the atom count on line 6 (mol2_atom_count),
    an @<TRIPOS>ATOM block whose atom names carry the properties (dense
    indices into PROP_NAMES), then a trailing section whose first
    non-numeric token ends the reference's parse."""
    name = os.path.basename(path)
    with open(path, "w") as fh:
        fh.write("#    Name: %s\n#\n\n@<TRIPOS>MOLECULE\n%s\n" % (name, name))
        fh.write("  %d     0     1     0     0\nPROTEIN\nNO_CHARGES\n\n\n"
                 % len(coords))
        fh.write("@<TRIPOS>ATOM\n")
        for i, (p, c) in enumerate(zip(coords, prop_idx)):
            fh.write("%7d %-8s %10.6f %10.6f %10.6f %-8s %3d %-8s %8.4f \n"
                     % (i + 1, PROP_NAMES[int(c)], p[0], p[1], p[2],
                        "X.0", 1, "SYN1", 0.0))
        fh.write("@<TRIPOS>SUBSTRUCTURE\n")
        fh.write("     1 CUB1        1 GROUP        1 X    CUB  0     "
                 "**** CUB X 1\n")
        fh.write("@<TRIPOS>SET\n")
