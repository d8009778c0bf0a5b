"""BO1 pair list parsing (bo1_GoICP.py:9-27).

Each TSV row: uniprot_src uniprot_tgt cavity_src cavity_tgt score family cluster.
Columns 2,3 (0-based) are the cavity ids; the sweep registers
source=<col2>_cavity6.mol2 onto target=<col3>_cavity6.mol2.
"""

from __future__ import annotations


def read_pair_list(path: str):
    """Returns list of (source_cavity_id, target_cavity_id) tuples."""
    pairs = []
    with open(path, "r") as fh:
        for line in fh:
            if not line.strip():
                break
            tok = line.split()
            pairs.append((tok[2], tok[3]))
    return pairs


def write_pair_list(path: str, pairs) -> None:
    """Write (source_cavity_id, target_cavity_id) pairs as BO1-style rows;
    the columns the sweep does not read carry placeholders."""
    with open(path, "w") as fh:
        for src, tgt in pairs:
            fh.write(f"U{src}\tU{tgt}\t{src}\t{tgt}\t1.0\tfamily\tcluster\n")
