"""Protein Data Bank import: molecules as spheres + bond cylinders.

Re-creation of the reference's PDBReader
(solr/io/PDBReader.cpp: loadAtomsFromFile — ATOM/HETATM records become
spheres with CPK radii/colors per element; bonds/backbone become
cylinders; display modes atoms / atoms+sticks / backbone).
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import numpy as np

__all__ = ["load_pdb", "GeometryMode", "CPK_COLORS", "CPK_RADII"]


class GeometryMode(enum.IntEnum):
    """(reference: PDBReader's GeometryType display modes)"""

    ATOMS = 0
    ATOMS_AND_STICKS = 1
    STICKS = 2
    BACKBONE = 3


# CPK-ish element colors (r, g, b) and van-der-Waals-ish radii in
# angstroms (reference: the element tables in PDBReader.cpp).
CPK_COLORS: Dict[str, tuple] = {
    "H": (1.00, 1.00, 1.00),
    "C": (0.30, 0.30, 0.30),
    "N": (0.13, 0.20, 1.00),
    "O": (1.00, 0.13, 0.00),
    "S": (1.00, 0.90, 0.13),
    "P": (1.00, 0.50, 0.00),
    "FE": (0.88, 0.40, 0.20),
    "MG": (0.00, 0.55, 0.00),
    "CA": (0.50, 0.50, 0.56),
    "ZN": (0.49, 0.50, 0.69),
    "NA": (0.00, 0.00, 1.00),
    "CL": (0.00, 1.00, 0.00),
}
CPK_RADII: Dict[str, float] = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80, "P": 1.80,
    "FE": 1.94, "MG": 1.73, "CA": 2.31, "ZN": 2.10, "NA": 2.27,
    "CL": 1.75,
}
_DEFAULT_COLOR = (0.8, 0.2, 0.8)
_DEFAULT_RADIUS = 1.6


def _element(record: str) -> str:
    el = record[76:78].strip().upper()
    if not el:
        # Fall back to the atom-name column (reference does the same).
        name = record[12:16].strip()
        el = "".join(c for c in name if c.isalpha())[:2].upper()
        if el[:1] in CPK_RADII and el not in CPK_RADII:
            el = el[:1]
    return el


def load_pdb(
    path: str,
    builder,
    mode: GeometryMode = GeometryMode.ATOMS_AND_STICKS,
    scale: float = 0.1,
    atom_scale: float = 0.35,
    stick_radius: float = 0.12,
    bond_cutoff: float = 1.9,
    center: bool = True,
    specular: float = 0.5,
):
    """Load ATOM/HETATM records; returns the number of atoms added.

    ``atom_scale`` shrinks van-der-Waals radii for ball-and-stick
    rendering (1.0 = space filling, the reference's atoms mode).
    """
    atoms = []  # (pos, element)
    backbone = []  # CA positions in order
    with open(path) as f:
        for line in f:
            if line.startswith(("ATOM", "HETATM")):
                try:
                    pos = (
                        float(line[30:38]),
                        float(line[38:46]),
                        float(line[46:54]),
                    )
                except ValueError:
                    continue
                el = _element(line)
                atoms.append((np.asarray(pos), el))
                if line[12:16].strip() == "CA":
                    backbone.append(np.asarray(pos))
            elif line.startswith("ENDMDL"):
                break  # first model only (reference behavior)
    if not atoms:
        return 0

    pos = np.stack([a[0] for a in atoms])
    offset = 0.5 * (pos.min(axis=0) + pos.max(axis=0)) if center else 0.0
    pos = (pos - offset) * scale

    mat_cache: Dict[str, int] = {}

    def mat_for(el: str) -> int:
        if el not in mat_cache:
            color = CPK_COLORS.get(el, _DEFAULT_COLOR)
            mat_cache[el] = builder.add_material(
                color=color + (1.0,), specular=specular,
                specular_power=40.0,
            )
        return mat_cache[el]

    if mode in (GeometryMode.ATOMS, GeometryMode.ATOMS_AND_STICKS):
        r_scale = atom_scale if mode == GeometryMode.ATOMS_AND_STICKS else 1.0
        for p, el in zip(pos, (a[1] for a in atoms)):
            r = CPK_RADII.get(el, _DEFAULT_RADIUS) * scale * r_scale
            builder.add_sphere(tuple(p), r, mat_for(el))

    if mode in (GeometryMode.ATOMS_AND_STICKS, GeometryMode.STICKS):
        # Bonds by distance cutoff (reference: PDBReader's pair search).
        grey = builder.add_material(color=(0.6, 0.6, 0.6, 1.0),
                                    specular=specular)
        cut2 = (bond_cutoff * scale) ** 2
        # Grid hash for O(n) neighbor search on large molecules.
        cell = bond_cutoff * scale
        keys = np.floor(pos / cell).astype(np.int64)
        buckets: Dict[tuple, list] = {}
        for i, k in enumerate(map(tuple, keys)):
            buckets.setdefault(k, []).append(i)
        for i, (p, k) in enumerate(zip(pos, keys)):
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        for j in buckets.get(
                            (k[0] + dx, k[1] + dy, k[2] + dz), ()
                        ):
                            if j <= i:
                                continue
                            d2 = float(np.sum((pos[j] - p) ** 2))
                            if 1e-8 < d2 <= cut2:
                                builder.add_cylinder(
                                    tuple(p), tuple(pos[j]),
                                    stick_radius * scale / 0.1, grey,
                                )

    if mode == GeometryMode.BACKBONE and backbone:
        bb = (np.stack(backbone) - offset) * scale
        mat = builder.add_material(color=(0.9, 0.6, 0.2, 1.0),
                                   specular=specular)
        for a in bb:
            builder.add_sphere(tuple(a), stick_radius * scale / 0.04, mat)
        for a, b in zip(bb[:-1], bb[1:]):
            builder.add_cylinder(tuple(a), tuple(b),
                                 stick_radius * scale / 0.05, mat)
    return len(atoms)
