"""GROMACS TPR (portable binary run-input) topology reader.

Parses the tpx header, symbol table, force-field parameter block, molecule
types (atoms, residues, interaction lists) and molecule blocks — everything
gorder needs: atom names/residues/masses/atomic numbers, chemical bonds, and
the structure coordinates/box. The `ir` section at the end of the file is
never read.

Format knowledge is from the public GROMACS tpxio format (fileio/tpxio.cpp);
supported tpx file versions: >= 103 (GROMACS 5.1 through 2024-era files).
Behavioral reference for what must be extracted: SURVEY.md §2.6 item 2.

Bonds are assembled from bonded-interaction lists that represent chemical
connectivity (bonds, G96 bonds, Morse, cubic, connection-only, harmonic,
FENE, tabulated, restraint bonds, constraints) plus SETTLE waters.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import StructureError
from ..system import System, canonical_bonds

# --------------------------------------------------------------- XDR reading


class _XdrReader:
    """Reader for both tpr serialization modes.

    The header always uses classic XDR. The body uses classic XDR for
    file_version < 119 and the GROMACS in-memory serializer for >= 119
    (u64-length unpadded strings, 1-byte uchar/bool, 2-byte ushort).
    """

    __slots__ = ("data", "pos", "double", "mem")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.double = False  # single/double precision "real"
        self.mem = False     # in-memory body serializer (tpx >= 119)

    def error(self, what: str):
        raise StructureError(f"corrupted tpr file: could not read {what}")

    def i32(self) -> int:
        if self.pos + 4 > len(self.data):
            self.error("int")
        (v,) = struct.unpack_from(">i", self.data, self.pos)
        self.pos += 4
        return v

    def u32(self) -> int:
        if self.pos + 4 > len(self.data):
            self.error("uint")
        (v,) = struct.unpack_from(">I", self.data, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        if self.pos + 8 > len(self.data):
            self.error("int64")
        (v,) = struct.unpack_from(">q", self.data, self.pos)
        self.pos += 8
        return v

    def f32(self) -> float:
        if self.pos + 4 > len(self.data):
            self.error("float")
        (v,) = struct.unpack_from(">f", self.data, self.pos)
        self.pos += 4
        return v

    def f64(self) -> float:
        if self.pos + 8 > len(self.data):
            self.error("double")
        (v,) = struct.unpack_from(">d", self.data, self.pos)
        self.pos += 8
        return v

    def real(self) -> float:
        return self.f64() if self.double else self.f32()

    def reals(self, n: int) -> np.ndarray:
        width = 8 if self.double else 4
        if self.pos + width * n > len(self.data):
            self.error("real array")
        dtype = ">f8" if self.double else ">f4"
        out = np.frombuffer(self.data, dtype=dtype, count=n, offset=self.pos)
        self.pos += width * n
        return out.astype(np.float32)

    def ints(self, n: int) -> np.ndarray:
        if self.pos + 4 * n > len(self.data):
            self.error("int array")
        out = np.frombuffer(self.data, dtype=">i4", count=n, offset=self.pos)
        self.pos += 4 * n
        return out.astype(np.int64)

    def skip(self, nbytes: int):
        if self.pos + nbytes > len(self.data):
            self.error("skipped block")
        self.pos += nbytes

    def xdr_string(self) -> str:
        # XDR strings in tpr: max_len i32 (= len+1), actual len i32, padded data
        self.i32()
        n = self.i32()
        if n < 0 or self.pos + n > len(self.data):
            self.error("string")
        raw = self.data[self.pos:self.pos + n]
        self.pos += (n + 3) & ~3
        return raw.split(b"\x00")[0].decode("utf-8", "replace")

    def string(self) -> str:
        """Body string (serializer-dependent)."""
        if not self.mem:
            return self.xdr_string()
        n = self.i64()
        if n < 0 or self.pos + n > len(self.data):
            self.error("string")
        raw = self.data[self.pos:self.pos + n]
        self.pos += n
        return raw.split(b"\x00")[0].decode("utf-8", "replace")

    def uchar(self) -> int:
        if self.mem:
            if self.pos + 1 > len(self.data):
                self.error("uchar")
            v = self.data[self.pos]
            self.pos += 1
            return v
        return self.u32()

    def uchar_vector(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.error("uchar vector")
        raw = self.data[self.pos:self.pos + n]
        self.pos += n if self.mem else ((n + 3) & ~3)
        return raw

    def ushort(self) -> int:
        if self.mem:
            if self.pos + 2 > len(self.data):
                self.error("ushort")
            (v,) = struct.unpack_from(">H", self.data, self.pos)
            self.pos += 2
            return v
        return self.u32()

    def boolean(self) -> bool:
        return bool(self.uchar() if self.mem else self.u32())


# ------------------------------------------------------- function-type table

# Modern interaction-function enum (file order), tpx >= 121 (GROMACS >= 2021).
_FTYPES = [
    "BONDS", "G96BONDS", "MORSE", "CUBICBONDS", "CONNBONDS", "HARMONIC",
    "FENEBONDS", "TABBONDS", "TABBONDSNC", "RESTRBONDS",
    "ANGLES", "G96ANGLES", "RESTRANGLES", "LINEAR_ANGLES",
    "CROSS_BOND_BONDS", "CROSS_BOND_ANGLES", "UREY_BRADLEY",
    "QUARTIC_ANGLES", "TABANGLES",
    "PDIHS", "RBDIHS", "RESTRDIHS", "CBTDIHS", "FOURDIHS", "IDIHS", "PIDIHS",
    "TABDIHS", "CMAP",
    "GB12", "GB13", "GB14", "GBPOL", "NPSOLVATION",
    "LJ14", "COUL14", "LJC14_Q", "LJC_PAIRS_NB",
    "LJ", "BHAM", "LJ_LR", "BHAM_LR", "DISPCORR",
    "COUL_SR", "COUL_LR", "RF_EXCL", "COUL_RECIP", "LJ_RECIP", "DPD",
    "POLARIZATION", "WATER_POL", "THOLE_POL", "ANHARM_POL",
    "POSRES", "FBPOSRES",
    "DISRES", "DISRESVIOL", "ORIRES", "ORIRESDEV",
    "ANGRES", "ANGRESZ", "DIHRES", "DIHRESVIOL",
    "CONSTR", "CONSTRNC", "SETTLE",
    "VSITE1", "VSITE2", "VSITE2FD", "VSITE3", "VSITE3FD", "VSITE3FAD",
    "VSITE3OUT", "VSITE4FD", "VSITE4FDN", "VSITEN",
    "COM_PULL", "DENSITYFITTING", "EQM",
    "EPOT", "EKIN", "ETOT", "ECONSERVED", "TEMP", "VTEMP", "PDISPCORR",
    "PRES", "DVDL_CONSTR", "DVDL", "DKDL", "DVDL_COUL", "DVDL_VDW",
    "DVDL_BONDED", "DVDL_RESTRAINT", "DVDL_TEMPERATURE",
]
_F = {name: i for i, name in enumerate(_FTYPES)}
_F_NRE = len(_FTYPES)

# (first tpx version containing the type, type index in the modern enum);
# used both to renumber functype codes from older files and to skip ilists
# that are absent from older files. Covers types added since tpx 103.
_FTUPD = [
    (114, _F["VSITE2FD"]),
    (117, _F["DENSITYFITTING"]),
    (121, _F["VSITE1"]),
]

# atoms per interaction entry (modern enum indices)
_NRATOMS = {
    "BONDS": 2, "G96BONDS": 2, "MORSE": 2, "CUBICBONDS": 2, "CONNBONDS": 2,
    "HARMONIC": 2, "FENEBONDS": 2, "TABBONDS": 2, "TABBONDSNC": 2,
    "RESTRBONDS": 2,
    "ANGLES": 3, "G96ANGLES": 3, "RESTRANGLES": 3, "LINEAR_ANGLES": 3,
    "CROSS_BOND_BONDS": 3, "CROSS_BOND_ANGLES": 3, "UREY_BRADLEY": 3,
    "QUARTIC_ANGLES": 3, "TABANGLES": 3,
    "PDIHS": 4, "RBDIHS": 4, "RESTRDIHS": 4, "CBTDIHS": 4, "FOURDIHS": 4,
    "IDIHS": 4, "PIDIHS": 4, "TABDIHS": 4, "CMAP": 5,
    "LJ14": 2, "COUL14": 2, "LJC14_Q": 2, "LJC_PAIRS_NB": 2,
    "POLARIZATION": 2, "WATER_POL": 5, "THOLE_POL": 4, "ANHARM_POL": 2,
    "POSRES": 1, "FBPOSRES": 1, "DISRES": 2, "ORIRES": 2,
    "ANGRES": 4, "ANGRESZ": 2, "DIHRES": 4,
    "CONSTR": 2, "CONSTRNC": 2, "SETTLE": 3,
    "VSITE1": 2, "VSITE2": 3, "VSITE2FD": 3, "VSITE3": 4, "VSITE3FD": 4,
    "VSITE3FAD": 4, "VSITE3OUT": 4, "VSITE4FD": 5, "VSITE4FDN": 5,
    "VSITEN": 2,
}

# interaction types that define chemical bonds (atom-pair extraction)
_BOND_FTYPES = {
    _F[n] for n in (
        "BONDS", "G96BONDS", "MORSE", "CUBICBONDS", "CONNBONDS", "HARMONIC",
        "FENEBONDS", "TABBONDS", "TABBONDSNC", "RESTRBONDS", "CONSTR",
        "CONSTRNC",
    )
}
_SETTLE = _F["SETTLE"]


def _iparams_size(ftype_name: str, r: _XdrReader, file_version: int) -> None:
    """Read (skip) the interaction parameters of one function type."""
    R = r.real
    I = r.i32

    def rn(n):
        for _ in range(n):
            R()

    if ftype_name in ("BONDS", "G96BONDS", "HARMONIC", "ANGLES", "G96ANGLES",
                      "IDIHS"):
        rn(4)
    elif ftype_name == "MORSE":
        rn(6 if file_version >= 79 else 3)
    elif ftype_name == "CUBICBONDS":
        rn(3)
    elif ftype_name == "CONNBONDS":
        pass
    elif ftype_name == "FENEBONDS":
        rn(2)
    elif ftype_name in ("TABBONDS", "TABBONDSNC", "TABANGLES", "TABDIHS"):
        R(); I(); R()
    elif ftype_name == "RESTRBONDS":
        rn(8)
    elif ftype_name == "RESTRANGLES":
        rn(4 if file_version >= 131 else 2)
    elif ftype_name == "LINEAR_ANGLES":
        rn(4)
    elif ftype_name == "CROSS_BOND_BONDS":
        rn(3)
    elif ftype_name == "CROSS_BOND_ANGLES":
        rn(4)
    elif ftype_name == "UREY_BRADLEY":
        rn(8 if file_version >= 79 else 4)
    elif ftype_name == "QUARTIC_ANGLES":
        rn(6)
    elif ftype_name in ("PDIHS", "PIDIHS"):
        rn(4); I()
    elif ftype_name in ("RBDIHS", "FOURDIHS"):
        rn(12)
    elif ftype_name == "RESTRDIHS":
        rn(4 if file_version >= 131 else 2)
    elif ftype_name == "CBTDIHS":
        rn(6)
    elif ftype_name == "CMAP":
        I(); I()
    elif ftype_name in ("GB12", "GB13", "GB14", "GBPOL", "NPSOLVATION"):
        if file_version < 113:  # implicit solvation removed in tpx 113
            rn(5)
    elif ftype_name == "LJ14":
        rn(4)
    elif ftype_name == "COUL14":
        pass
    elif ftype_name == "LJC14_Q":
        rn(5)
    elif ftype_name == "LJC_PAIRS_NB":
        rn(4)
    elif ftype_name == "LJ":
        rn(2)
    elif ftype_name == "BHAM":
        rn(3)
    elif ftype_name == "POLARIZATION":
        rn(1)
    elif ftype_name == "ANHARM_POL":
        rn(3)
    elif ftype_name == "WATER_POL":
        rn(6)
    elif ftype_name == "THOLE_POL":
        rn(4 if file_version < 128 else 3)
    elif ftype_name == "POSRES":
        rn(12)
    elif ftype_name == "FBPOSRES":
        I(); rn(5)
    elif ftype_name == "DISRES":
        I(); I(); rn(4)
    elif ftype_name == "ORIRES":
        I(); I(); I(); rn(3)
    elif ftype_name in ("ANGRES", "ANGRESZ"):
        rn(4)
        if file_version < 42:
            rn(1)
    elif ftype_name == "DIHRES":
        if file_version < 82:
            I(); I()
        rn(6 if file_version >= 82 else 3)
    elif ftype_name in ("CONSTR", "CONSTRNC"):
        rn(2)
    elif ftype_name == "SETTLE":
        rn(2)
    elif ftype_name == "VSITE1":
        pass
    elif ftype_name in ("VSITE2", "VSITE2FD"):
        rn(1)
    elif ftype_name in ("VSITE3", "VSITE3FD", "VSITE3FAD"):
        rn(2)
    elif ftype_name in ("VSITE3OUT", "VSITE4FD", "VSITE4FDN"):
        rn(3)
    elif ftype_name == "VSITEN":
        I(); R()
    elif ftype_name in ("COM_PULL", "DENSITYFITTING", "EQM", "EPOT", "EKIN",
                        "ETOT", "ECONSERVED", "TEMP", "VTEMP", "PDISPCORR",
                        "PRES", "DVDL_CONSTR", "DVDL", "DKDL", "DVDL_COUL",
                        "DVDL_VDW", "DVDL_BONDED", "DVDL_RESTRAINT",
                        "DVDL_TEMPERATURE", "DISRESVIOL", "ORIRESDEV",
                        "DIHRESVIOL", "LJ_LR", "BHAM_LR", "DISPCORR",
                        "COUL_SR", "COUL_LR", "RF_EXCL", "COUL_RECIP",
                        "LJ_RECIP", "DPD"):
        pass
    else:  # pragma: no cover
        raise StructureError(
            f"tpr parser: unhandled interaction parameter type {ftype_name}"
        )


# --------------------------------------------------------------- data model


@dataclass
class _MolType:
    name: str
    atom_names: List[str] = field(default_factory=list)
    atom_masses: List[float] = field(default_factory=list)
    atom_numbers: List[int] = field(default_factory=list)   # atomic numbers
    res_index: List[int] = field(default_factory=list)      # per atom
    res_names: List[str] = field(default_factory=list)
    res_ids: List[int] = field(default_factory=list)        # author numbering
    bonds: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class TprData:
    name: str
    natoms: int
    moltypes: List[_MolType]
    molblocks: List[Tuple[int, int]]  # (moltype index, nmol)
    positions: Optional[np.ndarray]
    velocities: Optional[np.ndarray]
    box: Optional[np.ndarray]
    file_version: int
    precision_double: bool


# ------------------------------------------------------------------- parsing


def _read_symtab(r: _XdrReader) -> List[str]:
    nr = r.i32()
    if nr < 0 or nr > 10_000_000:
        raise StructureError("corrupted tpr file: invalid symbol table size")
    return [r.string() for _ in range(nr)]


def _read_ffparams(r: _XdrReader, file_version: int) -> None:
    r.i32()  # atnr
    ntypes = r.i32()
    if ntypes < 0 or ntypes > 10_000_000:
        raise StructureError("corrupted tpr file: invalid ffparams size")
    functypes = [r.i32() for _ in range(ntypes)]
    # renumber file-local functype codes to the modern enum
    for fv, ftype in _FTUPD:
        if file_version < fv:
            functypes = [f + 1 if f >= ftype else f for f in functypes]
    if file_version >= 66:
        r.f64()  # reppow
    r.real()  # fudgeQQ
    for f in functypes:
        if f < 0 or f >= _F_NRE:
            raise StructureError(
                f"corrupted tpr file: invalid function type {f}"
            )
        _iparams_size(_FTYPES[f], r, file_version)


def _read_ilists(r: _XdrReader, file_version: int) -> Dict[int, np.ndarray]:
    """Read all interaction lists of a molecule type → {ftype: iatoms}."""
    out: Dict[int, np.ndarray] = {}
    for j in range(_F_NRE):
        bclear = any(file_version < fv and j == ftype for fv, ftype in _FTUPD)
        if bclear:
            continue
        nr = r.i32()
        if nr < 0:
            raise StructureError("corrupted tpr file: negative ilist size")
        iatoms = r.ints(nr)
        if nr:
            out[j] = iatoms
    return out


def _read_atoms(r: _XdrReader, symtab: List[str], file_version: int,
                mt: _MolType) -> None:
    nr = r.i32()
    nres = r.i32()
    if nr < 0 or nres < 0:
        raise StructureError("corrupted tpr file: negative atom count")
    for _ in range(nr):
        m = r.real()
        r.real()  # q
        r.real()  # mB
        r.real()  # qB
        r.ushort()  # type
        r.ushort()  # typeB
        r.i32()     # ptype
        resind = r.i32()
        atomnumber = r.i32()
        mt.atom_masses.append(m)
        mt.res_index.append(resind)
        mt.atom_numbers.append(atomnumber)
    name_idx = [r.i32() for _ in range(nr)]
    mt.atom_names = [symtab[i] for i in name_idx]
    for _ in range(nr):  # atom type names (symtab indices)
        r.i32()
    for _ in range(nr):  # B-state type names
        r.i32()
    # residue info
    for _ in range(nres):
        nameidx = r.i32()
        if file_version >= 63:
            nrres = r.i32()
            r.uchar()  # insertion code
        else:
            nrres = len(mt.res_names) + 1
        mt.res_names.append(symtab[nameidx])
        mt.res_ids.append(nrres)


def _read_moltype(r: _XdrReader, symtab: List[str], file_version: int) -> _MolType:
    name_idx = r.i32()
    mt = _MolType(name=symtab[name_idx])
    _read_atoms(r, symtab, file_version, mt)
    ilists = _read_ilists(r, file_version)
    pairs: List[Tuple[int, int]] = []
    for ftype, iatoms in ilists.items():
        fname = _FTYPES[ftype]
        nra = _NRATOMS.get(fname)
        if nra is None:
            continue
        width = nra + 1
        entries = iatoms.reshape(-1, width)
        if ftype in _BOND_FTYPES:
            pairs.extend(zip(entries[:, 1].tolist(), entries[:, 2].tolist()))
        # SETTLE rigid waters deliberately do NOT become bonds: groan_rs
        # only converts bonded interactions and constraints, so SETTLE
        # waters have no connectivity (observable in the reference's
        # test_ua_order_nothing_to_analyze, tests_ua.rs — a UA analysis of
        # '@water' finds nothing analyzable because OW has no bonded atoms)
    mt.bonds = pairs
    # charge groups (t_block: nr, index[nr+1]) — written by all supported
    # versions even after mdrun stopped using them
    nr_cg = r.i32()
    if nr_cg < 0 or nr_cg > 50_000_000:
        raise StructureError("corrupted tpr file: invalid charge-group block")
    r.ints(nr_cg + 1)
    # exclusions (t_blocka: nr, nra, index[nr+1], a[nra])
    nr_b = r.i32()
    nra = r.i32()
    if nr_b < 0 or nra < 0:
        raise StructureError("corrupted tpr file: invalid exclusion block")
    r.ints(nr_b + 1)
    r.ints(nra)
    return mt


def _read_molblock(r: _XdrReader, file_version: int) -> Tuple[int, int]:
    moltype = r.i32()
    nmol = r.i32()
    r.i32()  # natoms_mol (redundant with the molecule type)
    nposres_xA = r.i32()
    if nposres_xA > 0:
        r.reals(nposres_xA * 3)
    nposres_xB = r.i32()
    if nposres_xB > 0:
        r.reals(nposres_xB * 3)
    return moltype, nmol


def read_tpr_data(path: str) -> TprData:
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        raise StructureError(f"could not read tpr file '{path}': {e}") from None

    r = _XdrReader(data)
    version_str = r.xdr_string()
    if not version_str.startswith("VERSION"):
        raise StructureError(f"'{path}' is not a valid tpr file")
    precision = r.i32()
    if precision not in (4, 8):
        raise StructureError(f"invalid tpr precision {precision} in '{path}'")
    r.double = precision == 8
    file_version = r.i32()
    if file_version < 103:
        raise StructureError(
            f"tpr file version {file_version} is too old (need GROMACS >= 5.1)"
        )
    file_generation = r.i32()  # noqa: F841
    if file_version >= 81:
        r.xdr_string()  # tag
    natoms = r.i32()
    ngtc = r.i32()
    if file_version >= 79:
        r.i32()   # fep_state
    r.real()      # lambda
    b_ir = r.i32()
    b_top = r.i32()
    b_x = r.i32()
    b_v = r.i32()
    b_f = r.i32()
    b_box = r.i32()
    if file_version >= 119:
        r.i64()  # sizeOfTprBody
        r.mem = True  # body switches to the in-memory serializer

    box = None
    if b_box:
        box = r.reals(9).reshape(3, 3).copy()
        if file_version >= 51:
            r.reals(9)  # box_rel
        r.reals(9)      # boxv
    if ngtc > 0:
        r.reals(ngtc)  # legacy T-coupling lambdas

    if not b_top:
        raise StructureError(f"tpr file '{path}' contains no topology")

    symtab = _read_symtab(r)
    sysname_idx = r.i32()
    sysname = symtab[sysname_idx] if 0 <= sysname_idx < len(symtab) else ""
    _read_ffparams(r, file_version)

    nmoltype = r.i32()
    if nmoltype < 0 or nmoltype > 1_000_000:
        raise StructureError("corrupted tpr file: invalid molecule type count")
    moltypes = [_read_moltype(r, symtab, file_version) for _ in range(nmoltype)]

    nmolblock = r.i32()
    if nmolblock < 0 or nmolblock > 10_000_000:
        raise StructureError("corrupted tpr file: invalid molecule block count")
    molblocks = [_read_molblock(r, file_version) for _ in range(nmolblock)]

    total_natoms = r.i32()
    if total_natoms != natoms:
        raise StructureError(
            f"tpr topology is inconsistent ({total_natoms} vs {natoms} atoms) "
            f"— likely an unsupported tpx variant (version {file_version})"
        )

    # intermolecular interactions (tpx >= 103): flag + optional ilists
    b_intermolecular = r.boolean()
    if b_intermolecular:
        _read_ilists(r, file_version)

    # atomtypes section (present until tpx 128 / GROMACS 2023)
    if file_version < 128:
        nr_types = r.i32()
        if nr_types < 0 or nr_types > 10_000_000:
            raise StructureError("corrupted tpr file: invalid atomtypes block")
        if file_version < 113:
            # implicit-solvation era: radius, vol, surftens + gb params
            r.reals(nr_types)  # radius
            r.reals(nr_types)  # vol
            r.reals(nr_types)  # surftens
            r.ints(nr_types)   # atomnumber
            r.reals(nr_types)  # gb_radius
            r.reals(nr_types)  # S_hct
        else:
            r.ints(nr_types)   # atomnumber only

    # cmap grids: do_cmap (ngrid, grid_spacing, grids)
    ngrid = r.i32()
    grid_spacing = r.i32()
    if ngrid < 0 or ngrid > 1_000_000 or grid_spacing < 0:
        raise StructureError("corrupted tpr file: invalid cmap block")
    for _ in range(ngrid):
        r.reals(4 * grid_spacing * grid_spacing)

    # simulation groups: egcNR(=10) × (nr, name indices), ngrpname + symtab
    # indices, then per-category per-atom group numbers (uchar arrays)
    for _ in range(10):
        nr_g = r.i32()
        r.ints(nr_g)
    ngrpname = r.i32()
    for _ in range(ngrpname):
        r.i32()
    for _ in range(10):
        nr_g = r.i32()
        if nr_g != 0:
            r.uchar_vector(nr_g)

    # intermolecular exclusion group (tpxio.cpp do_mtop,
    # tpxv_StoreNonBondedInteractionExclusionGroup = 120): int64 count +
    # that many i32 atom indices, between the topology and the state
    if file_version >= 120:
        n_excl = r.i64()
        if n_excl < 0 or n_excl > natoms:
            raise StructureError(
                "corrupted tpr file: invalid intermolecular exclusion group")
        r.ints(n_excl)

    positions = velocities = None
    if b_x:
        positions = r.reals(natoms * 3).reshape(natoms, 3).copy()
    if b_v:
        velocities = r.reals(natoms * 3).reshape(natoms, 3).copy()

    return TprData(
        name=sysname,
        natoms=natoms,
        moltypes=moltypes,
        molblocks=molblocks,
        positions=positions,
        velocities=velocities,
        box=box,
        file_version=file_version,
        precision_double=r.double,
    )


# element names by atomic number (for TPR-provided atomic numbers)
_PERIODIC = {
    1: "hydrogen", 2: "helium", 3: "lithium", 4: "beryllium", 5: "boron",
    6: "carbon", 7: "nitrogen", 8: "oxygen", 9: "fluorine", 10: "neon",
    11: "sodium", 12: "magnesium", 13: "aluminium", 14: "silicon",
    15: "phosphorus", 16: "sulfur", 17: "chlorine", 18: "argon",
    19: "potassium", 20: "calcium", 25: "manganese", 26: "iron",
    29: "copper", 30: "zinc", 34: "selenium", 35: "bromine", 37: "rubidium",
    48: "cadmium", 53: "iodine", 55: "cesium", 56: "barium", 80: "mercury",
}


def read_tpr(path: str) -> System:
    """Read a TPR file → System with atoms, bonds, elements and coordinates."""
    tpr = read_tpr_data(path)

    names: List[str] = []
    resids: List[int] = []
    resnames: List[str] = []
    masses: List[float] = []
    elements: List[str] = []
    bond_pairs: List[Tuple[int, int]] = []

    atom_offset = 0
    residue_counter = 0
    for mt_idx, nmol in tpr.molblocks:
        mt = tpr.moltypes[mt_idx]
        n_at = len(mt.atom_names)
        n_res = len(mt.res_names)
        for _ in range(nmol):
            names.extend(mt.atom_names)
            masses.extend(mt.atom_masses)
            for ri in mt.res_index:
                resids.append(residue_counter + ri + 1)
                resnames.append(mt.res_names[ri])
            for num in mt.atom_numbers:
                elements.append(_PERIODIC.get(num, ""))
            for a, b in mt.bonds:
                bond_pairs.append((atom_offset + a, atom_offset + b))
            atom_offset += n_at
            residue_counter += n_res

    if atom_offset != tpr.natoms:
        raise StructureError(
            f"tpr molecule blocks are inconsistent with the atom count in "
            f"'{path}'"
        )

    system = System(
        name=tpr.name,
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.arange(1, tpr.natoms + 1, dtype=np.int64),
        positions=tpr.positions,
        velocities=tpr.velocities,
        box=tpr.box,
        masses=np.array(masses, np.float32),
    )
    if any(e for e in elements):
        system.elements = np.array(elements, dtype="U12")
    if bond_pairs:
        system.bonds = canonical_bonds(np.array(bond_pairs, np.int64))
    return system
