from .classify import (  # noqa: F401
    BondTypeKey,
    CompiledBonds,
    MoleculeKind,
    classify_molecules,
    compile_bonds,
)
