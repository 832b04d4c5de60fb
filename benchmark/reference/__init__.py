"""The benchmark's plain reference: what an analysis must give, worked
out in float64 with plain PyTorch from the grid integers the benchmark
made (never from the XTC the program read), independent of the program:
it imports nothing of `gorder_tpu_torch`, `gorder_tpu` or JAX.

- `order`: the bond samples, their fixed-point sums and the results tree
  (`OrderReference`), and the `View` of the analysis a method reads;
- `select`: the selections the traffic uses (`resname`, `name`, regexes,
  `and`);
- `bonds`: bonds that are atom pairs (AA, CG): types, vectors, the tree;
- `normals`: dynamic membrane normals, exact integer clouds;
- `spherical`: spherical-clustering leaflets (a 1-D Gaussian mixture).

A cell's reference is found by name. `OrderReference` takes each tagged
value {"!": Tag, ...} of the traffic's `gorder` keys to the module
`<axis>/<tag in snake case>.py` here (`cells.reference_part`) and calls
its `build(spec, view)`:

- `kinds/` (`type`; `aa_order.py`, `cg_order.py`): the analyzed bonds,
  with `bond_type`, `bond_mol`, `n_types`, `molecules`, `vectors(ints)`
  → (F, N, 3) float64 nm, and `values(sums, counts, classes)` → the tree;
- `normals/` (a tagged `membrane_normal`; `dynamic.py`; a plain axis
  string is `order`'s own): `normals(ints)` → (F, M, 3) in the dtype;
- `leaflets/` (`leaflets`; `spherical_clustering.py`): `classes(ints)` →
  (F, M) int64, 0 upper, 1 lower.

`ints` are (F, A, 3) int32 grid integers, fed chunk by chunk in frame
order, so a method may carry state from one frame and chunk to the next;
M runs over `view.molecules`. A new method is one new file; a tag with
no file fails with NotImplementedError naming it.
"""
