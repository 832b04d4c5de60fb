"""The benchmark's plain reference: what an analysis must give, worked
out in float64 with plain PyTorch from the grid integers the benchmark
made (never from the XTC the program read), independent of the program:
it imports nothing of `gorder_tpu_torch`, `gorder_tpu` or JAX.

- `select`: the selections the traffic uses (`resname`, `name`, regexes,
  `and`);
- `normals`: dynamic membrane normals, exact integer clouds;
- `spherical`: spherical-clustering leaflets (a 1-D Gaussian mixture);
- `order`: the bond samples, their fixed-point sums and the results tree.
"""
