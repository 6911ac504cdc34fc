"""The benchmark of spherical_bundle_adjuster_tpu_torch on one NVIDIA H100.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the repository root. BENCHMARK.json at the root names the cells;
each cell's configuration (configs/), traffic mix (traffic/) and
per-layer metric readers (metrics/) are files of their own, found by
name. reference/ holds the plain PyTorch pipeline that decides
`correct`; scenes.py and generator.py make the inputs from the seed.
A mix is numbers for the one generator (pure rotations of synthetic
scenes, a closed loop with one caller): another pose draw or loop shape
needs a change to generator.py, which only a `benchmark` change makes.
"""
