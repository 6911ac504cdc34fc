"""The plain reference that decides `correct`: the two-view band pipeline
(band crops, SURF, one-way top-2 matching and the ratio test, the
consensus initial guess, the BCD refinement and corrected mode's gates,
joint Schur polish and starts) in plain PyTorch, float32, with no
hand-written kernel. It is a frozen copy of the plain versions in
spherical_bundle_adjuster_tpu_torch, taken when the benchmark was
defined, and imports nothing of that package: later changes to the
program are judged against it. compare.py holds the comparison.
"""
