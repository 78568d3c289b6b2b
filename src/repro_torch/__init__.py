"""StarPlat on PyTorch and CUDA — the port of the JAX package `repro`.

Same DSL, same frontend and analysis gate, two backends: `local` (plain
torch, the OpenMP analogue) and `cuda` (the paper's CUDA backend, with the
SSSP relax and the PageRank gather on the hand-written `ell_spmv` kernel).
Entry points run on the card unless the caller asks for the CPU.
"""
