"""StarPlat on PyTorch and CUDA — the port of the JAX package `repro`.

Same DSL, same frontend and analysis gate, two backends: `local` (plain
torch, the OpenMP analogue) and `cuda` (the paper's CUDA backend, with the
SSSP relax and the PageRank gather on the hand-written `ell_spmv` kernel).

Beside the DSL: the LM substrate's dense family (`models.build(cfg)`, e.g.
qwen2.5-3b, whose prefill `model({"tokens": ...}, impl="kernel")` runs the
hand-written `flash_attention` kernel, and `serve.ServeEngine` for greedy
generation over the decode path), and the dense triangle count
(`kernels.tc_matmul.ops.count_triangles_dense` on the `tc_matmul` kernel).
Entry points run on the card unless the caller asks for the CPU.
"""
