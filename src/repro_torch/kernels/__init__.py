"""Hand-written Hopper kernels for the port, one package per TPU kernel.

Each kernel package has:
  csrc/*.cu — the CUDA C++ kernel (sm_90a), built by `_build.py` on first use
  kernel.py — the wrapper: checks its inputs, launches the kernel for CUDA
              tensors (or raises) and runs the plain version for CPU tensors
  ops.py    — the graph- or model-level ops around the kernel
  ref.py    — the plain-torch version the tests and chip_smoke.py compare with

  ell_spmv        — SSSP relax / PR gather as block-ELL semiring SpMV/SpMM
                    (replaces repro/kernels/ell_spmv/kernel.py::ell_spmv)
  flash_attention — online-softmax attention for the LM prefill, bf16 on
                    wgmma fed by TMA (warp-specialised) and f32 on FMA
                    (replaces
                    repro/kernels/flash_attention/kernel.py::flash_attention)
  tc_matmul       — triangle count as a masked blocked L·L on int8 wgmma
                    over the lower-triangle tiles (replaces
                    repro/kernels/tc_matmul/kernel.py::tc_matmul)

`common/hopper.cuh` holds what the two tensor-core kernels share: tensor
maps, mbarriers, TMA loads, wgmma descriptors and forms, setmaxnreg.
"""
