"""StarPlat DSL compiler on PyTorch — the port of `repro.core`.

Frontend: lexer → parser → AST → semantic analysis → IR (copies of the
reference's modules). Backends: local (plain torch, the OpenMP analogue),
cuda (the paper's CUDA backend, on the hand-written `ell_spmv` kernel) and
distributed (the paper's MPI backend on `torch.distributed`: `dist`
drives it, `runtime_dist` holds its collectives).
"""
from ..schedule import DEFAULT_SCHEDULE, Schedule
from .api import (BoundProgram, CompiledProgram, bind_cache_clear,
                  bind_cache_size, bundled_programs, compile_bundled,
                  compile_cache_clear, compile_cache_size, compile_program,
                  load_program_source)
from . import dist, runtime_dist
from .context import GraphContext, get_context, prepare

__all__ = ["BoundProgram", "CompiledProgram", "DEFAULT_SCHEDULE",
           "GraphContext", "Schedule", "bind_cache_clear", "bind_cache_size",
           "bundled_programs", "compile_bundled", "compile_cache_clear",
           "compile_cache_size", "compile_program", "dist", "get_context",
           "load_program_source", "prepare", "runtime_dist"]
