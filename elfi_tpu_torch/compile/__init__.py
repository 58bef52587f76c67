from .compiler import CompiledProgram, compile_program  # noqa: F401
