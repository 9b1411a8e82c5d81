"""The plain reference the benchmark holds the program's outputs against.
It imports torch and numpy only: nothing of the program, nothing of JAX."""
