"""Plain references the benchmark holds the program to. They import nothing
of the program and nothing of the JAX package."""
