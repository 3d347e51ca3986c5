"""Plain references the benchmark holds the program to."""
