"""The plain reference of the benchmark: imports nothing of the program."""
