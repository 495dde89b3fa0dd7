"""The harness of the benchmark: cells found by name, inputs made from the
seed, the program driven through its entry point, the trace read, the
comparison with the plain reference, and the one-line result."""
