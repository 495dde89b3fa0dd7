"""Plain PyTorch reference of the benchmark's federated LM rounds; imports
nothing of the program under test."""
