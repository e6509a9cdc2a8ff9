"""The plain PyTorch reference the benchmark holds the program to; it imports nothing of the program."""
