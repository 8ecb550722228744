"""Plain references that decide ``correct``: plain PyTorch on the inputs
the harness made, importing nothing of the program under test."""
