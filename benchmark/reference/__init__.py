"""The plain reference: PyTorch only, imports nothing of the program.

It takes the benchmark's raw inputs (``gen.py``) and what the program
returned, and works out again, in float64 on the card in blocks of rows,
what those answers should satisfy; and a plain L-BFGS that the control
runs in the program's place at a lower precision.
"""
