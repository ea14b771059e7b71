"""The plain reference: PageRank, WCC and SSSP in plain PyTorch.

Written from the algorithms' definitions over the edge arrays the
benchmark made, on whatever device those arrays are.  It imports
nothing of the port: no plan, relabel, kernel or state of the program
reaches it.  Each function takes a ``dtype``: the reference runs in
float64 (int64 labels); the control runs the same code one precision
below what the configuration states (bfloat16 for float32, int16 for
int32 labels).
"""
