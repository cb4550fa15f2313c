"""Plain references the benchmark judges the port's outputs against.

Plain NumPy and PyTorch, written from the mathematics: nothing here imports
the port or takes anything the port made.  Whatever the port derives from
the inputs (the coalition plan, the group-space products, the tree paths)
is worked out again here from the inputs the benchmark generated.
"""
